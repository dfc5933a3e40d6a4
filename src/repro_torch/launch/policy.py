"""Performance policy knobs (counterpart of ``repro/launch/policy.py``).

The fields that a ported path reads:

- ``attn_impl``           : "blockwise" (the default) or "flash".  Prefill
  attention without a window goes through K2 under either (see
  ``models/model.py``); under "flash" training's forward does too, and a
  gradient through it raises, as K2 has no backward
- ``attn_block_q/k``      : KV-block sizes of blockwise attention
- ``attn_p_bf16``         : bf16 exp-score tensor (m/l stay f32)
- ``attn_qk_bf16``        : q/k into the score product in their own dtype
  (f32 accumulation) instead of f32 q * scale
- ``logits_bf16``         : bf16 CE logits (f32 logsumexp)
- ``ce_chunk``            : CE sequence chunk
- ``param_tp_only``       : block weights get no "data" shard in the
  sharding rules, and the modeled gradient reduce charges every leaf the
  full allreduce instead of a 1/npes ZeRO shard for matrices
- ``attn_repeat_kv``      : K/V heads repeated ``q_per_kv`` times before
  attention (the cache keeps them unrepeated), so K2 runs as MHA; the
  decode kernel shares the unrepeated heads itself
- ``decode_onehot_update``: the decode's cache write as a one-hot select,
  which is how the port's decode always writes it
- ``overlap_grad_reduce`` : pipeline per-leaf gradient reduce against the
  step's per-leaf work; off = reduce everything, then update

and the fields that only the sharding rules read (``launch/sharding.py``;
the dry-run records them, and the model's ``shardctx.constrain`` calls
pass them the shapes, but nothing partitions a tensor):
``hidden_spec``, ``seq_parallel_hidden``, ``decode_replicate_small_cache``,
``small_cache_bytes``, ``fsdp_gather_weights`` and ``moe_expert_shard``.
Every field has the reference's default, in the reference's order.
"""
from __future__ import annotations

import contextlib
import dataclasses

ATTN_IMPLS = ("blockwise", "flash")


@dataclasses.dataclass(frozen=True)
class PerfPolicy:
    attn_impl: str = "blockwise"
    attn_block_q: int = 512
    attn_block_k: int = 512
    attn_p_bf16: bool = False
    attn_qk_bf16: bool = False
    logits_bf16: bool = False
    ce_chunk: int = 512
    fsdp_gather_weights: bool = False
    param_tp_only: bool = False
    attn_repeat_kv: bool = False
    hidden_spec: str = "replicated"     # "replicated", "dshard" or "off"
    seq_parallel_hidden: bool = False
    moe_expert_shard: bool = False
    decode_onehot_update: bool = False
    decode_replicate_small_cache: bool = False
    small_cache_bytes: int = 1 << 30
    overlap_grad_reduce: bool = True

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={self.attn_impl!r}: takes one of "
                             f"{ATTN_IMPLS}")


_CURRENT = PerfPolicy()


def get() -> PerfPolicy:
    return _CURRENT


@contextlib.contextmanager
def use(policy: PerfPolicy):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = policy
    try:
        yield
    finally:
        _CURRENT = prev


def parse_overrides(pairs) -> PerfPolicy:
    """['attn_p_bf16=1', 'attn_block_k=1024', ...] -> PerfPolicy."""
    kw = {}
    for pair in pairs or []:
        k, v = pair.split("=", 1)
        field = PerfPolicy.__dataclass_fields__[k]
        if field.type in ("bool", bool):
            kw[k] = v.lower() in ("1", "true", "yes")
        elif field.type in ("str", str):
            kw[k] = v
        else:
            kw[k] = int(v)
    return PerfPolicy(**kw)
