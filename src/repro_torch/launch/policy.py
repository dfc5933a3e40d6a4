"""Performance policy knobs (counterpart of ``repro/launch/policy.py``).

The fields that a ported path reads:

- ``attn_block_q/k``      : KV-block sizes of blockwise attention
- ``attn_p_bf16``         : bf16 exp-score tensor (m/l stay f32)
- ``attn_qk_bf16``        : q/k into the score product in their own dtype
  (f32 accumulation) instead of f32 q * scale
- ``logits_bf16``         : bf16 CE logits (f32 logsumexp)
- ``ce_chunk``            : CE sequence chunk
- ``param_tp_only``       : block weights get no "data" shard in the
  sharding rules, and the modeled gradient reduce charges every leaf the
  full allreduce instead of a 1/npes ZeRO shard for matrices
- ``overlap_grad_reduce`` : pipeline per-leaf gradient reduce against the
  step's per-leaf work; off = reduce everything, then update

and the fields that only the sharding rules read (``launch/sharding.py``;
the dry-run records them, and the model's ``shardctx.constrain`` calls
pass them the shapes, but nothing partitions a tensor):
``hidden_spec``, ``seq_parallel_hidden``, ``decode_replicate_small_cache``,
``small_cache_bytes``, ``fsdp_gather_weights`` and ``moe_expert_shard``,
with the reference's defaults.

``attn_repeat_kv`` and ``decode_onehot_update`` change what the model
computes under GSPMD, and ``attn_impl="flash"`` trains through the
forward-only flash kernel: :func:`parse_overrides` refuses them (ROADMAP
queue 1, item 14) and takes ``attn_impl=blockwise``, the reference's
default, as the one behaviour there is.
"""
from __future__ import annotations

import contextlib
import dataclasses

# the reference's fields that change the model's compute under GSPMD, or
# train through the forward-only flash kernel (ROADMAP queue 1, item 14)
_NOT_PORTED = ("attn_repeat_kv", "decode_onehot_update")


@dataclasses.dataclass(frozen=True)
class PerfPolicy:
    attn_block_q: int = 512
    attn_block_k: int = 512
    attn_p_bf16: bool = False
    attn_qk_bf16: bool = False
    logits_bf16: bool = False
    ce_chunk: int = 512
    fsdp_gather_weights: bool = False
    param_tp_only: bool = False
    hidden_spec: str = "replicated"     # "replicated", "dshard" or "off"
    seq_parallel_hidden: bool = False
    moe_expert_shard: bool = False
    decode_replicate_small_cache: bool = False
    small_cache_bytes: int = 1 << 30
    overlap_grad_reduce: bool = True


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
        if k == "attn_impl" and v == "blockwise":
            continue                   # the only attention that trains
        if k in _NOT_PORTED or k == "attn_impl":
            raise ValueError(f"policy field {k!r} changes the model's "
                             "compute under GSPMD or trains through the "
                             "forward-only flash kernel and is not ported "
                             "(ROADMAP queue 1, item 14)")
        field = PerfPolicy.__dataclass_fields__[k]
        if field.type in ("bool", bool):
            kw[k] = v.lower() in ("1", "true", "yes")
        elif field.type in ("str", str):
            kw[k] = v
        else:
            kw[k] = int(v)
    return PerfPolicy(**kw)
