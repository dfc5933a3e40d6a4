"""Performance policy knobs (counterpart of ``repro/launch/policy.py``).

Only the fields that a ported path reads are kept:

- ``attn_block_q/k``      : KV-block sizes of blockwise attention
- ``attn_p_bf16``         : bf16 exp-score tensor (m/l stay f32)
- ``attn_qk_bf16``        : q/k into the score product in their own dtype
  (f32 accumulation) instead of f32 q * scale
- ``logits_bf16``         : bf16 CE logits (f32 logsumexp)
- ``ce_chunk``            : CE sequence chunk
- ``param_tp_only``       : the modeled gradient reduce charges every leaf
  the full allreduce instead of a 1/npes ZeRO shard for matrices
- ``overlap_grad_reduce`` : pipeline per-leaf gradient reduce against the
  step's per-leaf work; off = reduce everything, then update

The reference's GSPMD fields (weight gathers, hidden and MoE sharding
constraints, decode cache layouts) and ``attn_impl="flash"`` (no backward
in either package) have no counterpart: :func:`parse_overrides` refuses
them, naming ROADMAP queue 1, item 13, and takes ``attn_impl=blockwise``,
the reference's default, as the one behaviour there is.
"""
from __future__ import annotations

import contextlib
import dataclasses

# the reference's fields that act only through GSPMD sharding (ROADMAP
# queue 1, item 13) or through the forward-only flash kernel
_NOT_PORTED = ("fsdp_gather_weights", "attn_repeat_kv",
               "hidden_spec", "seq_parallel_hidden", "moe_expert_shard",
               "decode_onehot_update", "decode_replicate_small_cache",
               "small_cache_bytes")


@dataclasses.dataclass(frozen=True)
class PerfPolicy:
    attn_block_q: int = 512
    attn_block_k: int = 512
    attn_p_bf16: bool = False
    attn_qk_bf16: bool = False
    logits_bf16: bool = False
    ce_chunk: int = 512
    param_tp_only: bool = False
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
            raise ValueError(f"policy field {k!r} acts through GSPMD sharding "
                             "or the forward-only flash kernel and is not "
                             "ported (ROADMAP queue 1, item 13)")
        field = PerfPolicy.__dataclass_fields__[k]
        if field.type in ("bool", bool):
            kw[k] = v.lower() in ("1", "true", "yes")
        else:
            kw[k] = int(v)
    return PerfPolicy(**kw)
