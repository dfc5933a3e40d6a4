"""The frozen yardstick: peaks, per-kernel work formulas and the model FLOP
count that the per-layer metrics divide by.

These are copies, not imports.  The program may change its own roofline
code; a reading here must not move with it.  Each copy names the port
function it was taken from, as of commit 3a70f0e (``src/repro_torch``).
"""
from __future__ import annotations

# ---------------------------------------------------------------------------
# H100 SXM peaks (data sheet, dense, at a 700 W power limit); copied from
# roofline/analysis.py::PEAK_FLOPS and HBM_BW.  A run prints the card's
# power.limit beside every share it reports.
# ---------------------------------------------------------------------------
PEAK_BF16_FLOPS = 989e12        # FLOP/s
HBM_BYTES_PER_S = 3.35e12       # B/s


def bound_s(work: dict) -> float:
    """The least time the card could take for ``work``: the larger of its
    operations over the bf16 peak and its bytes over HBM bandwidth."""
    return max(work.get("flops", 0) / PEAK_BF16_FLOPS,
               work.get("bytes", 0) / HBM_BYTES_PER_S)


# ---------------------------------------------------------------------------
# kernel work, from the shapes of one call
# ---------------------------------------------------------------------------

def flash_work(B: int, S: int, H: int, Hkv: int, hd: int,
               itemsize: int) -> dict:
    """K2 (causal flash attention), copied from
    roofline/counter.py::flash_work: QK^T and PV over the B*H*S(S+1)/2
    visible pairs; q, k, v read once and o written once."""
    pairs = B * H * S * (S + 1) // 2
    return {"flops": 4 * hd * pairs,
            "bytes": itemsize * (2 * B * S * H * hd + 2 * B * S * Hkv * hd)}


def gather_work(entries: int, mapped: int, row_bytes: int) -> dict:
    """K3 (paged gather).  From roofline/counter.py::gather_work, which
    charges a read for every table entry; an unmapped entry reads nothing
    on the card (it writes a row of zeros), so only ``mapped`` rows are
    charged a read here.  The int32 table is read once and every output
    row written once."""
    return {"bytes": 4 * entries + entries * row_bytes + mapped * row_bytes}


def reduce_scatter_work(P: int, numel: int, itemsize: int) -> dict:
    """K6 (ring reduce-scatter) of a (P, ...) stack, copied from
    roofline/counter.py::reduce_scatter_work: the stack read once, one
    PE's share written once, P - 1 adds an output element."""
    total = numel * itemsize
    return {"bytes": total + total // P, "flops": (P - 1) * (numel // P)}


# ---------------------------------------------------------------------------
# model FLOPs (for mfu): 2 x the matmul parameters a token passes through,
# plus attention over its context; training is 3x the forward
# ---------------------------------------------------------------------------

def _attn_params(a: dict) -> int:
    d, nq, nkv, hd = a["d_model"], a["num_heads"], a["num_kv_heads"], \
        a["head_dim"] or a["d_model"] // a["num_heads"]
    return d * nq * hd + 2 * d * nkv * hd + nq * hd * d


def _mlp_params(a: dict) -> int:
    mult = 3 if a["mlp_type"] == "swiglu" else 2
    return mult * a["d_model"] * a["d_ff"] if a["d_ff"] else 0


def _attention_layers(a: dict) -> int:
    """The decoder's layers, all attention blocks, for the one family the
    benchmark runs (configs/base.py::layer_kinds for "dense")."""
    if a["family"] != "dense":
        raise ValueError(f"no FLOP count for family {a['family']!r}")
    return a["num_layers"]


def flop_parts(a: dict) -> tuple:
    """(body, per_context, head): the forward FLOPs of one token through
    the layers' matmul parameters, the attention FLOPs per position of its
    context (QK^T and PV over every layer), and the LM head's."""
    hd = a["head_dim"] or a["d_model"] // a["num_heads"]
    n = _attention_layers(a)
    body = n * 2.0 * (_attn_params(a) + _mlp_params(a))
    per_ctx = n * 4.0 * a["num_heads"] * hd
    return body, per_ctx, 2.0 * a["d_model"] * a["vocab_size"]


def prefill_flops(a: dict, S: int) -> float:
    """A prompt of S tokens: position t attends over t + 1 positions; the
    head runs at the last position only (the program computes one row of
    logits)."""
    body, per_ctx, head = flop_parts(a)
    return S * body + per_ctx * S * (S + 1) / 2 + head


def decode_flops(a: dict, context: int) -> float:
    """One decoded token whose attention reads ``context`` positions."""
    body, per_ctx, head = flop_parts(a)
    return body + per_ctx * context + head


def train_flops(a: dict, S: int, B: int) -> float:
    """One training step of B sequences of S tokens: 3x the forward, the
    head at every position."""
    body, per_ctx, head = flop_parts(a)
    return 3.0 * B * (S * (body + head) + per_ctx * S * (S + 1) / 2)
