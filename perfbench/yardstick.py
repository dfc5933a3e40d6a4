"""The frozen yardstick: peaks, per-kernel work formulas and the model FLOP
count that the per-layer metrics divide by.

These are copies, not imports.  The program may change its own roofline
code; a reading here must not move with it.  Each copy names the port
function it was taken from, as of commit 3a70f0e (``src/repro_torch``).

The model FLOP count is a sum over the decoder layers that the
configuration file states (``"layers"``, run-length: ``[["attn", 36]]``),
each layer counted by the formulas of its kind in
``perfbench/work/<kind>.py``.  A configuration of another family adds its
file with its ``layers``, and a formula file for each kind that has none
yet; nothing here changes.
"""
from __future__ import annotations

from perfbench import work

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
# model FLOPs (for mfu): a sum over the configuration's decoder layers, each
# counted by its kind's formulas in perfbench/work/<kind>.py (the matmul
# parameters a token passes through, and its attention over the visible
# context); plus the LM head; training is 3x the forward
# ---------------------------------------------------------------------------

def flop_parts(a: dict, layers=None) -> tuple:
    """(body, per_ctx, head): the forward FLOPs of one token through the
    layers, the FLOPs per visible position of its context summed over the
    layers, and the LM head's.  ``layers``: [[kind, count], ...] as the
    configuration file states them; where none are given, ``num_layers``
    attention blocks of the dense family."""
    if layers is None:
        if a["family"] != "dense":
            raise ValueError(f"a configuration of family {a['family']!r} "
                             f"states its decoder layers (\"layers\")")
        layers = [("attn", a["num_layers"])]
    body = per_ctx = 0.0
    for kind, n in layers:
        f = work.formula(kind)
        body += n * f.token_flops(a)
        per_ctx += n * f.context_flops(a)
    return body, per_ctx, 2.0 * a["d_model"] * a["vocab_size"]


def _window(a: dict):
    """The positions a query sees at most: ``window`` under sliding-window
    attention, else no limit."""
    return a["window"] if a.get("attention") == "swa" else None


def visible(a: dict, context: int) -> int:
    """The positions one query at ``context`` positions attends over."""
    W = _window(a)
    return context if W is None else min(context, W)


def visible_prefix_sum(a: dict, S: int):
    """Sum of ``visible(a, t)`` over t = 1..S: the (query, position)
    pairs of a causal prompt of S tokens."""
    W = _window(a)
    if W is None or S <= W:
        return S * (S + 1) / 2
    return W * (W + 1) / 2 + (S - W) * W


def prefill_flops(a: dict, S: int, layers=None) -> float:
    """A prompt of S tokens: position t attends over its visible positions
    of the first t + 1; the head runs at the last position only (the
    program computes one row of logits)."""
    body, per_ctx, head = flop_parts(a, layers)
    return S * body + per_ctx * visible_prefix_sum(a, S) + head


def decode_flops(a: dict, context: int, layers=None) -> float:
    """One decoded token whose attention reads the visible positions of
    ``context``."""
    body, per_ctx, head = flop_parts(a, layers)
    return body + per_ctx * visible(a, context) + head


def train_flops(a: dict, S: int, B: int, layers=None) -> float:
    """One training step of B sequences of S tokens: 3x the forward, the
    head at every position."""
    body, per_ctx, head = flop_parts(a, layers)
    return 3.0 * B * (S * (body + head) + per_ctx * visible_prefix_sum(a, S))
