"""Work counter for a step run in PyTorch (counterpart of
``repro/roofline/hlo_parser.py``).

The reference walks the optimized HLO text of a compiled step.  The port
emits no HLO, so :func:`count` watches the step run instead, under a
``TorchDispatchMode``, on real tensors or on ``meta`` ones (the dry-run),
and charges:

- ``flops``            : matmul products by ``torch.utils.flop_counter``'s
                         formulas (2·M·N·K, the parser's convention);
- ``bytes``            : every materialising aten op reads its tensor
                         operands once and writes its outputs once; views
                         and allocations that write nothing cost nothing;
- ``transcendental``   : elements through exp, log, tanh, sigmoid, erf,
                         rsqrt, sin and cos (and the ops built on them:
                         softmax, logsumexp, silu, gelu);
- ``collective_bytes`` : only from the collective kernels' charges (K4-K8),
                         by the reference's ring formulas
                         (:func:`_wire_bytes`), summed over the PEs.

A kernel wrapper charges its own work with :func:`charge`, one formula per
kernel from the function's shapes (the ``*_work`` functions below), the
same on every route: its plain version on the CPU, its empty outputs on
``meta``, its launch on the card.  While a wrapper charges, the aten ops it
issues are not counted, so a kernel costs the same whatever implements it.
The counter also tracks the bytes of the tensors the step allocates that
are still alive (``peak_bytes``), the source of the dry-run's temp size.
"""
from __future__ import annotations

import contextlib
import re
import weakref
from collections import defaultdict

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

# ---------------------------------------------------------------------------
# the reference's byte and wire formulas (repro/roofline/hlo_parser.py)
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def shape_bytes(type_str: str) -> int:
    """Bytes of an HLO type string (tuples summed)."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _wire_bytes(opcode: str, size: int, n: int) -> float:
    if n <= 1:
        return 0.0
    if opcode.startswith("all-reduce"):
        return 2.0 * size * (n - 1) / n
    if opcode.startswith(("all-gather", "reduce-scatter", "all-to-all",
                          "ragged-all-to-all")):
        return size * (n - 1) / n
    return float(size)   # collective-permute / broadcast


# ---------------------------------------------------------------------------
# one formula per kernel: the work a wrapper charges, from shapes alone
# ---------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def copy_work(n: int, itemsize: int) -> dict:
    """K1: n elements read and n written."""
    return {"bytes": 2 * n * itemsize}


def flash_work(B: int, S: int, H: int, Hkv: int, hd: int,
               itemsize: int) -> dict:
    """K2: the causal QK^T and PV products over ``B·H·S(S+1)/2`` visible
    (query, key) pairs, one exp each; q, k, v read once, o written once."""
    pairs = B * H * S * (S + 1) // 2
    return {"flops": 4 * hd * pairs,
            "bytes": itemsize * (2 * B * S * H * hd + 2 * B * S * Hkv * hd),
            "transcendental": pairs}


def gather_work(entries: int, row_bytes: int) -> dict:
    """K3: the int32 table read, and one row read and written per entry
    (an unmapped entry reads nothing on the card, which a shape cannot
    tell: every entry is charged)."""
    return {"bytes": 4 * entries + 2 * entries * row_bytes}


def paged_attn_work(B: int, W: int, nq: int, nkv: int, hd: int,
                    itemsize: int) -> dict:
    """K11: K2's products over the assembled width W; q read and o
    written, and one layer's K and V of ``B·W`` tokens read."""
    pairs = B * nq * W * (W + 1) // 2
    return {"flops": 4 * hd * pairs,
            "bytes": itemsize * (2 * B * W * nq * hd + 2 * B * W * nkv * hd),
            "transcendental": pairs}


def decode_attn_work(B: int, W: int, nq: int, nkv: int, hd: int,
                     itemsize: int, *, stores: bool = False) -> dict:
    """Decode attention: one query a row over the cache's W positions (a
    shape cannot tell the live length, which lies on the device, so every
    position is charged, as the reference's masked full-width decode
    counts), one exp a pair; q read and o written, K and V of ``B·W``
    tokens read, and with ``stores`` the new column read and written."""
    pairs = B * nq * W
    column = 4 * B * nkv * hd if stores else 0
    return {"flops": 4 * hd * pairs,
            "bytes": itemsize * (2 * B * nq * hd + 2 * B * W * nkv * hd
                                 + column),
            "transcendental": pairs}


def visible_pairs(Sq: int, Skv: int, q_off: int, k_off: int) -> int:
    """(query, key) pairs with key position <= query position."""
    total = 0
    for i in range(Sq):
        total += min(max(q_off + i - k_off + 1, 0), Skv)
    return total


def partial_work(B: int, Sq: int, Skv: int, H: int, hd: int, itemsize: int,
                 q_off: int, k_off: int) -> dict:
    """K10: the unmasked QK^T and PV products at the offsets, one exp a
    pair; q, k, v read, the f32 acc, m and l written."""
    pairs = B * H * visible_pairs(Sq, Skv, q_off, k_off)
    return {"flops": 4 * hd * pairs,
            "bytes": itemsize * B * H * hd * (Sq + 2 * Skv)
            + 4 * (B * Sq * H * hd + 2 * B * Sq * H),
            "transcendental": pairs}


def split_work(B: int, Sq: int, Skv: int, H: int, hd: int,
               itemsize: int) -> dict:
    """K10's split pass: q, k, v read; the f32 hi/lo planes written."""
    skv8 = -(-Skv // 8) * 8
    return {"bytes": itemsize * B * H * hd * (Sq + 2 * Skv)
            + 4 * 2 * B * H * hd * (Sq + Skv + skv8)}


def _collective(kind: str, size: int, P: int) -> tuple:
    """(kind, wire bytes summed over the P PEs), ``size`` being one PE's
    operand as the reference's parser reads it."""
    return kind, P * _wire_bytes(kind, size, P)


def put_work(x: torch.Tensor) -> dict:
    """K4: every PE's row read and written once; a permute of one row."""
    P = x.shape[0]
    return {"bytes": 2 * _nbytes(x),
            "collective": _collective("collective-permute", _nbytes(x) // P,
                                      P)}


def allgather_work(x: torch.Tensor) -> dict:
    """K5: x read once, the (P, P, ...) output written once."""
    P = x.shape[0]
    return {"bytes": (P + 1) * _nbytes(x),
            "collective": _collective("all-gather", _nbytes(x), P)}


def reduce_scatter_work(x: torch.Tensor) -> dict:
    """K6: x read once, the (P, ...) output written once, P - 1 adds per
    output element."""
    P = x.shape[0]
    out = _nbytes(x) // P
    return {"bytes": _nbytes(x) + out,
            "flops": (P - 1) * (x.numel() // P),
            "collective": _collective("reduce-scatter", out, P)}


def broadcast_work(x: torch.Tensor) -> dict:
    """K7: the root's row read once, every PE's row written."""
    P = x.shape[0]
    row = _nbytes(x) // P
    return {"bytes": row + _nbytes(x),
            "collective": _collective("broadcast", row, P)}


def barrier_work(npes: int) -> dict:
    """K8: one collective site that moves no payload; the (npes,) int32
    result written."""
    return {"bytes": 4 * npes, "collective": ("barrier", 0.0)}


def reduce_tile_work(T: int, N: int, itemsize: int) -> dict:
    """K9: T rows read, one row written, T - 1 ops per column."""
    return {"bytes": (T + 1) * N * itemsize, "flops": (T - 1) * N}


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

aten = torch.ops.aten

# allocations, which write nothing, and ops that return their input's
# storage under another name
_ALLOC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
          aten.new_empty_strided}
_ALIAS = {aten._unsafe_view, aten.lift_fresh, aten.detach, aten.alias}

# transcendentals per output element (logsumexp: per input element)
_TRANSCENDENTAL = {
    aten.exp: 1, aten.exp_: 1, aten.expm1: 1, aten.exp2: 1, aten.log: 1,
    aten.log_: 1, aten.log1p: 1, aten.log2: 1, aten.tanh: 1, aten.tanh_: 1,
    aten.sigmoid: 1, aten.sigmoid_: 1, aten.erf: 1, aten.rsqrt: 1,
    aten.rsqrt_: 1, aten.sin: 1, aten.cos: 1, aten._softmax: 1,
    aten._log_softmax: 1, aten.silu: 1, aten.gelu: 1,
}
_PER_INPUT = {aten.logsumexp}


def _tensors(tree):
    out, seen = [], set()
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, dict):
            stack.extend(t.values())
    return out


class Counts:
    """What one :func:`count` block saw."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.transcendental = 0
        self.collectives = []            # (kind, wire bytes)
        self.by_kernel = {}
        self.live = 0
        self.peak_bytes = 0
        self.n_ops = 0

    def _alloc(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        if not n:
            return
        self.live += n
        if self.live > self.peak_bytes:
            self.peak_bytes = self.live
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def add_op(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        outs = _tensors(out)
        mutable = func._schema.is_mutable
        if not outs and not mutable:       # a scalar read, a stream record
            return
        self.n_ops += 1
        formula = flop_counter.flop_registry.get(packet)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if packet in _TRANSCENDENTAL:
            self.transcendental += _TRANSCENDENTAL[packet] * sum(
                t.numel() for t in outs)
        elif packet in _PER_INPUT:
            self.transcendental += args[0].numel()
        if func.is_view or packet in _ALIAS or packet in _ALLOC:
            return
        ins = _tensors((args, kwargs))
        self.bytes += sum(_nbytes(t) for t in ins)
        # an in-place op writes the operand it returns
        self.bytes += sum(_nbytes(t) for t in outs
                          if mutable or not any(t is i for i in ins))

    def track(self, func, out) -> None:
        """Count the step's new allocations toward the live bytes."""
        if func.is_view or func._schema.is_mutable or \
                func.overloadpacket in _ALIAS:
            return
        for t in _tensors(out):
            self._alloc(t)

    def add_charge(self, name: str, work: dict) -> None:
        rec = self.by_kernel.setdefault(name, {
            "calls": 0, "flops": 0, "bytes": 0, "transcendental": 0,
            "collective_bytes": 0.0})
        rec["calls"] += 1
        for key in ("flops", "bytes", "transcendental"):
            v = int(work.get(key, 0))
            rec[key] += v
            setattr(self, key, getattr(self, key) + v)
        if "collective" in work:
            kind, wire = work["collective"]
            self.collectives.append((kind, float(wire)))
            rec["collective_bytes"] += float(wire)

    def summary(self) -> dict:
        """``HloAnalysis.summary()``'s keys, plus the kernels' charges and
        the peak of the live bytes."""
        per_kind = defaultdict(float)
        for kind, wire in self.collectives:
            per_kind[kind] += wire
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "transcendental": self.transcendental,
            "collective_bytes": sum(w for _, w in self.collectives),
            "collective_by_kind": dict(per_kind),
            "n_collective_sites": len(self.collectives),
            "by_kernel": {k: dict(v) for k, v in self.by_kernel.items()},
            "peak_bytes": self.peak_bytes,
        }


_ACTIVE: list = []            # the Counts of every open count() block
_QUIET = [0]                  # > 0 while a wrapper charges


class _Mode(TorchDispatchMode):
    def __init__(self, counts: Counts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _QUIET[0]:
            self.counts.add_op(func, args, kwargs, out)
        self.counts.track(func, out)
        return out


@contextlib.contextmanager
def count():
    """Count the work of the block; yields its :class:`Counts`."""
    counts = Counts()
    _ACTIVE.append(counts)
    try:
        with _Mode(counts):
            yield counts
    finally:
        _ACTIVE.remove(counts)


class _Charge:
    __slots__ = ("name", "work")

    def __init__(self, name, work):
        self.name, self.work = name, work

    def __enter__(self):
        if not _QUIET[0]:                # a kernel inside a kernel: the
            for counts in _ACTIVE:       # outer one's formula covers it
                counts.add_charge(self.name, self.work)
        _QUIET[0] += 1
        return self

    def __exit__(self, *exc):
        _QUIET[0] -= 1
        return False


_NO_CHARGE = contextlib.nullcontext()


def charge(name: str, work):
    """Context for a kernel wrapper's body: charges ``work()`` (a dict of
    ``flops``, ``bytes``, ``transcendental`` and ``collective``) to every
    open counter under ``name`` and leaves the body's aten ops uncounted.
    With no counter open it does nothing and ``work`` is not called."""
    if not _ACTIVE:
        return _NO_CHARGE
    return _Charge(name, work())
