"""K5-K8 — device-initiated ring collectives (``csrc/ring_collectives.cu``).

Replaces ``repro/kernels/ring_collectives.py``: ``ring_allgather`` (K5),
``ring_reduce_scatter`` (K6), ``push_broadcast`` (K7) and ``barrier_push``
(K8).  The reference calls each once per PE inside ``shard_map``; the port
takes PE-stacked tensors instead: the leading axis is the PE axis, and
``out[p]`` is what PE p's call returns in the reference.  On the card K8
(and K4, in ``rma_copy``) push as the reference does: every PE a group of
CTAs in one cooperative launch, with flag words in place of DMA
semaphores (K8's kept across calls, so a barrier is that launch alone).  K5, K6 and K7 pull from the PEs' rows in one ordinary launch
with no flags: K5 and K7 share one fan-out body (each source row loaded
once and stored to every PE's slot; K5's sources are all the rows, K7's
the root's alone), K6 folds each chunk's addends in the ring's order (see
the source for the designs).  Each kernel has a plain PyTorch version that
follows the reference's order; a wrapper takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch import _devices
from repro_torch.kernels import ops
from repro_torch.roofline import counter

DTYPES = (torch.float32, torch.bfloat16, torch.int32)
REDUCE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the C dtype code
# K4's cooperative launch runs at most this many CTAs (npes x CTAs per PE);
# the flag buffer holds one word per CTA
MAX_CTAS = 2048


def check_stacked(name: str, x: torch.Tensor, dtypes, min_dim: int = 1):
    """Raise unless ``x`` is a contiguous PE-stacked tensor of a taken
    dtype with at least ``min_dim`` axes and a nonempty PE axis."""
    if x.dim() < min_dim or x.shape[0] < 1:
        raise ValueError(f"{name}: needs an (npes, ...) tensor with at least "
                         f"{min_dim} axes, got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: {x.dtype}; takes one of {tuple(dtypes)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")


def flags_for(x: torch.Tensor) -> torch.Tensor:
    """Scratch flag words for one cooperative launch of K4 over ``x``
    (zeroed by the C entry point on the stream); the pull kernels (K5-K7)
    take none."""
    return torch.empty(MAX_CTAS, dtype=torch.int32, device=x.device)


# ---------------------------------------------------------------------------
# K5: ring all-gather (fcollect)
# ---------------------------------------------------------------------------


def ring_allgather_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K5, in the reference's schedule: each PE places its
    own chunk, then in step s forwards slot ``(p - s) mod P`` to its right
    neighbour."""
    P = x.shape[0]
    out = x.new_empty((P, P) + tuple(x.shape[1:]))
    for p in range(P):
        out[p, p] = x[p]
    for s in range(P - 1):
        for p in range(P):
            slot = (p - s) % P
            out[(p + 1) % P, slot] = out[p, slot]
    return out


def ring_allgather(x: torch.Tensor) -> torch.Tensor:
    """fcollect: ``x`` ``(npes, chunk...)`` -> ``(npes, npes, chunk...)``,
    where ``out[p][q] = x[q]`` for every PE p."""
    check_stacked("ring_allgather", x, DTYPES)
    with counter.charge("ring_allgather",
                        lambda: counter.allgather_work(x)):
        where = ops.route(x)
        if where == "cpu":
            return ring_allgather_plain(x)
        P = x.shape[0]
        out = torch.empty((P, P) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        if where == "cuda":
            ops.launch("ring_allgather", "ishmem_ring_allgather",
                       x.get_device(), out.data_ptr(), x.data_ptr(), P,
                       x.numel() // P * x.element_size())
        return out


# ---------------------------------------------------------------------------
# K6: ring reduce-scatter
# ---------------------------------------------------------------------------


def ring_reduce_scatter_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K6, in the reference's order and in x's dtype:
    ``acc = x[p][(p-1) mod P]``; step s: ``acc = left's acc + x[p][(p-2-s)
    mod P]``.  So chunk c is folded as ``(...(x[c+1][c] + x[c+2][c]) +
    ...) + x[c][c]`` (indices mod P), the order the kernel pulls in."""
    P = x.shape[0]
    acc = [x[p, (p - 1) % P].clone() for p in range(P)]
    for s in range(P - 1):
        acc = [acc[(p - 1) % P] + x[p, (p - 2 - s) % P] for p in range(P)]
    return torch.stack(acc)


def ring_reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """``x``: ``(npes, npes, chunk...)`` addends per PE -> ``(npes,
    chunk...)``: PE i holds the sum over PEs of chunk i."""
    check_stacked("ring_reduce_scatter", x, REDUCE_DTYPES, min_dim=2)
    P = x.shape[0]
    if x.shape[1] != P:
        raise ValueError(f"ring_reduce_scatter: x must be (npes, npes, ...), "
                         f"got {tuple(x.shape)}")
    with counter.charge("ring_reduce_scatter",
                        lambda: counter.reduce_scatter_work(x)):
        where = ops.route(x)
        if where == "cpu":
            return ring_reduce_scatter_plain(x)
        out = torch.empty((P,) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        if where == "cuda":
            ops.launch("ring_reduce_scatter", "ishmem_ring_reduce_scatter",
                       x.get_device(), out.data_ptr(), x.data_ptr(), P,
                       x.numel() // (P * P), REDUCE_DTYPES[x.dtype])
        return out


# ---------------------------------------------------------------------------
# K7: push broadcast
# ---------------------------------------------------------------------------


def push_broadcast_plain(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """Plain version of K7: the root copies its own row, then pushes it to
    ``root+1+i`` in order."""
    P = x.shape[0]
    out = torch.empty_like(x)
    out[root] = x[root]
    for i in range(P - 1):
        out[(root + 1 + i) % P] = x[root]
    return out


def push_broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    """``x`` ``(npes, n...)`` -> every PE's row set to ``x[root]``."""
    check_stacked("push_broadcast", x, DTYPES)
    P = x.shape[0]
    if not 0 <= root < P:
        raise ValueError(f"push_broadcast: root {root} outside {P} PEs")
    with counter.charge("push_broadcast",
                        lambda: counter.broadcast_work(x)):
        where = ops.route(x)
        if where == "cpu":
            return push_broadcast_plain(x, root)
        out = torch.empty_like(x)
        if where == "cuda":
            ops.launch("push_broadcast", "ishmem_push_broadcast",
                       x.get_device(), out.data_ptr(), x.data_ptr(), P,
                       x.numel() // P * x.element_size(), root)
        return out


# ---------------------------------------------------------------------------
# K8: push barrier
# ---------------------------------------------------------------------------


def barrier_push_plain(npes: int, device) -> torch.Tensor:
    """Plain version of K8: every PE adds 1 to every other PE's counter;
    a PE passes when its own counter reaches npes - 1."""
    counters = [0] * npes
    for p in range(npes):
        for i in range(npes - 1):
            counters[(p + 1 + i) % npes] += 1
    return torch.tensor([int(c == npes - 1) for c in counters],
                        dtype=torch.int32, device=device)


# K8's counters per (device, stream handle): [counters, npes, epoch].  Kept
# across calls, so a barrier is one cooperative launch with no memset: the
# kernel waits for its epoch's count (see csrc/ring_collectives.cu).
_BARRIERS: dict = {}


def barrier_push(npes: int, *, device=None) -> torch.Tensor:
    """Push barrier over ``npes`` PEs on ``device`` (the current CUDA
    device unless given); returns ``(npes,)`` int32 ones once every PE has
    arrived.  On the card the counters live on in ``_BARRIERS`` for the
    device and its current stream; a call with another ``npes`` than the
    last one there zeroes them once, on the stream."""
    if npes < 1:
        raise ValueError(f"barrier_push: npes must be >= 1, got {npes}")
    dev = _devices.resolve(device)
    with counter.charge("barrier_push", lambda: counter.barrier_work(npes)):
        if dev.type == "cpu":
            return barrier_push_plain(npes, dev)
        if dev.type == "meta":
            return torch.empty(npes, dtype=torch.int32, device=dev)
        if dev.type != "cuda":
            raise ValueError(f"barrier_push: no kernel for device {dev}")
        return _barrier_launch(npes, dev)


def _barrier_launch(npes: int, dev: torch.device) -> torch.Tensor:
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    state = _BARRIERS.get(key)
    if state is None or state[1] != npes:
        if state is None or state[0].numel() < npes:
            counters = torch.zeros(npes, dtype=torch.int32, device=index)
        else:
            counters = state[0].zero_()
        state = _BARRIERS[key] = [counters, npes, 0]
    epoch = (state[2] + 1) & 0xFFFFFFFF         # the kernel's int32 wraps
    out = torch.empty(npes, dtype=torch.int32, device=index)
    ops.launch("barrier_push", "ishmem_barrier_push", index, out.data_ptr(),
               state[0].data_ptr(), npes,
               epoch - (1 << 32) if epoch >> 31 else epoch)
    state[2] = epoch
    return out
