"""Team collectives over the symmetric heap (paper §III-G2).

Counterpart of ``repro/core/collectives.py``: the host-path collectives
behind the ``Ishmem`` facade, with the paper's algorithm choices priced by
the cutover engine and recorded on the context's telemetry:

- ``sync``: push — every PE adds to every teammate's counter, then waits
  locally;
- ``broadcast`` / ``fcollect``: push-style stores, inner loop over
  destinations;
- ``reduce``: address-split duplicated compute below ``RING_REDUCE_BYTES``
  per PE, ring reduce-scatter + all-gather above (the same result; the
  record names the algorithm);
- ``alltoall``: pairwise exchange.

Every op reads the team's rows, computes them in plain torch, and stores
them back through ``write_all`` (K1 on a CUDA heap, in place).  The device-initiated ring kernels serve the comms backend
(``comms/api.py``), as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import cutover
from repro_torch.core.heap import SymPtr
from repro_torch.core.teams import Team

REDUCE_OPS = {
    "sum": (torch.add, 0),
    "prod": (torch.mul, 1),
    "min": (torch.minimum, None),
    "max": (torch.maximum, None),
    "and": (torch.bitwise_and, None),
    "or": (torch.bitwise_or, None),
    "xor": (torch.bitwise_xor, None),
}

# messages larger than this per PE use the ring algorithm for reductions
RING_REDUCE_BYTES = 1 << 20


def _team_rows(heap, ptr: SymPtr, team: Team) -> torch.Tensor:
    return heap.read_all(ptr)[team.pes()]          # (team.size, *shape)


def _scatter_team(heap, ptr: SymPtr, team: Team, values):
    data = heap.read_all(ptr).clone()
    data[team.pes()] = values
    return heap.write_all(ptr, data)


def _path(ctx, kind, nbytes, npes, work_items):
    return cutover.choose_collective_path(kind, nbytes, npes,
                                          work_items=work_items, tier="ici",
                                          hw=ctx.hw, tuning=ctx.tuning)


def _record(ctx, kind, nbytes, team, path, work_items):
    base_kind = kind.split("[")[0]
    t = cutover.t_collective(base_kind, nbytes, team.size,
                             work_items=work_items, path=path, hw=ctx.hw)
    ctx.record(kind, nbytes, path, "ici", work_items, t_sec=t)


# ---------------------------------------------------------------------------
# synchronization
# ---------------------------------------------------------------------------


def sync(ctx, heap, counter: SymPtr, team: Team, *, work_items: int = 1):
    """ishmem_team_sync: push increments, local wait.  ``counter`` is a
    symmetric int buffer.  Returns ``(heap, satisfied)``, a bool tensor over
    the team (all true once every push has landed)."""
    rows = heap.read_all(counter).clone()          # (npes, ...)
    pes = team.pes()
    rows[pes] += team.size                         # team.size increments each
    heap = heap.write_all(counter, rows)
    satisfied = rows[pes].reshape(team.size) >= team.size
    _record(ctx, "sync", 8, team, "direct", work_items)
    return heap, satisfied


def barrier(ctx, heap, counter: SymPtr, team: Team, *, work_items: int = 1):
    """barrier = quiet + sync."""
    from repro_torch.core import rma
    heap = rma.quiet(ctx, heap)
    return sync(ctx, heap, counter, team, work_items=work_items)


# ---------------------------------------------------------------------------
# data collectives
# ---------------------------------------------------------------------------


def broadcast(ctx, heap, ptr: SymPtr, root: int, team: Team, *,
              work_items: int = 1):
    """ishmem_broadcast: the root's buffer (``root`` is a team rank) lands
    at every teammate."""
    path = _path(ctx, "broadcast", ptr.nbytes, team.size, work_items)
    src = heap.read(ptr, team.translate(root))
    heap = _scatter_team(heap, ptr, team, src.unsqueeze(0))
    _record(ctx, "broadcast", ptr.nbytes, team, path, work_items)
    return heap


def fcollect(ctx, heap, dest: SymPtr, src: SymPtr, team: Team, *,
             work_items: int = 1):
    """ishmem_fcollect (allgather): every teammate's dest holds the team's
    src chunks in rank order.  dest.size == team.size * src.size."""
    if dest.size != team.size * src.size:
        raise ValueError(f"fcollect: dest holds {dest.size} elements, needs "
                         f"{team.size} x {src.size}")
    gathered = _team_rows(heap, src, team).reshape(1, -1)
    heap = _scatter_team(heap, dest, team,
                         gathered.reshape((1,) + dest.shape))
    path = _path(ctx, "fcollect", src.nbytes, team.size, work_items)
    _record(ctx, "fcollect", src.nbytes, team, path, work_items)
    return heap


def collect(ctx, heap, dest: SymPtr, src: SymPtr, nelems_per_pe, team: Team,
            *, work_items: int = 1):
    """ishmem_collect: ragged allgather of the first ``nelems_per_pe[i]``
    elements of each rank's src."""
    rows = _team_rows(heap, src, team).reshape(team.size, -1)
    gathered = torch.cat([rows[i, :int(nelems_per_pe[i])]
                          for i in range(team.size)])
    total = int(sum(nelems_per_pe))
    if total > dest.size:
        raise ValueError(f"collect: {total} elements overrun a dest of "
                         f"{dest.size}")
    vals = _team_rows(heap, dest, team).reshape(team.size, dest.size).clone()
    vals[:, :total] = gathered
    heap = _scatter_team(heap, dest, team,
                         vals.reshape((team.size,) + dest.shape))
    path = _path(ctx, "fcollect", int(max(nelems_per_pe)) * 4, team.size,
                 work_items)
    _record(ctx, "fcollect", total * 4, team, path, work_items)
    return heap


def reduce(ctx, heap, dest: SymPtr, src: SymPtr, op: str, team: Team, *,
           work_items: int = 1):
    """ishmem_<op>_reduce: rank 0's row folded with every other rank's in
    rank order (one elementwise op per rank, in src's dtype); every
    teammate's dest receives the result."""
    fn, _ = REDUCE_OPS[op]
    rows = _team_rows(heap, src, team)
    acc = rows[0]
    for i in range(1, team.size):
        acc = fn(acc, rows[i])
    heap = _scatter_team(heap, dest, team, acc.reshape((1,) + dest.shape))
    algo = "ring" if src.nbytes > RING_REDUCE_BYTES else "flat"
    path = _path(ctx, "reduce", src.nbytes, team.size, work_items)
    _record(ctx, f"reduce[{algo}]", src.nbytes, team, path, work_items)
    return heap


def alltoall(ctx, heap, dest: SymPtr, src: SymPtr, team: Team, *,
             work_items: int = 1):
    """ishmem_alltoall: rank i's chunk j lands in rank j's slot i."""
    if src.size != dest.size or src.size % team.size:
        raise ValueError(f"alltoall: src {src.size} and dest {dest.size} "
                         f"must match and split into {team.size} chunks")
    chunk = src.size // team.size
    rows = _team_rows(heap, src, team).reshape(team.size, team.size, chunk)
    out = rows.transpose(0, 1).reshape((team.size,) + dest.shape)
    heap = _scatter_team(heap, dest, team, out)
    path = _path(ctx, "broadcast", chunk * 4, team.size, work_items)
    _record(ctx, "alltoall", src.nbytes, team, path, work_items)
    return heap
