"""Device-initiated, work-group-collaborative SHMEM ops (paper §III-F/G).

Counterpart of ``repro/core/device.py``: the ``ishmemx_*_work_group``
surface, SHMEM calls made from inside a running kernel where every
work-item of one work-group cooperates to move a block.

- A :class:`WorkGroup` is the device-side caller: which PE the kernel runs
  on and how many work-items collaborate (``Tuning.work_group_size`` by
  default).
- Every op prices direct-vs-engine per collaborative op at the group's
  width and records ``device_*`` telemetry at that width, exactly as the
  reference does.
- Non-blocking variants ride the context's completion queue, one ordered
  stream shared with the host ops.
- ``signal_wait_until`` forces only the MINIMAL pending prefix that can
  advance the waited word (``pending_first`` + ``flush_prefix``), one step
  per spin, so waiting for block k's signal leaves blocks k+1.. pending.

The kernels that consume these semantics (the fused paged gather and ring
attention) live in ``repro_torch.kernels.ishmem_device``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import cutover, pending as pending_mod
from repro_torch.core.collectives import REDUCE_OPS
from repro_torch.core.heap import TORCH_DTYPES, SymPtr
from repro_torch.core.signal import SIGNAL_ADD, SIGNAL_SET, _CMP, _sig_apply
from repro_torch.core.teams import Team

__all__ = [
    "WorkGroup", "work_group", "put", "get", "get_view", "put_nbi",
    "put_signal_nbi",
    "signal_wait_until", "broadcast", "reduce", "SIGNAL_SET", "SIGNAL_ADD",
]


@dataclasses.dataclass
class WorkGroup:
    """Device-side caller identity: ``size`` work-items on PE ``pe``."""
    ctx: object                      # ShmemContext
    size: int                        # collaborating work-items
    pe: int = 0                      # PE the kernel is running on

    def tier(self, other_pe: int) -> str:
        return self.ctx.tier(self.pe, other_pe)

    # trace-track identity: device ops render on the issuing PE's lane
    @property
    def pid(self) -> str:
        return f"pod{self.ctx.node_of(self.pe)}"

    @property
    def tid(self) -> str:
        return f"pe{self.pe}"


def work_group(ctx, size: int | None = None, pe: int = 0) -> WorkGroup:
    """Enter a device work-group scope; ``size=None`` takes
    ``ctx.tuning.work_group_size``."""
    if size is None:
        size = ctx.tuning.work_group_size
    return WorkGroup(ctx=ctx, size=int(size), pe=int(pe))


def _instant(wg: WorkGroup, name: str, **args) -> None:
    tracer = wg.ctx.tracer
    if tracer.enabled:
        tracer.instant(name, "dev", wg.pid, wg.tid, **args)


# ---------------------------------------------------------------------------
# collaborative RMA
# ---------------------------------------------------------------------------


def put(wg: WorkGroup, heap, dest: SymPtr, value, dst_pe: int):
    """ishmemx_put_work_group: the group stores a block into ``dst_pe``'s
    row; direct vs copy engine is decided at the group's width."""
    ctx = wg.ctx
    tier = wg.tier(dst_pe)
    path = cutover.choose_path(dest.nbytes, work_items=wg.size, tier=tier,
                               hw=ctx.hw, tuning=ctx.tuning)
    ctx.record("device_put", dest.nbytes, path, tier, wg.size)
    _instant(wg, "device_put", path=path, tier=tier, nbytes=dest.nbytes,
             pe=dst_pe, work_items=wg.size)
    heap = ctx.pending.resolve_store_conflicts(ctx, heap, dest, dst_pe)
    return heap.write(dest, dst_pe, value)


def get(wg: WorkGroup, heap, src: SymPtr, src_pe_remote: int):
    """ishmemx_get_work_group: cooperative one-sided load, an owned copy."""
    return get_view(wg, heap, src, src_pe_remote).clone()


def get_view(wg: WorkGroup, heap, src: SymPtr, src_pe_remote: int):
    """:func:`get`, telemetry and all, as a view of the live pool: for a
    caller that consumes it before any later store (the fused route's
    gather over a whole pool row, which must not be copied)."""
    ctx = wg.ctx
    tier = wg.tier(src_pe_remote)
    path = cutover.choose_path(src.nbytes, work_items=wg.size, tier=tier,
                               hw=ctx.hw, tuning=ctx.tuning)
    ctx.record("device_get", src.nbytes, path, tier, wg.size)
    _instant(wg, "device_get", path=path, tier=tier, nbytes=src.nbytes,
             pe=src_pe_remote, work_items=wg.size)
    return heap.read(src, src_pe_remote)


def put_nbi(wg: WorkGroup, heap, dest: SymPtr, value, dst_pe: int):
    """ishmemx_put_nbi_work_group: deferred collaborative put at the
    group's width; the transport is chosen at flush on the coalesced size.
    The queue owns a copy of the payload."""
    ctx = wg.ctx
    value = heap.staged(dest, value)
    tier = wg.tier(dst_pe)
    marker_path = "proxy" if tier == "dcn" else "engine"
    ctx.record("device_put_nbi(pending)", dest.nbytes, marker_path, tier,
               wg.size, t_sec=0.0)
    ctx.pending.submit(pending_mod.PUT, "device_put_nbi", dest, dst_pe, tier,
                       work_items=wg.size, value=value,
                       marker=ctx.ledger[-1] if ctx.ledger else None)
    return heap


def put_signal_nbi(wg: WorkGroup, heap, dest: SymPtr, value, sig_ptr: SymPtr,
                   signal, sig_op: int, dst_pe: int):
    """ishmemx_put_signal_nbi_work_group: deferred data put + deferred
    signal update, data before flag inside the flush."""
    ctx = wg.ctx
    heap = put_nbi(wg, heap, dest, value, dst_pe)
    tier = wg.tier(dst_pe)
    ctx.record("signal(pending)", TORCH_DTYPES[sig_ptr.dtype].itemsize,
               "direct", tier, 1, t_sec=0.0)
    ctx.pending.submit(pending_mod.SIGNAL, "signal", sig_ptr, dst_pe, tier,
                       apply=_sig_apply(signal, sig_op),
                       marker=ctx.ledger[-1] if ctx.ledger else None)
    return heap


# ---------------------------------------------------------------------------
# device-side signal wait
# ---------------------------------------------------------------------------


def signal_wait_until(wg: WorkGroup, heap, sig_ptr: SymPtr, pe: int,
                      cmp: str, value):
    """ishmemx_signal_wait_until_work_group: spin until the predicate
    holds, each spin forcing only the first pending op that can advance the
    word and the queue prefix before it.  Returns ``(heap, last_value,
    satisfied)``; ``satisfied`` is False when no pending traffic can ever
    satisfy the predicate (a real spin would deadlock)."""
    ctx = wg.ctx
    spins = 0
    while True:
        cur = heap.read(sig_ptr, pe).reshape(())
        if _CMP[cmp](cur.item(), value):
            ok = True
            break
        dep = ctx.pending.pending_first(sig_ptr, pe)
        if dep is None:
            ok = False
            break
        heap = ctx.pending.flush_prefix(ctx, heap, dep)
        spins += 1
    ctx.record("device_signal_wait", 0, "direct", "local", wg.size)
    _instant(wg, "device_signal_wait", cmp=cmp, value=int(value),
             observed=int(cur), spins=spins, ok=ok)
    return heap, cur.clone(), ok


# ---------------------------------------------------------------------------
# collaborative collectives
# ---------------------------------------------------------------------------


def broadcast(wg: WorkGroup, heap, ptr: SymPtr, root: int, team: Team):
    """ishmemx_broadcast_work_group: the root's group pushes its buffer to
    every teammate, priced at the group's width."""
    ctx = wg.ctx
    path = cutover.choose_collective_path(
        "broadcast", ptr.nbytes, team.size, work_items=wg.size, tier="ici",
        hw=ctx.hw, tuning=ctx.tuning)
    src = heap.read(ptr, team.translate(root))
    data = heap.read_all(ptr).clone()
    data[team.pes()] = src
    heap = heap.write_all(ptr, data)
    t = cutover.t_collective("broadcast", ptr.nbytes, team.size,
                             work_items=wg.size, path=path, hw=ctx.hw)
    ctx.record("device_broadcast", ptr.nbytes, path, "ici", wg.size, t_sec=t)
    _instant(wg, "device_broadcast", path=path, nbytes=ptr.nbytes,
             npes=team.size, work_items=wg.size)
    return heap


def reduce(wg: WorkGroup, heap, dest: SymPtr, src: SymPtr, op: str,
           team: Team):
    """ishmemx_<op>_reduce_work_group: address-split across the group's
    work-items; every teammate ends with the reduction, folded in PE
    order."""
    ctx = wg.ctx
    fn, _ = REDUCE_OPS[op]
    rows = heap.read_all(src)[team.pes()]
    acc = rows[0]
    for i in range(1, team.size):
        acc = fn(acc, rows[i])
    out = heap.read_all(dest).clone()
    out[team.pes()] = acc.reshape(dest.shape).to(out.dtype)
    heap = heap.write_all(dest, out)
    path = cutover.choose_collective_path(
        "reduce", src.nbytes, team.size, work_items=wg.size, tier="ici",
        hw=ctx.hw, tuning=ctx.tuning)
    t = cutover.t_collective("reduce", src.nbytes, team.size,
                             work_items=wg.size, path=path, hw=ctx.hw)
    ctx.record("device_reduce", src.nbytes, path, "ici", wg.size, t_sec=t)
    _instant(wg, "device_reduce", path=path, op=op, nbytes=src.nbytes,
             npes=team.size, work_items=wg.size)
    return heap
