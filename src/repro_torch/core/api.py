"""The paper-named API facade: ``ishmem_*`` / ``ishmemx_*`` over the core.

Counterpart of ``repro/core/api.py``.  A stateful wrapper that threads
``(ctx, heap)`` through the functional core, so application code reads
like the paper's listings:

    sh = Ishmem(npes=8, node_size=4)             # heap on the current card
    buf = sh.ishmem_malloc((1024,), "float32")
    sh.ishmem_put(buf, data, pe=3)
    sh.ishmemx_put_work_group(buf, data, pe=1, work_group_size=1024)
    sh.ishmem_barrier_all()

The heap lives on ``device`` (the current CUDA device unless the caller
asks for another, as ``_devices.resolve`` has it).
``ishmem_quiet(proxy=...)`` drains dcn-tier puts through a
:class:`~repro_torch.core.proxy.HostProxy`.
"""
from __future__ import annotations

from repro_torch.core import amo, collectives, context, rma, signal
from repro_torch.core.teams import Team


class Ishmem:
    def __init__(self, npes: int, node_size: int = None, *, device=None,
                 **kw):
        self.ctx, self.heap = context.init(npes, node_size, device=device,
                                           **kw)
        self._psync = self.heap.malloc((), "int32")

    # ------------------------------------------------------------ setup
    def ishmem_n_pes(self) -> int:
        return self.ctx.npes

    def ishmem_team_n_pes(self, team: Team) -> int:
        return team.size

    def ishmem_malloc(self, shape, dtype):
        return self.heap.malloc(shape, dtype)

    def ishmem_calloc(self, shape, dtype):
        return self.heap.calloc(shape, dtype)

    def ishmem_free(self, ptr):
        self.heap.free(ptr)

    # ------------------------------------------------------------ RMA
    def ishmem_put(self, dest, value, pe, **kw):
        self.heap = rma.put(self.ctx, self.heap, dest, value, pe, **kw)

    def ishmem_get(self, src, pe, **kw):
        return rma.get(self.ctx, self.heap, src, pe, **kw)

    def ishmem_p(self, dest, scalar, pe):
        self.heap = rma.p(self.ctx, self.heap, dest, scalar, pe)

    def ishmem_g(self, src, pe):
        return rma.g(self.ctx, self.heap, src, pe)

    def ishmem_iput(self, dest, value, pe, **kw):
        self.heap = rma.iput(self.ctx, self.heap, dest, value, pe, **kw)

    def ishmem_put_nbi(self, dest, value, pe, **kw):
        self.heap = rma.put_nbi(self.ctx, self.heap, dest, value, pe, **kw)

    def ishmem_get_nbi(self, src, pe, **kw):
        return rma.get_nbi(self.ctx, self.heap, src, pe, **kw)

    def ishmem_quiet(self, proxy=None):
        self.heap = rma.quiet(self.ctx, self.heap, proxy=proxy)

    def ishmem_fence(self):
        self.heap = rma.fence(self.ctx, self.heap)

    def ishmem_pending_ops(self) -> int:
        """Deferred (not yet completed) op count — 0 right after quiet."""
        return len(self.ctx.pending)

    # device extensions (§III-F)
    def ishmemx_put_work_group(self, dest, value, pe, work_group_size=128):
        self.heap = rma.put(self.ctx, self.heap, dest, value, pe,
                            work_items=work_group_size)

    def ishmemx_get_work_group(self, src, pe, work_group_size=128):
        return rma.get(self.ctx, self.heap, src, pe,
                       work_items=work_group_size)

    # ------------------------------------------------------------ AMO
    def ishmem_atomic_fetch_add(self, ptr, value, pe):
        self.heap, old = amo.fetch_add(self.ctx, self.heap, ptr, value, pe)
        return old

    def ishmem_atomic_inc(self, ptr, pe):
        self.heap = amo.inc(self.ctx, self.heap, ptr, pe)

    def ishmem_atomic_compare_swap(self, ptr, cond, value, pe):
        self.heap, old = amo.compare_swap(self.ctx, self.heap, ptr, cond,
                                          value, pe)
        return old

    def ishmem_atomic_fetch(self, ptr, pe):
        return amo.fetch(self.ctx, self.heap, ptr, pe)

    def ishmem_atomic_set(self, ptr, value, pe):
        self.heap = amo.set_(self.ctx, self.heap, ptr, value, pe)

    def ishmem_atomic_add_nbi(self, ptr, value, pe):
        self.heap = amo.add_nbi(self.ctx, self.heap, ptr, value, pe)

    # ------------------------------------------------------------ signal
    def ishmem_put_signal(self, dest, value, sig, signal_val, sig_op, pe):
        self.heap = signal.put_signal(self.ctx, self.heap, dest, value, sig,
                                      signal_val, sig_op, pe)

    def ishmem_put_signal_nbi(self, dest, value, sig, signal_val, sig_op, pe):
        self.heap = signal.put_signal_nbi(self.ctx, self.heap, dest, value,
                                          sig, signal_val, sig_op, pe)

    def ishmem_signal_wait_until(self, sig, pe, cmp, value):
        self.heap, cur, ok = signal.signal_wait_until(
            self.ctx, self.heap, sig, pe, cmp, value)
        return cur, ok

    # ------------------------------------------------------------ collectives
    def _team(self, team):
        return team or self.ctx.team_world

    def ishmem_team_sync(self, team=None):
        self.heap, sat = collectives.sync(self.ctx, self.heap, self._psync,
                                          self._team(team))
        return sat

    def ishmem_barrier_all(self):
        self.heap, sat = collectives.barrier(self.ctx, self.heap,
                                             self._psync, self.ctx.team_world)
        return sat

    def ishmem_broadcast(self, ptr, root, team=None, **kw):
        self.heap = collectives.broadcast(self.ctx, self.heap, ptr, root,
                                          self._team(team), **kw)

    def ishmem_fcollect(self, dest, src, team=None, **kw):
        self.heap = collectives.fcollect(self.ctx, self.heap, dest, src,
                                         self._team(team), **kw)

    def ishmem_sum_reduce(self, dest, src, team=None, **kw):
        self.heap = collectives.reduce(self.ctx, self.heap, dest, src, "sum",
                                       self._team(team), **kw)

    def ishmem_max_reduce(self, dest, src, team=None, **kw):
        self.heap = collectives.reduce(self.ctx, self.heap, dest, src, "max",
                                       self._team(team), **kw)

    def ishmem_alltoall(self, dest, src, team=None, **kw):
        self.heap = collectives.alltoall(self.ctx, self.heap, dest, src,
                                         self._team(team), **kw)

    # work_group collective extensions
    def ishmemx_broadcast_work_group(self, ptr, root, team=None,
                                     work_group_size=128):
        self.ishmem_broadcast(ptr, root, team, work_items=work_group_size)

    def ishmemx_fcollect_work_group(self, dest, src, team=None,
                                    work_group_size=128):
        self.ishmem_fcollect(dest, src, team, work_items=work_group_size)

    def ishmemx_sum_reduce_work_group(self, dest, src, team=None,
                                      work_group_size=128):
        self.ishmem_sum_reduce(dest, src, team, work_items=work_group_size)

    def ishmemx_barrier_all_work_group(self, work_group_size=128):
        return self.ishmem_barrier_all()
