"""ishmem_init / library context.

Counterpart of ``repro/core/context.py``: the symmetric heap, the PE
topology (which PEs share a fabric tier), the transport tuning, the
telemetry sink, the completion queue, the tracer, the wall-clock profiler
and the failure-domain view (:class:`FaultState`: dead PEs, a partitioned
dcn fabric).  ``init`` reads the ``ISHMEM_*`` environment variables
(``repro_torch.tune.env``) when no tuning is given, which may arm a
learned cutover table from ``ISHMEM_TUNING_FILE``;
:meth:`ShmemContext.fit_tuning_table` fits one from the telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Set

from repro_torch.core import cutover, heap as heap_mod, \
    pending as pending_mod, teams
from repro_torch.obs import tracer as tracer_mod
from repro_torch.tune import env as env_mod, telemetry as telemetry_mod

OpRecord = telemetry_mod.OpRecord


@dataclasses.dataclass
class FaultState:
    """Host-side failure-domain view.  ``dead_pes`` holds PEs whose device
    is gone: their heap rows are garbage, pending traffic touching them (as
    source or destination) cancels with an error instead of completing.
    ``dcn_down`` is a partitioned proxy ring: cross-pod (dcn-tier) ops stay
    queued, neither lost nor delivered, until the partition heals."""
    dead_pes: Set[int] = dataclasses.field(default_factory=set)
    dcn_down: bool = False

    def alive(self, pe: int) -> bool:
        return int(pe) not in self.dead_pes

    def kill(self, pe: int) -> None:
        self.dead_pes.add(int(pe))


@dataclasses.dataclass
class ShmemContext:
    npes: int
    node_size: int                      # PEs per shared-fabric node (pod)
    hw: cutover.HwParams
    tuning: cutover.Tuning
    telemetry: telemetry_mod.TelemetrySink = dataclasses.field(
        default_factory=telemetry_mod.TelemetrySink)
    pending: pending_mod.CompletionQueue = dataclasses.field(
        default_factory=pending_mod.CompletionQueue)
    tracer: tracer_mod.Tracer = tracer_mod.NULL_TRACER
    # wall-clock profiler (obs.prof): None unless a driver attaches one, so
    # hot paths guard on ``prof is not None and prof.enabled``.  Its
    # perf_counter values land only in wallclock telemetry buckets and its
    # own samples, never in a trace timestamp or the modeled comm clock
    prof: Optional[object] = None
    # which PEs are dead and whether the proxy ring is partitioned: the
    # completion queue consults it at flush time
    fault: FaultState = dataclasses.field(default_factory=FaultState)

    # ------------------------------------------------------------ topology
    def node_of(self, pe: int) -> int:
        return pe // self.node_size

    def tier(self, src_pe: int, dst_pe: int) -> str:
        if src_pe == dst_pe:
            return "local"
        if self.node_of(src_pe) == self.node_of(dst_pe):
            return "ici"
        return "dcn"

    @property
    def team_world(self) -> teams.Team:
        return teams.world(self.npes)

    def team_shared(self, pe: int = 0) -> teams.Team:
        return teams.shared(self.npes, self.node_size, self.node_of(pe))

    # ----------------------------------------------------------- telemetry
    @property
    def ledger(self) -> list:
        """Recent-ops view (the telemetry's bounded trace)."""
        return self.telemetry.trace

    def record(self, op: str, nbytes: int, path: str, tier: str,
               work_items: int = 1, t_sec: Optional[float] = None,
               source: str = telemetry_mod.MODEL_SOURCE) -> None:
        """Record one op; without ``t_sec`` the analytic cost model prices
        it (the modeled comm clock, not a measurement).  ``source`` tags
        provenance: ``"model"`` (the comm clock) or ``"wallclock"``
        (measured; aggregated in buckets of its own)."""
        if t_sec is None:
            t_sec = cutover.op_time(nbytes, path, work_items=work_items,
                                    tier=tier if path != "proxy" else "dcn",
                                    hw=self.hw)
        self.telemetry.record(OpRecord(op, nbytes, path, tier, t_sec,
                                       work_items, source))

    def total_time(self) -> float:
        return self.telemetry.total_time()

    def reset_ledger(self) -> None:
        self.telemetry.clear()

    def fit_tuning_table(self, *, arm: bool = True,
                         sample_source: Optional[str] = None):
        """Fit a measured cutover table from everything recorded so far
        (``repro_torch.tune.estimator``); with ``arm`` the table goes on
        ``self.tuning``, so later ``choose_path`` calls use it.
        ``sample_source`` restricts the fit to one provenance stream
        (``"wallclock"``: the profiler's measured samples) and labels the
        table with it."""
        from repro_torch.tune import estimator, table as table_mod
        if not isinstance(self.telemetry, telemetry_mod.TelemetrySink):
            return table_mod.TuningTable(source="empty")   # e.g. NullSink
        tbl = estimator.build_table(self.telemetry,
                                    source=sample_source or "measured",
                                    sample_source=sample_source)
        if arm and (tbl.cutovers or tbl.profiles):
            self.tuning = dataclasses.replace(self.tuning, table=tbl)
        return tbl


def init(npes: int, node_size: Optional[int] = None,
         hw: Optional[cutover.HwParams] = None,
         tuning: Optional[cutover.Tuning] = None,
         heap_words: int = 1 << 20,
         telemetry: Optional[telemetry_mod.TelemetrySink] = None,
         device=None):
    """ishmem_init: returns ``(ctx, heap)``.  The heap lives on ``device``:
    the current CUDA device unless the caller passes another (``"cpu"``
    runs every kernel's plain version).  Without ``tuning`` the
    ``ISHMEM_*`` environment variables configure it, as the library's
    init parses its knobs."""
    ctx = ShmemContext(
        npes=npes,
        node_size=node_size or npes,
        hw=hw or cutover.HwParams(),
        tuning=tuning if tuning is not None else env_mod.tuning_from_env(),
        telemetry=telemetry or telemetry_mod.TelemetrySink(),
    )
    return ctx, heap_mod.create(npes, heap_words, device=device)
