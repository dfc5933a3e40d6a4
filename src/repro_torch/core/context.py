"""ishmem_init / library context.

Counterpart of ``repro/core/context.py``: the symmetric heap, the PE
topology (which PEs share a fabric tier), the transport tuning, the
telemetry sink, the completion queue and the tracer.  ``init`` uses
``cutover.Tuning()`` defaults unless given a tuning: it reads no
``ISHMEM_*`` environment variable yet, and ``fit_tuning_table`` is not
ported (both come with the tuning knobs, ROADMAP queue 1, item 5c).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import cutover, heap as heap_mod, \
    pending as pending_mod, teams
from repro_torch.obs import tracer as tracer_mod
from repro_torch.tune import telemetry as telemetry_mod

OpRecord = telemetry_mod.OpRecord


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
               work_items: int = 1, t_sec: Optional[float] = None) -> None:
        """Record one op; without ``t_sec`` the analytic cost model prices
        it (the modeled comm clock, not a measurement)."""
        if t_sec is None:
            t_sec = cutover.op_time(nbytes, path, work_items=work_items,
                                    tier=tier if path != "proxy" else "dcn",
                                    hw=self.hw)
        self.telemetry.record(OpRecord(op, nbytes, path, tier, t_sec,
                                       work_items))

    def total_time(self) -> float:
        return self.telemetry.total_time()


def init(npes: int, node_size: Optional[int] = None,
         hw: Optional[cutover.HwParams] = None,
         tuning: Optional[cutover.Tuning] = None,
         heap_words: int = 1 << 20,
         telemetry: Optional[telemetry_mod.TelemetrySink] = None,
         device=None):
    """ishmem_init: returns ``(ctx, heap)``.  The heap lives on ``device``:
    the current CUDA device unless the caller passes another (``"cpu"``
    runs every kernel's plain version)."""
    ctx = ShmemContext(
        npes=npes,
        node_size=node_size or npes,
        hw=hw or cutover.HwParams(),
        tuning=tuning if tuning is not None else cutover.Tuning(),
        telemetry=telemetry or telemetry_mod.TelemetrySink(),
    )
    return ctx, heap_mod.create(npes, heap_words, device=device)
