"""Online tuner re-fit: close the telemetry -> estimator -> cutover loop
*during* a run.

Counterpart of ``repro/obs/refit.py``.

The offline path already exists end-to-end: ops recorded into the context's
:class:`~repro_torch.tune.telemetry.TelemetrySink` are fitted by
``tune.estimator.build_table`` into a :class:`~repro_torch.tune.table.TuningTable`
that ``core.cutover.choose_path`` consults.  This module is the driver
that does so *periodically while the fleet is serving*, so a warm-started
table that no longer matches reality — stale profile file, different
message-size mix, changed work-group sizes — gets corrected mid-run
instead of steering every subsequent transfer wrong.

:class:`OnlineRefitter` is that driver.  Every ``period_steps`` fleet steps
(and only once enough new samples accumulated) it re-runs the estimator
over the live sink and hot-swaps the armed table via
``ctx.fit_tuning_table(arm=True)``.  To make the effect observable it
probes ``choose_path`` over a small (tier, work_items, nbytes) grid before
and after the swap and reports exactly which decisions flipped — the CI
gate asserts at least one flip in the heterogeneous-tier smoke run, and
each re-fit lands in the trace as a ``fleet/refit`` instant carrying the
flip list.

Two sample streams can feed the fit.  The default (``sample_source=None``)
fits the analytic model stream: live op timings are priced by the same
model ``choose_path`` falls back to, so a re-fit from a *clean* start
converges to the decisions already being made (a no-op — correct behavior,
not a failure); the interesting case is a stale/skewed warm-start table,
which the re-fit visibly overwrites.  With a wall-clock profiler attached
(``repro_torch.obs.prof``), ``sample_source="wallclock"`` fits only the profiler's
*measured* samples instead — the table that gets hot-swapped then carries
``source="wallclock"`` provenance down to its profiles, closing the paper's
adapt-from-measurement loop with genuinely measured time rather than model
echo.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import cutover

#: default probe grid: sizes bracketing typical cutovers (64 B .. 4 MiB)
PROBE_SIZES = tuple(1 << s for s in range(6, 23, 2))
PROBE_TIERS = ("local", "ici")          # dcn is pinned to proxy — no decision
PROBE_WIS = (1, 32, 128, 512)


@dataclasses.dataclass
class RefitEvent:
    """One completed re-fit: when, over how much data, what flipped."""
    step: int
    nsamples: int                       # retained sink samples fitted over
    ncutovers: int                      # cutover entries in the new table
    changed: List[Tuple[str, int, int, str, str]]  # (tier, wi, nbytes, old, new)

    def to_json(self) -> dict:
        return {
            "step": self.step,
            "nsamples": self.nsamples,
            "ncutovers": self.ncutovers,
            "changed": [
                {"tier": t, "work_items": wi, "nbytes": n,
                 "old": old, "new": new}
                for (t, wi, n, old, new) in self.changed
            ],
        }


class OnlineRefitter:
    """Periodically re-fit the tuning table from the context's live sink.

    ``maybe_refit(step)`` is cheap when it declines (two int compares), so
    the fleet calls it unconditionally every step."""

    def __init__(self, ctx, *, period_steps: int = 50,
                 min_samples: int = 64,
                 probe_sizes: Sequence[int] = PROBE_SIZES,
                 probe_tiers: Sequence[str] = PROBE_TIERS,
                 probe_wis: Sequence[int] = PROBE_WIS,
                 tracer=None,
                 sample_source: Optional[str] = None):
        if period_steps <= 0:
            raise ValueError("period_steps must be positive (0 = use no "
                             "refitter at all)")
        self.ctx = ctx
        self.period_steps = period_steps
        self.min_samples = min_samples
        self.probe_sizes = tuple(probe_sizes)
        self.probe_tiers = tuple(probe_tiers)
        self.probe_wis = tuple(probe_wis)
        self.tracer = tracer
        # telemetry provenance stream to fit (None = the model stream;
        # "wallclock" = measured profiler samples only)
        self.sample_source = sample_source
        self.last_refit_step = -1
        self.history: List[RefitEvent] = []

    # ------------------------------------------------------------ plumbing
    def _probe(self) -> dict:
        """choose_path over the probe grid under the currently armed
        tuning — the observable surface a re-fit can change."""
        out = {}
        for tier in self.probe_tiers:
            for wi in self.probe_wis:
                for n in self.probe_sizes:
                    out[(tier, wi, n)] = cutover.choose_path(
                        n, work_items=wi, tier=tier, hw=self.ctx.hw,
                        tuning=self.ctx.tuning)
        return out

    def _nsamples(self) -> int:
        tel = self.ctx.telemetry
        count = getattr(tel, "nsamples", None)
        if count is not None:
            return count(self.sample_source)
        buckets = getattr(tel, "buckets", None) or {}
        return sum(len(b.samples) for b in buckets.values())

    # -------------------------------------------------------------- public
    def maybe_refit(self, step: int) -> Optional[RefitEvent]:
        """Re-fit if a full period elapsed and the sink has enough samples;
        returns the :class:`RefitEvent` when a re-fit ran, else None."""
        if step - self.last_refit_step < self.period_steps:
            return None
        nsamples = self._nsamples()
        if nsamples < self.min_samples:
            return None
        return self.refit(step, nsamples=nsamples)

    def refit(self, step: int, *, nsamples: Optional[int] = None) -> RefitEvent:
        """Unconditional re-fit + hot-swap; records and returns the event."""
        before = self._probe()
        tbl = self.ctx.fit_tuning_table(arm=True,
                                        sample_source=self.sample_source)
        after = self._probe()
        changed = [(t, wi, n, before[(t, wi, n)], after[(t, wi, n)])
                   for (t, wi, n) in before
                   if after[(t, wi, n)] != before[(t, wi, n)]]
        ev = RefitEvent(step=step,
                        nsamples=(self._nsamples() if nsamples is None
                                  else nsamples),
                        ncutovers=len(tbl.cutovers),
                        changed=changed)
        self.last_refit_step = step
        self.history.append(ev)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant(
                "refit", "fleet", "fleet", "tuner",
                step=step, nsamples=ev.nsamples, ncutovers=ev.ncutovers,
                decisions_changed=len(changed),
                source=self.sample_source or "model")
        return ev

    def decisions_changed(self) -> int:
        return sum(len(ev.changed) for ev in self.history)
