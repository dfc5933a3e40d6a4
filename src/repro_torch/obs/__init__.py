"""Fleet-wide observability: causal spans, Chrome-trace export, metrics
time series, online tuner re-fit, critical-path analysis, invariant
auditors, a flight recorder, SLO burn-rate alerting and a measured
wall-clock profiler.

Counterpart of ``repro/obs/__init__.py``.

The one-stop entry point is :class:`Obs` — a bundle of (tracer, metrics
registry, refitter, auditor, flight recorder, burn-rate monitor) that the
fleet driver and launchers thread through the stack:

    obs = Obs(trace=True, refit_period=50, audit_period=8,
              recorder_window=64, alerts=True)
    fleet = Fleet(fcfg, obs=obs)          # installs tracer on fleet.ctx
    fleet.run(specs)
    obs.write_trace("out.json")           # load in ui.perfetto.dev

Everything is opt-in: with no ``Obs`` (or ``Obs()`` with all features off)
the context keeps the :data:`~repro_torch.obs.tracer.NULL_TRACER` and runs are
bitwise-identical to the uninstrumented stack.  The flight recorder is the
middle setting — spans recorded into a bounded last-K-steps ring
(:class:`~repro_torch.obs.recorder.RingTracer`), exported only as a postmortem
dump when a crash, audit violation, or SLO alert demands one.
"""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.obs import calibrate as calibrate_mod
from repro_torch.obs import prof as prof_mod
from repro_torch.obs.alerts import (DEFAULT_WINDOWS, Alert, BurnRateMonitor,
                              BurnWindow, parse_windows)
from repro_torch.obs.audit import AuditError, AuditViolation, FleetAuditor
from repro_torch.obs.env import TRACE_CLOCKS, ObsConfig, load_obs_env
from repro_torch.obs.export import (chrome_trace, request_chains, validate,
                              write_chrome_trace)
from repro_torch.obs.metrics import MetricsRegistry, sample_fleet
from repro_torch.obs.prof import NULL_PROF, ProfClock, Profiler, ProfSample
from repro_torch.obs.recorder import FlightRecorder, RingTracer
from repro_torch.obs.refit import OnlineRefitter, RefitEvent
from repro_torch.obs.tracer import (NULL_TRACER, SpanTracer, TraceEvent,
                                    Tracer, WallClock)

__all__ = [
    "Obs", "ObsConfig", "load_obs_env",
    "Tracer", "SpanTracer", "TraceEvent", "NULL_TRACER", "RingTracer",
    "WallClock",
    "Profiler", "ProfClock", "ProfSample", "NULL_PROF",
    "MetricsRegistry", "sample_fleet",
    "OnlineRefitter", "RefitEvent",
    "FleetAuditor", "AuditError", "AuditViolation",
    "FlightRecorder",
    "BurnRateMonitor", "BurnWindow", "Alert", "DEFAULT_WINDOWS",
    "chrome_trace", "write_chrome_trace", "validate", "request_chains",
]


class Obs:
    """Observability bundle a driver attaches to a run.

    Parameters mirror :class:`ObsConfig`; :meth:`from_env` builds one from
    the ``ISHMEM_OBS_*`` variables.  ``attach(ctx)`` installs the tracer on
    a context and (when a re-fit period is set) creates the
    :class:`OnlineRefitter` against it.

    Per-step driving (the fleet loop calls :meth:`begin_step` /
    :meth:`end_step`): metrics sampling feeds the flight recorder and the
    burn-rate monitor; every ``audit_period`` steps the invariant auditors
    sweep the live fleet and **raise** :class:`AuditError` on a violation —
    after the recorder (when armed) has written a postmortem dump.  A newly
    fired SLO alert also triggers a dump, but does not raise.
    """

    def __init__(self, *, trace: bool = False, metrics: bool = False,
                 refit_period: int = 0, refit_min_samples: int = 64,
                 trace_limit: int = 1 << 20,
                 audit_period: int = 0,
                 recorder_window: int = 0,
                 recorder_path: str = "postmortem_trace.json",
                 alerts: bool = False, alert_target: float = 0.9,
                 alert_windows: Union[str, tuple] = DEFAULT_WINDOWS,
                 prof: bool = False, calibration: bool = False,
                 trace_clock: str = "step"):
        if trace_clock not in TRACE_CLOCKS:
            raise ValueError(f"trace_clock: expected one of {TRACE_CLOCKS}, "
                             f"got {trace_clock!r}")
        clock = WallClock() if trace_clock == "wall" else None
        if trace:
            self.tracer = SpanTracer(max_events=trace_limit, clock=clock)
        elif recorder_window > 0:
            # recorder without full tracing: bounded last-K-steps ring
            self.tracer = RingTracer(window_steps=recorder_window,
                                     max_events=trace_limit, clock=clock)
        else:
            self.tracer = NULL_TRACER
        # the burn-rate monitor reads the per-class ledger off the metrics
        # series, so alerting implies sampling
        self.metrics = MetricsRegistry() if (metrics or alerts) else None
        self.refit_period = refit_period
        self.refit_min_samples = refit_min_samples
        self.refitter: Optional[OnlineRefitter] = None
        self.audit_period = audit_period
        self.auditor = (FleetAuditor() if audit_period > 0 else None)
        self.recorder = (FlightRecorder(self.tracer,
                                        window_steps=recorder_window,
                                        path=recorder_path)
                         if recorder_window > 0 else None)
        if isinstance(alert_windows, str):
            alert_windows = parse_windows(alert_windows)
        self.monitor = (BurnRateMonitor(target=alert_target,
                                        windows=alert_windows)
                        if alerts else None)
        # wall-clock profiler (strictly segregated clock): a calibration
        # report needs measured samples, so calibration implies prof
        self.calibration = calibration
        self.prof: Optional[Profiler] = (Profiler()
                                         if (prof or calibration) else None)

    @classmethod
    def from_env(cls, cfg: Optional[ObsConfig] = None) -> "Obs":
        cfg = load_obs_env() if cfg is None else cfg
        return cls(trace=cfg.trace, metrics=cfg.metrics,
                   refit_period=cfg.refit_period,
                   refit_min_samples=cfg.refit_min_samples,
                   trace_limit=cfg.trace_limit,
                   audit_period=cfg.audit_period,
                   recorder_window=cfg.recorder_window,
                   recorder_path=cfg.recorder_path,
                   alerts=cfg.alerts, alert_target=cfg.alert_target,
                   alert_windows=cfg.alert_windows,
                   prof=cfg.prof, calibration=cfg.calibration,
                   trace_clock=cfg.trace_clock)

    @classmethod
    def from_config(cls, cfg: ObsConfig) -> "Obs":
        return cls.from_env(cfg)

    # ------------------------------------------------------------- wiring
    def attach(self, ctx) -> None:
        """Install the tracer (and profiler, when armed) on a context and
        arm the refit loop.  With the profiler attached the refitter fits
        the *measured* wallclock stream — the adapt-from-measurement loop —
        instead of the analytic model echo."""
        ctx.tracer = self.tracer
        if self.prof is not None:
            self.prof.attach(ctx)
        if self.refit_period > 0:
            self.refitter = OnlineRefitter(
                ctx, period_steps=self.refit_period,
                min_samples=self.refit_min_samples, tracer=self.tracer,
                sample_source=("wallclock" if self.prof is not None
                               else None))

    # ------------------------------------------------- fleet step hooks
    def begin_step(self, step: int) -> None:
        if self.tracer.enabled:
            self.tracer.clock.set_step(step)
            self.tracer.begin("step", "fleet", "fleet", "steps", step=step)
        if self.prof is not None:
            self.prof.set_step(step)

    def end_step(self, fleet) -> None:
        if self.refitter is not None:
            self.refitter.maybe_refit(fleet.elapsed_steps)
        row = None
        if self.metrics is not None:
            row = sample_fleet(self.metrics, fleet, tracer=self.tracer)
        if self.recorder is not None and row is not None:
            self.recorder.note_metrics(row)
        if self.tracer.enabled:
            self.tracer.end("step", "fleet", "fleet", "steps")
        # auditors sweep after the step slice closes, so a violation dump
        # is a clean window (no spans left open by the abort itself)
        step = fleet.elapsed_steps
        if (self.auditor is not None and self.audit_period > 0
                and step > 0 and step % self.audit_period == 0):
            violations = self.auditor.audit(fleet)
            if violations:
                if self.recorder is not None:
                    self.recorder.dump(
                        reason="audit:" + ";".join(sorted(
                            {f"{v.auditor}/{v.rule}" for v in violations})),
                        step=step)
                raise AuditError(violations)
        if self.monitor is not None and self.metrics is not None:
            fired = self.monitor.observe(fleet, self.metrics,
                                         tracer=self.tracer)
            if fired and self.recorder is not None:
                self.recorder.dump(
                    reason="slo-burn:" + ",".join(a.cls for a in fired),
                    step=step)

    def crash_dump(self, reason: str) -> Optional[str]:
        """Postmortem dump on an unhandled fleet-loop exception; returns
        the path written, or None when no recorder is armed."""
        if self.recorder is None:
            return None
        return self.recorder.dump(reason=f"crash:{reason}")

    # ------------------------------------------------------------- output
    def write_trace(self, path: str, *, measured: bool = False) -> dict:
        """Export the Chrome trace; ``measured=True`` additionally appends
        the profiler's step-clocked ``measured`` track.  The track is
        strictly additive and opt-in — the default export is byte-identical
        whether or not a profiler ran."""
        if not self.tracer.enabled:
            raise RuntimeError("tracing was not enabled on this Obs")
        track = None
        if measured:
            if self.prof is None:
                raise RuntimeError("measured track requested but profiling "
                                   "was not enabled on this Obs")
            track = calibrate_mod.measured_track_events(self.prof.samples)
        return write_chrome_trace(self.tracer, path, measured=track)

    def write_metrics(self, path: str) -> dict:
        if self.metrics is None:
            raise RuntimeError("metrics were not enabled on this Obs")
        return self.metrics.write(path)

    def write_prof(self, path: str) -> dict:
        """Persist the measured sample file (``repro_torch.obs.analyze
        --calibration`` input)."""
        if self.prof is None:
            raise RuntimeError("profiling was not enabled on this Obs")
        return self.prof.save(path)

    def calibration_report(self) -> dict:
        """Measured-vs-modeled divergence report over the profiler samples
        collected so far (``repro_torch.obs.calibrate``)."""
        if self.prof is None:
            raise RuntimeError("profiling was not enabled on this Obs")
        return calibrate_mod.report_from_samples(self.prof.samples)

    def summary(self) -> dict:
        """Small JSON-able roll-up for benchmark emission."""
        out = {}
        if self.tracer.enabled:
            out["trace_events"] = len(self.tracer.events)
            out["trace_dropped"] = self.tracer.dropped
        if self.metrics is not None:
            out["metrics_series_rows"] = len(self.metrics.series)
        if self.refitter is not None:
            out["refits"] = len(self.refitter.history)
            out["refit_decisions_changed"] = self.refitter.decisions_changed()
            out["refit_events"] = [ev.to_json()
                                   for ev in self.refitter.history]
        if self.auditor is not None:
            out["audit"] = self.auditor.summary()
        if self.recorder is not None:
            out["recorder"] = self.recorder.summary()
        if self.monitor is not None:
            out["alerts"] = self.monitor.summary()
        if self.prof is not None:
            out["prof"] = self.prof.summary()
            if self.calibration:
                out["calibration"] = self.calibration_report()
        return out
