"""Deterministic multi-window SLO burn-rate alerting over the metrics series.

Counterpart of ``repro/obs/alerts.py``.

Classic SRE burn-rate alerting (fast window catches cliffs, slow window
confirms they are sustained), recast onto the fleet's step clock so alerts
are bit-reproducible for a fixed seed: no wall time, no sampling jitter —
the monitor reads the cumulative per-class SLO ledger that
``metrics.sample_fleet`` writes every step (``class.{name}.bad`` /
``class.{name}.terminal``) and nothing else.

For an SLO target ``t`` (e.g. 0.9 ⇒ a 10% error budget), the burn rate over
a trailing window is::

    burn = (Δbad / Δterminal) / (1 - t)

— burn 1.0 spends the budget exactly; burn 6 over the fast window plus
burn 3 over the slow window (the defaults) is the "page now" posture.  An
alert fires only when **every** window exceeds its threshold (the fast
window alone is noise; the slow window alone is too late), re-arms only
after the class drops back under (hysteresis via the active set), and skips
windows with fewer than ``min_terminal`` verdicts (1-of-1 is not a signal).

Every alert carries a drill-down: the top offending requests of that class
by deadline overshoot — shed outright or admitted past their TTFD deadline
inside the slow window — each with its critical-path segment breakdown
(``obs.critical``) when a tracer is recording, so the alert names not just
*that* the budget is burning but *where the steps went*.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import critical as critical_mod
from repro_torch.obs import export as export_mod
from repro_torch.obs.tracer import STEP_QUANTUM

__all__ = ["BurnWindow", "DEFAULT_WINDOWS", "Alert", "BurnRateMonitor"]


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One trailing window: ``steps`` long, fires past ``threshold``."""
    steps: int
    threshold: float


#: fast window catches cliffs, slow window proves they are sustained
DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (BurnWindow(8, 6.0),
                                           BurnWindow(32, 3.0))


def parse_windows(spec: str) -> Tuple[BurnWindow, ...]:
    """``"8:6,32:3"`` → windows; the ``ISHMEM_OBS_ALERT_WINDOWS`` format."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        steps, thr = part.split(":")
        out.append(BurnWindow(int(steps), float(thr)))
    if not out:
        raise ValueError(f"no windows in spec {spec!r}")
    return tuple(out)


@dataclasses.dataclass
class Alert:
    """One fired burn-rate alert, with its evidence."""
    cls: str                      # SLO class name
    step: int                     # fleet step it fired at
    target: float                 # SLO target the budget derives from
    burn: Dict[int, float]        # window steps -> measured burn rate
    offenders: List[dict]         # drill-down, worst overshoot first

    def to_json(self) -> dict:
        return {"cls": self.cls, "step": self.step, "target": self.target,
                "burn": {str(k): v for k, v in sorted(self.burn.items())},
                "offenders": self.offenders}


class BurnRateMonitor:
    """Stateful per-class burn-rate watcher; drive with :meth:`observe`
    once per fleet step (after ``sample_fleet``).

    ``fired`` accumulates every alert ever raised; :meth:`observe` returns
    only the *newly* fired ones (the hysteresis edge), so a driver can dump
    a flight-recorder postmortem exactly once per incident.
    """

    def __init__(self, *, target: float = 0.9,
                 windows: Tuple[BurnWindow, ...] = DEFAULT_WINDOWS,
                 top_n: int = 3, min_terminal: int = 4):
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), got {target}")
        self.target = target
        self.windows = tuple(sorted(windows, key=lambda w: w.steps))
        self.top_n = top_n
        self.min_terminal = min_terminal
        self.active: set = set()          # class names currently firing
        self.fired: List[Alert] = []
        self.observations = 0

    # ------------------------------------------------------------ mechanics
    def _burn(self, rows: List[dict], cls: str,
              w: BurnWindow) -> Optional[float]:
        """Burn rate for one class over one trailing window, or None when
        the window saw fewer than ``min_terminal`` verdicts."""
        cur = rows[-1]
        base = rows[-1 - w.steps] if len(rows) > w.steps else {}
        d_bad = (cur.get(f"class.{cls}.bad", 0)
                 - base.get(f"class.{cls}.bad", 0))
        d_term = (cur.get(f"class.{cls}.terminal", 0)
                  - base.get(f"class.{cls}.terminal", 0))
        if d_term < self.min_terminal:
            return None
        return (d_bad / d_term) / (1.0 - self.target)

    def _drilldown(self, fleet, cls: str, window_steps: int,
                   tracer=None) -> List[dict]:
        """The requests actually burning the budget: this class's terminal
        SLO violations inside the window, worst deadline overshoot first."""
        from repro_torch.serve.frontend import slo as slo_mod
        from repro_torch.serve.scheduler import FINISHED, SHED

        step = fleet.elapsed_steps
        paths = None
        if tracer is not None and getattr(tracer, "enabled", False):
            paths = critical_mod.fleet_paths(
                export_mod.request_chains(tracer))
        offenders = []
        for pod in fleet.pods:
            for req in pod.sched.requests.values():
                sc = slo_mod.resolve(req.slo, fleet.classes)
                if sc.name != cls or req.finish_step < step - window_steps:
                    continue
                if req.state == SHED:
                    rec = {"rid": req.rid, "pod": pod.name,
                           "outcome": "shed",
                           "waited_steps": req.finish_step
                           - req.arrival_step,
                           "deadline_steps": sc.ttfd_deadline,
                           # a shed never produced a token: the whole
                           # deadline (plus the wait) is forfeit
                           "overshoot_steps": (req.finish_step
                                               - req.arrival_step)
                           + sc.ttfd_deadline}
                elif req.state == FINISHED:
                    ttfd = req.admit_step - req.arrival_step
                    if ttfd <= sc.ttfd_deadline:
                        continue
                    rec = {"rid": req.rid, "pod": pod.name,
                           "outcome": "late",
                           "ttfd_steps": ttfd,
                           "deadline_steps": sc.ttfd_deadline,
                           "overshoot_steps": ttfd - sc.ttfd_deadline}
                else:
                    continue
                if paths is not None and req.rid in paths:
                    p = paths[req.rid]
                    rec["segments_steps"] = {
                        s: p["segments"][s] / STEP_QUANTUM
                        for s in critical_mod.SEGMENTS
                        if p["segments"][s] > 0}
                    rec["preemptions"] = p["preemptions"]
                offenders.append(rec)
        offenders.sort(key=lambda r: (-r["overshoot_steps"], r["rid"]))
        return offenders[:self.top_n]

    # -------------------------------------------------------------- driving
    def observe(self, fleet, reg, *, tracer=None) -> List[Alert]:
        """Check every class against every window; returns alerts newly
        fired this step (empty while an incident stays active)."""
        self.observations += 1
        rows = reg.series
        if not rows:
            return []
        cur = rows[-1]
        classes = sorted({k.split(".")[1] for k in cur
                          if k.startswith("class.")
                          and k.endswith(".terminal")})
        new: List[Alert] = []
        for cls in classes:
            burns = {w.steps: self._burn(rows, cls, w)
                     for w in self.windows}
            firing = all(
                burns[w.steps] is not None
                and burns[w.steps] > w.threshold
                for w in self.windows)
            if firing and cls not in self.active:
                self.active.add(cls)
                alert = Alert(
                    cls=cls, step=fleet.elapsed_steps, target=self.target,
                    burn={k: v for k, v in burns.items() if v is not None},
                    offenders=self._drilldown(
                        fleet, cls, self.windows[-1].steps, tracer=tracer))
                self.fired.append(alert)
                new.append(alert)
            elif not firing and cls in self.active:
                self.active.discard(cls)          # re-arm (hysteresis edge)
        return new

    def summary(self) -> dict:
        return {"target": self.target,
                "windows": [[w.steps, w.threshold] for w in self.windows],
                "observations": self.observations,
                "alerts": [a.to_json() for a in self.fired],
                "active": sorted(self.active)}
