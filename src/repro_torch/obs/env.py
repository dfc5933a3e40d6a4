"""``ISHMEM_OBS_*`` environment surface — observability's init-time knobs.

Counterpart of ``repro/obs/env.py``.

Mirrors the ``ISHMEM_*`` convention from ``repro_torch.tune.env``: everything
defaults to *off* (Null tracer, no metrics, no re-fit), so an unconfigured
run is bitwise-identical to one built before this subsystem existed.

===============================  ============================================
``ISHMEM_OBS_TRACE``             ``1`` (collect in memory) or a path —
                                 enable the span tracer; a path also writes
                                 the Chrome-trace JSON there at shutdown
``ISHMEM_OBS_METRICS``           ``1`` or a path — per-fleet-step metrics
                                 registry (counters/gauges/histograms)
``ISHMEM_OBS_REFIT``             re-fit period in fleet steps (``0``/unset =
                                 online re-fit off)
``ISHMEM_OBS_REFIT_MIN_SAMPLES`` minimum retained telemetry samples before a
                                 due re-fit runs (default 64)
``ISHMEM_OBS_TRACE_LIMIT``       tracer event-buffer bound (default 2^20);
                                 accepts K/M suffixes
``ISHMEM_OBS_AUDIT``             invariant-audit period in fleet steps
                                 (``0``/unset = auditors off); each audit
                                 runs every ``repro_torch.obs.audit`` family and
                                 raises on any violation
``ISHMEM_OBS_RECORDER``          flight-recorder window in fleet steps
                                 (``0``/unset = off); postmortem dumps of
                                 the last-window spans on crash / audit
                                 violation / SLO alert
``ISHMEM_OBS_RECORDER_PATH``     postmortem dump path (default
                                 ``postmortem_trace.json``)
``ISHMEM_OBS_ALERTS``            ``1`` — SLO burn-rate monitor (implies
                                 metrics sampling)
``ISHMEM_OBS_ALERT_TARGET``      SLO target the error budget derives from
                                 (default 0.9)
``ISHMEM_OBS_ALERT_WINDOWS``     burn windows as ``steps:threshold`` pairs,
                                 e.g. ``8:6,32:3`` (the default)
``ISHMEM_OBS_PROF``              ``1`` (collect in memory) or a path —
                                 wall-clock profiler on serve hot paths; a
                                 path also writes the measured-sample JSON
                                 there at shutdown.  Deterministic outputs
                                 stay bitwise-identical either way
``ISHMEM_OBS_CALIBRATION``       ``1`` or a path — measured-vs-modeled
                                 divergence report at shutdown (implies
                                 ``PROF``); a path writes the report JSON
===============================  ============================================

CLI flags on ``launch/serve.py`` (``--trace``/``--metrics``/``--refit``/
``--audit``/``--recorder``/``--alerts``/``--profile``/``--calibration``)
override the environment.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

from repro_torch.tune.env import parse_bytes

PREFIX = "ISHMEM_OBS_"


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    trace: bool = False
    trace_path: Optional[str] = None
    metrics: bool = False
    metrics_path: Optional[str] = None
    refit_period: int = 0               # fleet steps; 0 = off
    refit_min_samples: int = 64
    trace_limit: int = 1 << 20
    audit_period: int = 0               # fleet steps; 0 = off
    recorder_window: int = 0            # fleet steps; 0 = off
    recorder_path: str = "postmortem_trace.json"
    alerts: bool = False
    alert_target: float = 0.9
    alert_windows: str = "8:6,32:3"     # parse_windows format
    prof: bool = False
    prof_path: Optional[str] = None
    calibration: bool = False
    calibration_path: Optional[str] = None

    @property
    def enabled(self) -> bool:
        return (self.trace or self.metrics or self.refit_period > 0
                or self.audit_period > 0 or self.recorder_window > 0
                or self.alerts or self.prof or self.calibration)


def _flag_or_path(val: Optional[str]) -> tuple:
    """``None``/``0`` -> (False, None); ``1`` -> (True, None);
    anything else -> (True, path)."""
    if val is None:
        return False, None
    s = val.strip()
    if s in ("0", "", "off", "false", "no"):
        return False, None
    if s in ("1", "on", "true", "yes"):
        return True, None
    return True, s


def load_obs_env(environ: Optional[Mapping[str, str]] = None) -> ObsConfig:
    env = os.environ if environ is None else environ

    def get(name: str) -> Optional[str]:
        val = env.get(PREFIX + name)
        return val if val not in (None, "") else None

    trace, trace_path = _flag_or_path(get("TRACE"))
    metrics, metrics_path = _flag_or_path(get("METRICS"))
    refit = get("REFIT")
    try:
        refit_period = int(refit) if refit is not None else 0
    except ValueError:
        raise ValueError(f"ISHMEM_OBS_REFIT: expected a step count, "
                         f"got {refit!r}") from None
    if refit_period < 0:
        raise ValueError("ISHMEM_OBS_REFIT must be >= 0")
    min_samples = get("REFIT_MIN_SAMPLES")
    try:
        refit_min = int(min_samples) if min_samples is not None else 64
    except ValueError:
        raise ValueError(f"ISHMEM_OBS_REFIT_MIN_SAMPLES: expected an "
                         f"integer, got {min_samples!r}") from None
    limit = get("TRACE_LIMIT")
    try:
        trace_limit = parse_bytes(limit) if limit is not None else 1 << 20
    except ValueError:
        raise ValueError(f"ISHMEM_OBS_TRACE_LIMIT: expected a count like "
                         f"65536/1M, got {limit!r}") from None

    def get_steps(name: str) -> int:
        raw = get(name)
        try:
            val = int(raw) if raw is not None else 0
        except ValueError:
            raise ValueError(f"{PREFIX}{name}: expected a step count, "
                             f"got {raw!r}") from None
        if val < 0:
            raise ValueError(f"{PREFIX}{name} must be >= 0")
        return val

    audit_period = get_steps("AUDIT")
    recorder_window = get_steps("RECORDER")
    recorder_path = get("RECORDER_PATH") or "postmortem_trace.json"
    alerts, _ = _flag_or_path(get("ALERTS"))
    raw_target = get("ALERT_TARGET")
    try:
        alert_target = float(raw_target) if raw_target is not None else 0.9
    except ValueError:
        raise ValueError(f"ISHMEM_OBS_ALERT_TARGET: expected a float in "
                         f"(0, 1), got {raw_target!r}") from None
    alert_windows = get("ALERT_WINDOWS") or "8:6,32:3"
    from repro_torch.obs.alerts import parse_windows
    parse_windows(alert_windows)        # fail fast on a malformed spec
    prof, prof_path = _flag_or_path(get("PROF"))
    calibration, calibration_path = _flag_or_path(get("CALIBRATION"))
    if calibration:
        prof = True                     # a report needs measured samples
    return ObsConfig(trace=trace, trace_path=trace_path,
                     metrics=metrics, metrics_path=metrics_path,
                     refit_period=refit_period,
                     refit_min_samples=refit_min,
                     trace_limit=trace_limit,
                     audit_period=audit_period,
                     recorder_window=recorder_window,
                     recorder_path=recorder_path,
                     alerts=alerts,
                     alert_target=alert_target,
                     alert_windows=alert_windows,
                     prof=prof, prof_path=prof_path,
                     calibration=calibration,
                     calibration_path=calibration_path)
