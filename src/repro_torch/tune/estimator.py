"""Least-squares transport-profile estimator.

Counterpart of ``repro/tune/estimator.py``.

Fits the linear cost model t(n) = alpha + n / bw per transport path from
observed (nbytes, t_sec) samples in a :class:`telemetry.TelemetrySink`, and
derives *measured* cutover tables keyed by (tier, work_items) — the empirical
replacement for the closed-form-only ``cutover.cutover_bytes``.

Fitting detail: the direct path's bandwidth depends on the issuing work-group
size (paper Fig. 4a), so direct profiles are fitted per (tier, work_items);
the engine and proxy paths are work-group-independent (Fig. 4b) and pool all
samples per tier under the ``ANY_WI`` key.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.tune import telemetry as telemetry_mod
from repro_torch.tune.table import (ANY_WI, PathProfile, TuningTable,
                              cutover_from_profiles)

MIN_SAMPLES = 3          # below this a fit is too unconstrained to trust

# Collective timings scale with the team size (t ~ alpha + n*(npes-1)/bw and
# friends — core.cutover.t_collective), so pooling them with point-to-point
# samples would poison the per-op linear fit.  The profiles fitted here model
# ONE p2p transfer; collective records are excluded by op name.
COLLECTIVE_OPS = frozenset({
    "sync", "barrier", "broadcast", "fcollect", "collect", "alltoall",
    "reduce", "psum", "psum_nbi", "all_gather", "reduce_scatter", "ppermute",
    "psum_hierarchical", "device_broadcast", "device_reduce",
})


def _is_p2p(op: str) -> bool:
    if op.endswith("(pending)") or op.endswith("(done)"):
        return False              # zero-cost queue markers, not transfers
    return op.split("[")[0] not in COLLECTIVE_OPS


def fit_linear(samples: Sequence[Tuple[int, float]]) -> Optional[PathProfile]:
    """Ordinary least squares for t = alpha + n * inv_bw.

    Returns None when the samples cannot constrain a line (fewer than
    MIN_SAMPLES points or no spread in n).  A non-positive fitted slope
    (time flat or decreasing in size — pure-latency regime) degrades to
    bw = inf with alpha = mean(t).
    """
    if len(samples) < MIN_SAMPLES:
        return None
    n = float(len(samples))
    mean_x = sum(s[0] for s in samples) / n
    mean_t = sum(s[1] for s in samples) / n
    # centered normal equations (conditioning: nbytes spans ~8 decades)
    sxx = sum((s[0] - mean_x) ** 2 for s in samples)
    if sxx <= 0.0:
        return None
    sxt = sum((s[0] - mean_x) * (s[1] - mean_t) for s in samples)
    slope = sxt / sxx
    if slope <= 0.0:
        prof = PathProfile(alpha=mean_t, bw=float("inf"), nsamples=int(n))
    else:
        alpha = mean_t - slope * mean_x
        prof = PathProfile(alpha=max(0.0, alpha), bw=1.0 / slope,
                           nsamples=int(n))
    sq = sum((prof.time(x) - t) ** 2 for x, t in samples)
    prof.resid = math.sqrt(sq / n)
    return prof


def fit_profiles(sink: telemetry_mod.TelemetrySink, *,
                 min_samples: int = MIN_SAMPLES,
                 sample_source: Optional[str] = None
                 ) -> Dict[Tuple[str, str, int], PathProfile]:
    """Fit every (path, tier[, work_items]) combination with enough samples.

    ``sample_source`` selects one provenance stream from the sink (e.g.
    ``"wallclock"`` to fit only measured profiler samples); ``None`` keeps
    the historical behavior of fitting the analytic model stream.  Each
    fitted profile is stamped with the stream it came from."""
    profiles: Dict[Tuple[str, str, int], PathProfile] = {}
    label = sample_source or telemetry_mod.MODEL_SOURCE
    for tier in sink.tiers(source=sample_source):
        for wi in sink.work_item_keys(path="direct", tier=tier,
                                      source=sample_source):
            prof = fit_linear(sink.samples(path="direct", tier=tier,
                                           work_items=wi, op_ok=_is_p2p,
                                           source=sample_source))
            if prof is not None and prof.nsamples >= min_samples:
                prof.source = label
                profiles[("direct", tier, wi)] = prof
        for path in ("engine", "proxy"):
            prof = fit_linear(sink.samples(path=path, tier=tier,
                                           op_ok=_is_p2p,
                                           source=sample_source))
            if prof is not None and prof.nsamples >= min_samples:
                prof.source = label
                profiles[(path, tier, ANY_WI)] = prof
    return profiles


def derive_cutovers(profiles: Dict[Tuple[str, str, int], PathProfile]
                    ) -> Dict[Tuple[str, int], int]:
    """Measured direct->engine crossover per (tier, work_items)."""
    cutovers: Dict[Tuple[str, int], int] = {}
    for (path, tier, wi), direct in profiles.items():
        if path != "direct":
            continue
        engine = (profiles.get(("engine", tier, wi))
                  or profiles.get(("engine", tier, ANY_WI)))
        if engine is None:
            continue
        cutovers[(tier, wi)] = cutover_from_profiles(direct, engine)
    return cutovers


def build_table(sink: telemetry_mod.TelemetrySink, *,
                min_samples: int = MIN_SAMPLES,
                source: str = "measured",
                sample_source: Optional[str] = None) -> TuningTable:
    """Sink -> fitted profiles -> measured cutover table (the whole pipeline).

    ``source`` labels the table artifact; ``sample_source`` restricts the fit
    to one telemetry provenance stream (``"wallclock"`` fits only measured
    samples — the table the online refitter arms when profiling is on)."""
    profiles = fit_profiles(sink, min_samples=min_samples,
                            sample_source=sample_source)
    return TuningTable(cutovers=derive_cutovers(profiles), profiles=profiles,
                       source=source)


# ---------------------------------------------------------------------------
# Profiling sweeps — generate samples by *executing* the cost model (the
# tests use it as ground truth; measured samples come from obs.prof).
# ---------------------------------------------------------------------------

DEFAULT_SIZES = tuple(1 << b for b in range(7, 25))        # 128 B .. 16 MB
DEFAULT_WORK_ITEMS = (1, 16, 128, 1024)
DEFAULT_TIERS = ("local", "ici")


def synthetic_sweep(hw=None, *, tiers: Iterable[str] = DEFAULT_TIERS,
                    work_items: Iterable[int] = DEFAULT_WORK_ITEMS,
                    sizes: Iterable[int] = DEFAULT_SIZES,
                    noise: float = 0.0, seed: int = 0,
                    sink: Optional[telemetry_mod.TelemetrySink] = None
                    ) -> telemetry_mod.TelemetrySink:
    """Record one (path x tier x work_items x size) grid of op timings into a
    sink, timing each configuration with ``cutover.op_time`` under ``hw``.

    ``noise`` adds deterministic multiplicative jitter (+-noise, fixed seed)
    so tests can exercise the estimator's robustness to measurement scatter.
    """
    from repro_torch.core import cutover

    hw = hw or cutover.HwParams()
    sink = sink or telemetry_mod.TelemetrySink()
    rng_state = seed or 1
    wi_list = list(work_items)

    def jitter() -> float:
        nonlocal rng_state
        if noise <= 0.0:
            return 1.0
        rng_state = (1103515245 * rng_state + 12345) % (1 << 31)
        return 1.0 + noise * (2.0 * rng_state / float(1 << 31) - 1.0)

    for tier in tiers:
        for nbytes in sizes:
            for wi in wi_list:
                if tier != "dcn":
                    t = cutover.op_time(nbytes, "direct", work_items=wi,
                                        tier=tier, hw=hw) * jitter()
                    sink.record(telemetry_mod.OpRecord(
                        "sweep_put", nbytes, "direct", tier, t, wi))
            t = cutover.op_time(nbytes, "engine", tier=tier, hw=hw) * jitter()
            sink.record(telemetry_mod.OpRecord(
                "sweep_put", nbytes, "engine", tier, t, wi_list[0]))
            if tier == "dcn":
                t = cutover.op_time(nbytes, "proxy", tier=tier,
                                    hw=hw) * jitter()
                sink.record(telemetry_mod.OpRecord(
                    "sweep_put", nbytes, "proxy", tier, t, wi_list[0]))
    return sink


def agreement(table: TuningTable, hw=None, *,
              tiers: Iterable[str] = DEFAULT_TIERS,
              work_items: Iterable[int] = DEFAULT_WORK_ITEMS,
              sizes: Iterable[int] = DEFAULT_SIZES) -> float:
    """Fraction of a (nbytes x work_items x tier) grid where the learned
    table and the analytic model pick the same direct/engine path."""
    from repro_torch.core import cutover

    hw = hw or cutover.HwParams()
    armed = cutover.Tuning(table=table)
    total = hits = 0
    for tier in tiers:
        for wi in work_items:
            for nbytes in sizes:
                want = cutover.choose_path(nbytes, work_items=wi, tier=tier,
                                           hw=hw)
                got = cutover.choose_path(nbytes, work_items=wi, tier=tier,
                                          hw=hw, tuning=armed)
                hits += int(want == got)
                total += 1
    return hits / total if total else 1.0


def sweep_records(sink: telemetry_mod.TelemetrySink
                  ) -> List[telemetry_mod.OpRecord]:
    """Convenience for debugging: the sink's retained trace."""
    return list(sink.trace)
