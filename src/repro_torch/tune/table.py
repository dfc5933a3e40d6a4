"""JSON-persistable tuning table: measured transport profiles + cutovers.

Counterpart of ``repro/tune/table.py``.

A :class:`TuningTable` is the durable artifact of a profiling run: per-path
fitted (alpha, bw) profiles and the derived direct->engine cutover points
keyed by (tier, work_items).  ``save``/``load`` round-trip through JSON so a
sweep or a profiled run (``ctx.fit_tuning_table().save(path)``) warm-starts later
sessions via ``ISHMEM_TUNING_FILE``; ``merge`` folds tables from several runs
(sample-count-weighted) so profiles accumulate across hosts/sessions.

The table is consulted by ``core.cutover.choose_path`` when armed on a
``Tuning`` (duck-typed through the ``lookup`` method — no import cycle with
``core``).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Optional, Tuple

# cutover sentinel: "never switch to the engine path" (matches core.cutover)
INF_CUTOVER = 1 << 62

# work_items key meaning "any work-group size" (engine/proxy bandwidth does
# not depend on the issuing work-group — paper Fig. 4b)
ANY_WI = 0

CutKey = Tuple[str, int]                  # (tier, work_items)
ProfKey = Tuple[str, str, int]            # (path, tier, work_items|ANY_WI)


@dataclasses.dataclass
class PathProfile:
    """Fitted t(n) = alpha + n / bw for one (path, tier[, work_items])."""
    alpha: float                          # s — effective startup latency
    bw: float                             # B/s — effective bandwidth (may be inf)
    nsamples: int = 0
    resid: float = 0.0                    # RMS residual of the fit (s)
    source: str = ""                      # sample provenance ("model",
    #                                       "wallclock", ""=pre-provenance)

    def time(self, nbytes: int) -> float:
        if not math.isfinite(self.bw) or self.bw <= 0:
            return self.alpha
        return self.alpha + nbytes / self.bw


def _merge_source(a: str, b: str) -> str:
    """Provenance of a sample-weighted profile merge: identical (or absent)
    labels pass through, mixes are recorded explicitly so ``"wallclock"``
    provenance is never silently laundered into a model label."""
    if a == b or not b:
        return a
    if not a:
        return b
    return f"{a}+{b}"


@dataclasses.dataclass
class TuningTable:
    cutovers: Dict[CutKey, int] = dataclasses.field(default_factory=dict)
    profiles: Dict[ProfKey, PathProfile] = dataclasses.field(
        default_factory=dict)
    source: str = "measured"
    version: int = 1

    # -------------------------------------------------------------- lookup
    def lookup(self, tier: str, work_items: int) -> Optional[int]:
        """Measured cutover bytes for (tier, work_items); nearest observed
        work-group size (log-space) when the exact one was not profiled.
        Returns None when the tier was never profiled (caller falls back to
        the analytic model)."""
        exact = self.cutovers.get((tier, work_items))
        if exact is not None:
            return exact
        cands = [wi for (t, wi) in self.cutovers if t == tier]
        if not cands:
            return None
        target = math.log2(max(1, work_items))
        best = min(cands, key=lambda wi: abs(math.log2(max(1, wi)) - target))
        return self.cutovers[(tier, best)]

    def profile(self, path: str, tier: str,
                work_items: int = ANY_WI) -> Optional[PathProfile]:
        p = self.profiles.get((path, tier, work_items))
        if p is None and work_items != ANY_WI:
            p = self.profiles.get((path, tier, ANY_WI))
        return p

    # --------------------------------------------------------------- merge
    def merge(self, other: "TuningTable") -> "TuningTable":
        """New table folding ``other`` into ``self``.  Profile collisions are
        combined by sample-count-weighted average; cutovers are recomputed
        from the merged profiles where both paths are present, else the entry
        with more backing samples wins (ties: self)."""
        profiles: Dict[ProfKey, PathProfile] = dict(self.profiles)
        for key, theirs in other.profiles.items():
            mine = profiles.get(key)
            if mine is None or mine.nsamples == 0:
                profiles[key] = theirs
                continue
            if theirs.nsamples == 0:
                continue
            n = mine.nsamples + theirs.nsamples
            wa, wb = mine.nsamples / n, theirs.nsamples / n
            inv_bw = (wa * (0.0 if not math.isfinite(mine.bw) else 1.0 / mine.bw)
                      + wb * (0.0 if not math.isfinite(theirs.bw)
                              else 1.0 / theirs.bw))
            profiles[key] = PathProfile(
                alpha=wa * mine.alpha + wb * theirs.alpha,
                bw=(1.0 / inv_bw) if inv_bw > 0 else float("inf"),
                nsamples=n,
                resid=max(mine.resid, theirs.resid),
                source=_merge_source(mine.source, theirs.source))
        def backing(tbl: "TuningTable", tier: str, wi: int) -> int:
            d = tbl.profiles.get(("direct", tier, wi))
            e = (tbl.profiles.get(("engine", tier, wi))
                 or tbl.profiles.get(("engine", tier, ANY_WI)))
            return (d.nsamples if d else 0) + (e.nsamples if e else 0)

        cutovers: Dict[CutKey, int] = dict(self.cutovers)
        for key, val in other.cutovers.items():
            if key not in cutovers:
                cutovers[key] = val
            elif backing(other, *key) > backing(self, *key):
                cutovers[key] = val
        # recompute from merged fits where possible
        for (tier, wi) in list(cutovers):
            d = profiles.get(("direct", tier, wi))
            e = (profiles.get(("engine", tier, wi))
                 or profiles.get(("engine", tier, ANY_WI)))
            if d is not None and e is not None:
                cutovers[(tier, wi)] = cutover_from_profiles(d, e)
        return TuningTable(cutovers=cutovers, profiles=profiles,
                           source=f"merge({self.source},{other.source})",
                           version=max(self.version, other.version))

    # ---------------------------------------------------------------- json
    def to_json(self) -> dict:
        return {
            "version": self.version,
            "source": self.source,
            "cutovers": {f"{t}/{wi}": (None if c >= INF_CUTOVER else c)
                         for (t, wi), c in sorted(self.cutovers.items())},
            "profiles": {
                f"{p}/{t}/{wi}": {
                    "alpha": prof.alpha,
                    "bw": (None if not math.isfinite(prof.bw) else prof.bw),
                    "nsamples": prof.nsamples,
                    "resid": prof.resid,
                    "source": prof.source,
                }
                for (p, t, wi), prof in sorted(self.profiles.items())
            },
        }

    @classmethod
    def from_json(cls, obj: dict) -> "TuningTable":
        cutovers: Dict[CutKey, int] = {}
        for key, val in obj.get("cutovers", {}).items():
            tier, wi = key.rsplit("/", 1)
            cutovers[(tier, int(wi))] = INF_CUTOVER if val is None else int(val)
        profiles: Dict[ProfKey, PathProfile] = {}
        for key, val in obj.get("profiles", {}).items():
            path, tier, wi = key.split("/")
            bw = val.get("bw")
            profiles[(path, tier, int(wi))] = PathProfile(
                alpha=float(val["alpha"]),
                bw=float("inf") if bw is None else float(bw),
                nsamples=int(val.get("nsamples", 0)),
                resid=float(val.get("resid", 0.0)),
                source=str(val.get("source", "")))
        return cls(cutovers=cutovers, profiles=profiles,
                   source=str(obj.get("source", "loaded")),
                   version=int(obj.get("version", 1)))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        with open(path) as f:
            return cls.from_json(json.load(f))


def cutover_from_profiles(direct: PathProfile, engine: PathProfile) -> int:
    """Crossing point of two fitted lines (same closed form as the analytic
    ``cutover.cutover_bytes``, but over *measured* alpha/bw)."""
    inv_d = 0.0 if not math.isfinite(direct.bw) else 1.0 / direct.bw
    inv_e = 0.0 if not math.isfinite(engine.bw) else 1.0 / engine.bw
    if inv_d <= inv_e:                    # direct at least as fast at all sizes
        return INF_CUTOVER
    n = (engine.alpha - direct.alpha) / (inv_d - inv_e)
    return max(0, int(n))
