"""Telemetry sink: bounded per-(op, path, tier, work_items) sample aggregation.

Counterpart of ``repro/tune/telemetry.py``.

Replaces the flat write-only ``ledger`` list that used to live on
``ShmemContext``.  Every recorded op updates

- a bounded *trace* of recent :class:`OpRecord`\\ s (back-compat: the context's
  ``ledger`` property is a view of it, so tests can still inspect the last
  recorded op), and
- an aggregate :class:`StatBucket` keyed by ``(op, path, tier, work_items)``
  holding count / byte / time totals, a log2 message-size histogram, and a
  bounded (nbytes, t_sec) sample reservoir that the estimator fits.

Memory is bounded in both dimensions: the trace drops its oldest half when it
exceeds ``max_trace``, and each bucket's reservoir decimates (keep every other
sample, double the stride) when it reaches ``max_samples`` — so long runs keep
a spread of samples across time instead of only the newest.

Provenance (``OpRecord.source``): records default to ``"model"`` — the
deterministic analytic pricing stream that existed before the measured-time
layer.  The wall-clock profiler (``repro_torch.obs.prof``) and the benchmark
``best_of(record=...)`` hook emit ``source="wallclock"`` records instead.
Each source aggregates into its OWN bucket map so measured CPU wall clock can
never contaminate the modeled comm clock (``total_time`` and the public
``buckets`` attribute remain the model stream — that invariant is what keeps
profiling-on runs bitwise-identical in every deterministic output).  Only the
model stream lands in the bounded ``trace`` (the back-compat ledger); other
sources are aggregate-only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

Key = Tuple[str, str, str, int]          # (op, path, tier, work_items)

#: provenance of the default (analytically priced) record stream
MODEL_SOURCE = "model"
#: provenance of measured wall-clock samples (profiler / best_of records)
WALLCLOCK_SOURCE = "wallclock"


@dataclasses.dataclass
class OpRecord:
    """One recorded operation (canonical definition; re-exported by
    ``core.context`` for backward compatibility)."""
    op: str
    nbytes: int
    path: str
    tier: str
    t_sec: float
    work_items: int = 1
    source: str = MODEL_SOURCE


def _log2_bucket(nbytes: int) -> int:
    return max(0, int(nbytes).bit_length() - 1) if nbytes > 0 else 0


@dataclasses.dataclass
class StatBucket:
    """Aggregate stats for one (op, path, tier, work_items) key."""
    count: int = 0
    bytes_total: int = 0
    time_total: float = 0.0
    t_min: float = float("inf")
    t_max: float = 0.0
    size_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    samples: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    max_samples: int = 256
    _stride: int = 1
    _seen: int = 0

    def add(self, nbytes: int, t_sec: float) -> None:
        self.count += 1
        self.bytes_total += nbytes
        self.time_total += t_sec
        self.t_min = min(self.t_min, t_sec)
        self.t_max = max(self.t_max, t_sec)
        b = _log2_bucket(nbytes)
        self.size_hist[b] = self.size_hist.get(b, 0) + 1
        if self._seen % self._stride == 0:
            self.samples.append((nbytes, t_sec))
            if len(self.samples) >= self.max_samples:
                self.samples = self.samples[::2]     # decimate, keep spread
                self._stride *= 2
        self._seen += 1

    def mean_time(self) -> float:
        return self.time_total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "bytes_total": self.bytes_total,
            "time_total": self.time_total,
            "t_min": self.t_min if self.count else 0.0,
            "t_max": self.t_max,
            "size_hist": {str(k): v for k, v in sorted(self.size_hist.items())},
            "samples_kept": len(self.samples),
        }


class Sink:
    """Pluggable sink interface consumed by ``ShmemContext.record``."""

    def record(self, rec: OpRecord) -> None:          # pragma: no cover
        raise NotImplementedError


class NullSink(Sink):
    """Discards everything (zero-overhead mode for production serving)."""

    def __init__(self):
        # both per-instance: callers may index the trace or iterate the
        # buckets, and a class-level dict would alias every NullSink (a
        # consumer mutating one sink's view would corrupt all of them)
        self.trace: List[OpRecord] = []
        self.buckets: Dict[Key, StatBucket] = {}

    def record(self, rec: OpRecord) -> None:
        pass

    def total_time(self) -> float:
        return 0.0

    def source_time(self, source: str = MODEL_SOURCE) -> float:
        return 0.0

    def clear(self) -> None:
        pass


class TelemetrySink(Sink):
    def __init__(self, max_trace: int = 65536,
                 max_samples_per_bucket: int = 256):
        self.max_trace = max_trace
        self.max_samples_per_bucket = max_samples_per_bucket
        self.trace: List[OpRecord] = []
        self.buckets: Dict[Key, StatBucket] = {}
        # per-provenance bucket maps; "model" aliases self.buckets so every
        # pre-provenance consumer (comm clock, tests, merge of old sinks)
        # keeps reading exactly the stream it always read
        self.sources: Dict[str, Dict[Key, StatBucket]] = {
            MODEL_SOURCE: self.buckets}

    # -------------------------------------------------------------- record
    def record(self, rec: OpRecord) -> None:
        source = getattr(rec, "source", MODEL_SOURCE) or MODEL_SOURCE
        if source == MODEL_SOURCE:
            # only the deterministic model stream feeds the ledger trace:
            # wall-clock records interleaving there would perturb every
            # "last recorded op" consumer when profiling is on
            self.trace.append(rec)
            if len(self.trace) > self.max_trace:
                # amortized drop-oldest — preferring to keep pending nbi
                # markers (rma.quiet() completes them later), but the bound
                # always wins: if pending ops alone overflow it, the oldest
                # are dropped too
                half = len(self.trace) // 2
                pending = [r for r in self.trace[:half]
                           if r.op.endswith("(pending)")]
                self.trace[:half] = pending
                if len(self.trace) > self.max_trace:
                    del self.trace[: len(self.trace) - self.max_trace]
        buckets = self.sources.get(source)
        if buckets is None:
            buckets = self.sources[source] = {}
        key = (rec.op, rec.path, rec.tier, rec.work_items)
        bucket = buckets.get(key)
        if bucket is None:
            bucket = buckets[key] = StatBucket(
                max_samples=self.max_samples_per_bucket)
        bucket.add(rec.nbytes, rec.t_sec)

    # --------------------------------------------------------------- query
    def _source_buckets(self, source: Optional[str]) -> Dict[Key, StatBucket]:
        """Bucket map for one provenance; ``None`` selects the model stream
        (the pre-provenance default, so every legacy caller is unchanged)."""
        return self.sources.get(source or MODEL_SOURCE, {})

    def total_time(self) -> float:
        """Total MODELED time over all recorded ops (stable even after the
        bounded trace has dropped old records).  Deliberately excludes
        wall-clock sources: this is the deterministic comm clock."""
        return sum(b.time_total for b in self.buckets.values())

    def total_count(self) -> int:
        return sum(b.count for b in self.buckets.values())

    def source_time(self, source: str = MODEL_SOURCE) -> float:
        """Total recorded time for ONE provenance stream."""
        return sum(b.time_total
                   for b in self._source_buckets(source).values())

    def nsamples(self, source: Optional[str] = None) -> int:
        """Retained reservoir samples for one provenance stream."""
        return sum(len(b.samples)
                   for b in self._source_buckets(source).values())

    def samples(self, *, path: str, tier: str,
                work_items: Optional[int] = None,
                op: Optional[str] = None,
                op_ok=None,
                source: Optional[str] = None) -> List[Tuple[int, float]]:
        """All retained (nbytes, t_sec) samples matching the filter.
        ``op_ok`` is an optional predicate over the op name (e.g. to keep
        collective timings out of a point-to-point fit); ``source`` selects
        a provenance stream (default: the model stream)."""
        out: List[Tuple[int, float]] = []
        for (k_op, k_path, k_tier, k_wi), b in \
                self._source_buckets(source).items():
            if k_path != path or k_tier != tier:
                continue
            if work_items is not None and k_wi != work_items:
                continue
            if op is not None and k_op != op:
                continue
            if op_ok is not None and not op_ok(k_op):
                continue
            out.extend(b.samples)
        return out

    def work_item_keys(self, *, path: str, tier: str,
                       source: Optional[str] = None) -> List[int]:
        """Distinct work-group sizes observed for (path, tier)."""
        keys = {k_wi for (_, k_path, k_tier, k_wi)
                in self._source_buckets(source)
                if k_path == path and k_tier == tier}
        return sorted(keys)

    def tiers(self, source: Optional[str] = None) -> List[str]:
        return sorted({k_tier for (_, _, k_tier, _)
                       in self._source_buckets(source)})

    # ------------------------------------------------------------ maintain
    def clear(self) -> None:
        self.trace = []
        self.buckets = {}
        self.sources = {MODEL_SOURCE: self.buckets}

    def _merge_buckets(self, mine_map: Dict[Key, StatBucket],
                       other_map: Dict[Key, StatBucket]) -> None:
        for key, b in other_map.items():
            mine = mine_map.get(key)
            if mine is None:
                mine = mine_map[key] = StatBucket(
                    max_samples=self.max_samples_per_bucket)
            mine.count += b.count
            mine.bytes_total += b.bytes_total
            mine.time_total += b.time_total
            mine.t_min = min(mine.t_min, b.t_min)
            mine.t_max = max(mine.t_max, b.t_max)
            for h, c in b.size_hist.items():
                mine.size_hist[h] = mine.size_hist.get(h, 0) + c
            # combine reservoirs under the bound WITHOUT over-dropping:
            # decimate the larger side only, so both runs stay represented
            # (concatenate-then-halve could strip one side to nothing when
            # both reservoirs arrive full — stride-2 over an interleave
            # deletes every sample of one parent)
            sa, sb = list(mine.samples), list(b.samples)
            while (len(sa) + len(sb) >= mine.max_samples
                   and (len(sa) > 1 or len(sb) > 1)):
                if len(sa) >= len(sb) and len(sa) > 1:
                    sa = sa[::2]
                else:
                    sb = sb[::2]
            mine.samples = sa + sb
            mine._stride = max(mine._stride, b._stride)
            mine._seen += b._seen

    def merge(self, other: "TelemetrySink") -> None:
        """Fold another sink's aggregates into this one, source by source
        (trace not merged)."""
        other_sources = getattr(other, "sources", None)
        if other_sources is None:                # pre-provenance sink
            other_sources = {MODEL_SOURCE: other.buckets}
        for source, other_map in other_sources.items():
            if source == MODEL_SOURCE:
                mine_map = self.buckets
            else:
                mine_map = self.sources.setdefault(source, {})
            self._merge_buckets(mine_map, other_map)

    def snapshot(self) -> dict:
        """JSON-able aggregate view (no raw trace).  Model-stream buckets
        keep the historical key format; other sources are suffixed
        ``@source``."""
        buckets = {
            f"{op}/{path}/{tier}/{wi}": b.snapshot()
            for (op, path, tier, wi), b in sorted(self.buckets.items())
        }
        for source in sorted(self.sources):
            if source == MODEL_SOURCE:
                continue
            for (op, path, tier, wi), b in sorted(
                    self.sources[source].items()):
                buckets[f"{op}/{path}/{tier}/{wi}@{source}"] = b.snapshot()
        return {
            "total_count": self.total_count(),
            "total_time": self.total_time(),
            "buckets": buckets,
        }


def replay(records: Iterable[OpRecord],
           sink: Optional[TelemetrySink] = None) -> TelemetrySink:
    """Feed an iterable of records through a (new) sink — used to rebuild
    aggregates from a saved trace."""
    sink = sink or TelemetrySink()
    for rec in records:
        sink.record(rec)
    return sink
