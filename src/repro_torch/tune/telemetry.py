"""Telemetry sink: bounded per-(op, path, tier, work_items) aggregation.

Counterpart of ``repro/tune/telemetry.py`` for the record stream the serving
path produces (the modeled "comm clock").  Every recorded op appends an
:class:`OpRecord` to a bounded trace (the context's ``ledger`` view) and
updates a :class:`StatBucket` keyed by ``(op, path, tier, work_items)``
with the count, bytes and modeled seconds.  The size histograms and sample
reservoirs the estimator fits, measured wall-clock sources and merging come
with the tuning knobs (ROADMAP queue 1, item 5c).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

Key = Tuple[str, str, str, int]          # (op, path, tier, work_items)


@dataclasses.dataclass
class OpRecord:
    """One recorded operation."""
    op: str
    nbytes: int
    path: str
    tier: str
    t_sec: float
    work_items: int = 1


@dataclasses.dataclass
class StatBucket:
    """Aggregate stats for one key: what the modeled comm clock sums."""
    count: int = 0
    bytes_total: int = 0
    time_total: float = 0.0

    def add(self, nbytes: int, t_sec: float) -> None:
        self.count += 1
        self.bytes_total += nbytes
        self.time_total += t_sec


class TelemetrySink:
    def __init__(self, max_trace: int = 65536):
        self.max_trace = max_trace
        self.trace: List[OpRecord] = []
        self.buckets: Dict[Key, StatBucket] = {}

    def record(self, rec: OpRecord) -> None:
        self.trace.append(rec)
        if len(self.trace) > self.max_trace:
            # amortised drop-oldest, keeping pending nbi markers (quiet()
            # retags them later) unless they alone overflow the bound
            half = len(self.trace) // 2
            pending = [r for r in self.trace[:half]
                       if r.op.endswith("(pending)")]
            self.trace[:half] = pending
            if len(self.trace) > self.max_trace:
                del self.trace[: len(self.trace) - self.max_trace]
        key = (rec.op, rec.path, rec.tier, rec.work_items)
        bucket = self.buckets.get(key)
        if bucket is None:
            bucket = self.buckets[key] = StatBucket()
        bucket.add(rec.nbytes, rec.t_sec)

    def total_time(self) -> float:
        """Total modeled seconds over every recorded op."""
        return sum(b.time_total for b in self.buckets.values())

