"""Median wall time from a request's prefill end to its admission into a
decode slot (synchronised host stamps after ``Engine.prefill_request``
and after the ``try_admit`` that admitted it): staging, the KV migration
and the admission wait."""
from perfbench import stats

LAYER = "migration"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "ttft_p50_ms"


def read(obs):
    m = obs.get("migrate_s")
    return 1e3 * stats.percentile(m, 50) if m else None
