"""The 95th percentile of every gap between consecutive tokens of a
request that ends in the window (host clock, each token stamped after
the step that produced it has synchronised)."""
from perfbench import stats

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(obs):
    gaps = obs["gaps"]
    return 1e3 * stats.percentile(gaps, 95) if gaps else None
