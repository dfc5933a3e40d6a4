"""The median, over every request due in the window, of the time from its
due time to its first token; a request with no first token by the close
counts at its age then, so that a stall shows (host clock)."""
from perfbench import stats

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(obs):
    t = obs["ttfts"]
    return 1e3 * stats.percentile(t, 50) if t else None
