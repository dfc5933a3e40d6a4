"""Every output token emitted in the window, over the window (host
clock): the rate a user of a full batch of conversations is served at."""
from perfbench import stats

UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(obs):
    return stats.rate(obs["tokens"], obs["window_s"])
