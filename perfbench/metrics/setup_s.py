"""Everything before the window opens, from the start of the process:
imports, weights drawn on the card, the scheduler and its pool, kernel
builds where the checkout has none, and the warm-up (host clock)."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(obs):
    return obs["setup_s"]
