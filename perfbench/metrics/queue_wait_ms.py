"""Median time from a request's due time to the start of the scheduler
step that prefilled it (``Request.prefill_step`` mapped to the harness's
host stamp of that step), over the requests due in the window."""
from perfbench import stats

LAYER = "scheduler"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_counter", "ttft_p50_ms"


def read(obs):
    w = obs.get("queue_wait_s")
    return 1e3 * stats.percentile(w, 50) if w else None
