"""The share of the profiled slice in which no kernel, memcpy or memset
ran on the card (the union of their intervals in the profiler's trace,
over the slice's wall time, both from the same run)."""

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "ttft_p50_ms"


def read(obs):
    sl = obs.get("slice")
    if sl is None or sl.wall_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.wall_s)
