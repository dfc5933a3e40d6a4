"""K2's share of its roofline in the profiled slice: the larger of the
operations bound and the bytes bound of each call (the frozen flash
formula at its shapes), summed, over the ``flash_fwd`` kernels' device
time."""
from perfbench import yardstick

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "ttft_p50_ms"


def read(obs):
    sl, calls = obs.get("slice"), obs.get("flash_calls")
    if sl is None or not calls:
        return None
    t = sl.kernel_s("flash_fwd")
    if t <= 0:
        return None
    need = sum(yardstick.bound_s(yardstick.flash_work(*c)) for c in calls)
    return 100.0 * need / t
