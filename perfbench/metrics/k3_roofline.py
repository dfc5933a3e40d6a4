"""K3's share of its roofline in the profiled slice: the least time of the
calls' bytes (the frozen gather formula at each call's table and rows)
at HBM bandwidth, over ``paged_gather_kernel``'s device time."""
from perfbench import yardstick

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "output_tok_s"


def read(obs):
    sl, calls = obs.get("slice"), obs.get("gather_calls")
    if sl is None or not calls:
        return None
    t = sl.kernel_s("paged_gather_kernel")
    if t <= 0:
        return None
    need = sum(yardstick.bound_s(yardstick.gather_work(*c)) for c in calls)
    return 100.0 * need / t
