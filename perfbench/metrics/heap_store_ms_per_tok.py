"""Device time of the operations launched under the benchmark's
``record_function`` around ``SymmetricHeap.write`` (the pool clone and
the K1 store) in the profiled slice, per output token emitted in it."""

LAYER = "heap and pool"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "output_tok_s"


def read(obs):
    sl, n = obs.get("slice"), obs.get("slice_tokens")
    if sl is None or not n:
        return None
    s = sl.range_device_s("perfbench.heap_write")
    return 1e3 * s / n if s > 0 else None
