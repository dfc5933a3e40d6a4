"""Device milliseconds of the decode step's mixture of experts a token
emitted in the profiled slice: the device-side spans of the port's
``decode.moe`` ``record_function`` ranges (norm, router, dispatch, routed
and shared experts, combine of every MoE layer), over the slice's
tokens."""
LAYER = "engine and model"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "output_tok_s"


def read(obs):
    sl, n = obs.get("slice"), obs.get("slice_tokens")
    if sl is None or not n:
        return None
    s = sl.range_device_s("decode.moe")
    return 1e3 * s / n if s > 0 else None
