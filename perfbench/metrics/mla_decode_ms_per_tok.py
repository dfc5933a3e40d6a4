"""Device milliseconds of the decode step's latent attention a token
emitted in the profiled slice: the device-side spans of the port's
``decode.mla`` ``record_function`` ranges (norm, projections, rotary,
cache row, absorbed attention, output projection of every layer), over
the slice's tokens."""
LAYER = "engine and model"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "output_tok_s"


def read(obs):
    sl, n = obs.get("slice"), obs.get("slice_tokens")
    if sl is None or not n:
        return None
    s = sl.range_device_s("decode.mla")
    return 1e3 * s / n if s > 0 else None
