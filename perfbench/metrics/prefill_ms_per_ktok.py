"""Device time of ``Engine.prefill_request`` (CUDA events around each call
in the window), per 1000 prompt tokens."""

LAYER = "engine and model"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "ttft_p50_ms"


def read(obs):
    calls = obs.get("prefill_ms_tokens")
    if not calls:
        return None
    return 1e3 * sum(ms for ms, _ in calls) / sum(S for _, S in calls)
