"""Median device time of one decode PE's step (CUDA events around each
``models.model.decode_step`` call in the window)."""
from perfbench import stats

LAYER = "engine and model"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "output_tok_s"


def read(obs):
    ms = obs.get("decode_step_ms")
    return stats.percentile(ms, 50) if ms else None
