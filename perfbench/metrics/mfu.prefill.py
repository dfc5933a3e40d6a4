"""The whole step's share of the card's bf16 peak: the frozen model FLOP
count of the work the window completed (every prefill and decoded token
whose token was emitted in it), over the window and 989 TFLOP/s."""
from perfbench import yardstick

LAYER = "the whole step"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "ttft_p50_ms"


def read(obs):
    return 100.0 * obs["model_flops"] / obs["window_s"] / \
        yardstick.PEAK_BF16_FLOPS
