"""CPU tests of the benchmark's arithmetic: traffic draws, percentiles,
rates, censored time to first token, the frozen work formulas and the
whole-name check for JAX modules."""
import json
import os
import statistics

import numpy as np
import pytest

from perfbench import arrivals, bench, stats, yardstick

HERE = os.path.dirname(os.path.abspath(__file__))


def _mix(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("mix", ["decode_backlog"])
def test_draws_repeat_for_a_seed(mix):
    m = _mix(mix)
    a, b = arrivals.Traffic(m, 2**31 + 9, 1000), \
        arrivals.Traffic(m, 2**31 + 9, 1000)
    for i in (0, 1, 17, 300):
        x, y = a.get(i), b.get(i)
        assert np.array_equal(x.tokens, y.tokens) and x.max_new == y.max_new
    c = arrivals.Traffic(m, 2**31 + 10, 1000)
    assert not np.array_equal(a.get(0).tokens, c.get(0).tokens)
    # the sizes are the seed's content-free part: the same for every seed
    assert [a.sizes(i) for i in range(64)] == [c.sizes(i) for i in range(64)]


def test_sizes_are_the_distributions_quantiles():
    m = _mix("decode_backlog")
    t = arrivals.Traffic(m, 5, 1000)
    n = arrivals.POOL
    prompts = sorted(t.sizes(i)[0] for i in range(n))
    outs = sorted(t.sizes(i)[1] for i in range(n))
    assert prompts == sorted(arrivals.prompt_sizes(m["prompt"], n).tolist())
    assert outs == sorted(arrivals.output_sizes(m["output"], n).tolist())
    assert m["prompt"]["min"] <= prompts[0] and prompts[-1] <= \
        m["prompt"]["max"]
    assert abs(statistics.median(prompts) - m["prompt"]["median"]) <= 2
    # any 32 consecutive requests hold an even spread of outputs
    for start in range(0, n, 32):
        chunk = [t.sizes(i)[1] for i in range(start, start + 32)]
        assert abs(np.mean(chunk) - np.mean(outs)) < 4


def test_residual_fill_spreads_the_remaining_work():
    a = arrivals.Arrival(0, np.zeros((1, 4), np.int32), 100)
    got = [arrivals.Traffic.residual(a, k, 4).max_new for k in range(4)]
    assert got == [12, 38, 62, 88]


def test_poisson_due_times_repeat_and_rate():
    m = {"runner": "serve", "arrivals": "poisson", "rate": 2.0,
         "prompt": {"dist": "lognormal", "median": 8, "sigma": 0.3,
                    "min": 4, "max": 16},
         "output": {"dist": "fixed", "value": 4}}
    a, b = arrivals.Traffic(m, 77, 50), arrivals.Traffic(m, 77, 50)
    due = [a.due(i) for i in range(4000)]
    assert due == [b.due(i) for i in range(4000)]
    assert due[0] == 0.0 and all(x < y for x, y in zip(due, due[1:]))
    assert abs(4000 / due[-1] - 2.0) < 0.05
    # the same arrivals for every seed; any 64 in a row near the rate
    other = arrivals.Traffic(m, 78, 50)
    assert due == [other.due(i) for i in range(4000)]
    for i in range(0, 3900, 64):
        assert abs(64 / (due[i + 64] - due[i]) - 2.0) < 0.5


def test_percentile_matches_numpy_linear():
    rng = np.random.default_rng(3)
    xs = rng.exponential(size=257).tolist()
    for q in (0, 5, 50, 95, 99, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_rate_and_gaps_and_a_stall():
    # two requests, tokens every 0.1 s, window [1, 3]
    stamps = {0: [0.5 + 0.1 * k for k in range(30)],
              1: [1.0 + 0.1 * k for k in range(21)]}
    gaps = stats.token_gaps(stamps, 1.0, 3.0)
    assert stats.tokens_in(stamps, 1.0, 3.0) == 21 + 21
    assert stats.percentile(gaps, 95) == pytest.approx(0.1)
    assert stats.rate(stats.tokens_in(stamps, 1.0, 3.0), 2.0) == 21.0
    # a 0.5 s stall in request 1 moves the tail and the rate
    stalled = {0: stamps[0], 1: [t + (0.5 if t > 2.05 else 0.0)
                                 for t in stamps[1]]}
    g2 = stats.token_gaps(stalled, 1.0, 3.0)
    assert max(g2) == pytest.approx(0.6)
    assert stats.tokens_in(stalled, 1.0, 3.0) < 42


def test_ttft_counts_a_request_with_no_token_at_its_age():
    due = {0: 1.0, 1: 2.0, 2: 2.5, 3: 0.5}
    first = {0: 1.4, 1: 2.2}
    got = stats.ttfts(due, first, 1.0, 4.0)
    # request 3 was due before the window; 2 never got a token: age 1.5
    assert sorted(got) == pytest.approx([0.2, 0.4, 1.5])
    # a stall that delays every first token moves the median
    late = stats.ttfts(due, {0: 3.9, 1: 3.9}, 1.0, 4.0)
    assert stats.percentile(late, 50) > stats.percentile(got, 50)


@pytest.mark.parametrize("work, bound_ms", [
    # PERF.md section 6's bounds at its shapes
    (yardstick.flash_work(1, 512, 32, 8, 128, 2), 0.00313),
    (yardstick.flash_work(1, 4096, 32, 8, 128, 2), 0.1390),
    (yardstick.gather_work(99, 76, 1_179_648 * 2), 0.1232),
    (yardstick.reduce_scatter_work(2, 2 * 2 * 448_266_240, 2), 1.6057),
    (yardstick.reduce_scatter_work(4, 4 * 4 * 97_239_040, 2), 1.161),
])
def test_frozen_formulas_give_the_kernel_table_bounds(work, bound_ms):
    assert 1e3 * yardstick.bound_s(work) == pytest.approx(bound_ms,
                                                          rel=1e-3)


def test_model_flops_count_parameters_and_context():
    a = {"family": "dense", "num_layers": 2, "d_model": 8, "num_heads": 2,
         "num_kv_heads": 1, "head_dim": 4, "d_ff": 16, "mlp_type": "swiglu",
         "vocab_size": 10}
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8
    body = 2 * 2 * (attn + 3 * 8 * 16)
    assert yardstick.decode_flops(a, 5) == body + 2 * 4 * 2 * 4 * 5 + 160
    assert yardstick.prefill_flops(a, 3) == \
        3 * body + 2 * 4 * 2 * 4 * 6 + 160
    assert yardstick.train_flops(a, 3, 2) == \
        3 * 2 * (3 * (body + 160) + 2 * 4 * 2 * 4 * 6)


@pytest.mark.parametrize("names, found", [
    (["repro_torch", "repro_torch.core", "torch", "jaxtyping"], []),
    (["reprox", "jax_utils", "flaxen"], []),
    (["repro.core.heap", "torch"], ["repro"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert bench.forbidden_modules(names) == found


def test_judge_holds_each_number_to_its_limit():
    ok = {"gap": {"value": 0.1, "limit": 0.2},
          "n": {"value": 300, "limit": 128, "at_least": True}}
    assert bench.judge(ok)
    assert not bench.judge({**ok, "gap": {"value": 0.3, "limit": 0.2}})
    assert not bench.judge({**ok, "n": {"value": 3, "limit": 128,
                                        "at_least": True}})
    assert not bench.judge({**ok, "gap": {"value": None, "limit": 0.2}})
    assert not bench.judge({**ok, "gap": {"value": 0.1, "limit": None}})
