"""DeepSeek-V2-Lite in the port (latent attention, YaRN, dropless
DeepSeekMoE with shared experts), which the JAX package does not have: it
is held to the benchmark's plain float32 reference
(``perfbench/reference/mla_moe.py``) at a reduced size.

- Served disaggregated through the normal path (prefill PEs, migration of
  the paged latent rows, decode through K3's assembly), the logits at
  every served position agree with the reference's full forward pass over
  prompt and served tokens within 1e-4: float32 throughout, so the gap is
  rounding in another order of sums (the absorbed decode, the f32 angle
  products) on logits of order 1-5, while a position off by one, a row
  dropped or an expert left out moves them by 1e-1 or more.
- A token's MoE output is the same alone and in a batch whose routing
  sends more tokens to one expert than capacity dispatch has room for,
  and equals the reference's per-token experts.
- YaRN's inverse frequencies and the softmax scale against values worked
  by hand from the published formulas; the layer kinds, parameter count
  and cache row of the published configuration; qwen3-4b's paged layout
  as it was.
- The layers' spans and ``moe`` counter on a wall-clocked tracer, the
  ranges under a recording profiler, and nothing where neither records.
"""
import collections
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from perfbench import weights
from perfbench.reference import mla_moe as ref
from repro_torch.configs import base
from repro_torch.core import context
from repro_torch.models import attention, kvcache, layers, model, moe
from repro_torch.obs import layerspans
from repro_torch.obs.layerspans import LayerSpans
from repro_torch.obs.tracer import SpanTracer, WallClock
from repro_torch.serve import kvpool
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.kvxfer import KVMigrator
from repro_torch.serve.scheduler import DisaggScheduler

from _torch_threads import one_intra_op_thread  # noqa: F401

SEED = 2**31 + 33
TOL = 1e-4          # float32 logits of order 1-5: rounding alone
MAXLEN = 40


def _cfg():
    return base.reduced(base.get_config("deepseek-v2-lite"))


@pytest.fixture(scope="module")
def params():
    return weights.make(_cfg(), SEED, "cpu")


class _Recording(Engine):
    """The engine, keeping each prefill's logits by its request's tokens
    and the last decode step's logits."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.prefill_logits = {}
        self.last = None

    def prefill_request(self, request, *a, **kw):
        out = super().prefill_request(request, *a, **kw)
        self.prefill_logits[id(request["tokens"])] = out[1][0]
        return out

    def _sample(self, logits, gen, temperature):
        self.last = logits
        return super()._sample(logits, gen, temperature)


class _Sched(DisaggScheduler):
    """The scheduler, keeping every served position's logits by request."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.logits = collections.defaultdict(list)

    def _decode(self, pe, bank, gen):
        who, active = list(self.slot_req[pe]), bank.active.copy()
        out = super()._decode(pe, bank, gen)
        for s, rid in enumerate(who):
            if rid is not None and active[s]:
                self.logits[rid].append(self.engine.last[s])
        return out


def _serve(params, tracer=None, n=4, new=6):
    cfg = _cfg()
    ctx, heap = context.init(npes=4, node_size=4, device="cpu")
    if tracer is not None:
        ctx.tracer = tracer
    eng = _Recording(cfg, params, max_len=MAXLEN, device="cpu")
    pool = KVPool.create(heap, cfg, MAXLEN, num_blocks=48, max_slots=2,
                         block_tokens=4)
    sched = _Sched(ctx, heap, eng, pool, KVMigrator(ctx, pool),
                   prefill_pes=[0, 1], decode_pes=[2, 3], num_slots=2,
                   scfg=ServeConfig(max_new_tokens=new))
    rng = np.random.default_rng(5)
    for i in range(n):
        sched.submit({"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(1, 9 + 5 * i))).long()})
    sched.run()
    return sched


def test_prefill_then_paged_decode_match_the_reference(params):
    cfg = _cfg()
    sched = _serve(params)
    assert sched.pool.layout.paged and all(
        pl.key == "ckv" for pl in sched.pool.layout.paged)
    arch = dataclasses.asdict(cfg)
    checked = 0
    for rid, req in sched.requests.items():
        prompt = req.batch["tokens"][0]
        S, served = prompt.shape[0], req.out
        assert len(served) == 6
        got = [sched.engine.prefill_logits[id(req.batch["tokens"])]] + \
            sched.logits[rid][:len(served) - 1]
        seq = torch.cat([prompt, torch.tensor(served[:-1])])
        want = ref.logits(params, arch, seq,
                          torch.arange(S - 1, S - 1 + len(served)))
        for j, (g, w) in enumerate(zip(got, want)):
            assert (g - w).abs().max() <= TOL, (rid, j)
            assert int(g.argmax()) == served[j]
            checked += 1
    assert checked == 24


def _overloading_batch(T, d, gen):
    """T tokens that all share one large component along the first axis,
    so a router column aligned with it sends every token to one expert."""
    x = torch.randn(T, d, generator=gen) * 0.1
    x[:, 0] = 3.0
    return x


@pytest.mark.parametrize("T", [40, 80])
def test_a_token_gets_the_same_alone_and_in_an_overloaded_batch(T):
    """40 tokens stay under ``DROPLESS_STATIC_TOKENS`` (every expert holds
    T rows), 80 above it (as many rows as the busiest expert).  Capacity
    dispatch has room for 32 and 56 of them at the busiest expert."""
    cfg = _cfg()
    gen = torch.Generator().manual_seed(11)
    p = moe.init_moe(gen, cfg, torch.float32, reps=1)
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
    p["router"][0, 0] = 10.0                 # expert 0 takes every token
    x = _overloading_batch(T, cfg.d_model, gen)
    seen = {}
    counter = types.SimpleNamespace(
        counting=True,
        routing=lambda **c: seen.update(moe.routing_counts(**c)))
    with layerspans.use(counter):
        y, _ = moe.moe_ffn_dropless(p, x, cfg)
    assert seen == {"tokens": T, "max_per_expert": T,
                    "experts_touched": seen["experts_touched"],
                    "dropped": 0}
    assert moe.capacity(cfg, T) < T
    for i in (0, T // 2, T - 1):
        alone, _ = moe.moe_ffn_dropless(p, x[i:i + 1], cfg)
        torch.testing.assert_close(alone[0], y[i], rtol=1e-5, atol=1e-6)
    want = ref.moe(p, x, dataclasses.asdict(cfg), lambda t: t.float())
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    # capacity dispatch drops the tokens past its room at expert 0
    capped, _ = moe.moe_ffn(p, x, cfg)
    assert not torch.allclose(capped[-1], y[-1], atol=1e-3)


def test_route_keeps_the_gates_unless_told_to_renormalise():
    cfg = _cfg()
    p = {"router": torch.tensor([[0.0, 1.0, 2.0, 2.0]])}
    x = torch.ones(1, 1)
    probs, gate, idx = moe.route(p, x, cfg)
    e = torch.exp(torch.tensor([0.0, 1.0, 2.0, 2.0]))
    assert idx.tolist() == [[2, 3]]           # the tie to the lower index
    torch.testing.assert_close(gate[0], (e / e.sum())[2:])
    _, renorm, _ = moe.route(p, x, dataclasses.replace(
        cfg, norm_topk_prob=True))
    torch.testing.assert_close(renorm[0], torch.tensor([0.5, 0.5]))


def test_yarn_frequencies_and_softmax_scale_by_hand():
    """DeepSeek-V2-Lite: dim 64, base 1e4, factor 40 over an original
    4096, beta 32 / 1.  The correction dims are 64 ln(4096 / (2 pi b)) /
    (2 ln 1e4): 10.47 for b = 32 and 22.51 for b = 1, so the ramp runs
    from 10 (floor) to 23 (ceil): dims below 10 keep 1e4^(-2i/64), dims
    from 23 take it over 40, dim 16 mixes them 7/13 : 6/13."""
    cfg = base.get_config("deepseek-v2-lite")
    inv = layers.yarn_inv_freq(cfg).double()

    def extra(i):
        return 10000.0 ** (-2 * i / 64)

    for i, want in ((0, 1.0), (9, extra(9)), (10, extra(10)),
                    (16, extra(16) * 7 / 13 + extra(16) / 40 * 6 / 13),
                    (23, extra(23) / 40), (31, extra(31) / 40)):
        assert inv[i].item() == pytest.approx(want, rel=2e-7), i
    # mscale(40, 0.707) = 0.1 * 0.707 * ln 40 + 1 = 1.2608037...
    assert layers.yarn_mscale(40.0, 0.707) == pytest.approx(
        1.2608037774, rel=1e-10)
    # 192^-0.5 * 1.2608037774^2
    assert attention.mla_softmax_scale(cfg) == pytest.approx(
        0.1147213868, rel=1e-9)
    assert ref.softmax_scale(dataclasses.asdict(cfg)) == \
        attention.mla_softmax_scale(cfg)
    torch.testing.assert_close(inv, ref.yarn_inv_freq(
        dataclasses.asdict(cfg)), rtol=2e-7, atol=0)


def test_rotary_turns_the_interleaved_pairs():
    """The port's rotary (pairs gathered into half-split order) gives the
    same dot products as the reference's (pairs turned in place)."""
    cfg = _cfg()
    gen = torch.Generator().manual_seed(3)
    q, k = torch.randn(2, 7, 1, cfg.qk_rope_head_dim, generator=gen)
    pos = torch.arange(7)
    inv = layers.yarn_inv_freq(cfg)
    qp, kp = (layers.apply_rope_interleaved(t, pos, inv) for t in (q, k))
    a = dataclasses.asdict(cfg)
    qr, kr = ref.rotate(q, a), ref.rotate(k, a)
    # position 0 turns nothing: the pairs' halves are only gathered
    half = cfg.qk_rope_head_dim // 2
    torch.testing.assert_close(qp[0], q[0].unflatten(-1, (half, 2))
                               .transpose(-1, -2).flatten(-2))
    torch.testing.assert_close(qp @ kp.transpose(0, 1).mT,
                               qr @ kr.transpose(0, 1).mT,
                               rtol=1e-5, atol=1e-5)


def test_published_configuration_shapes():
    cfg = base.get_config("deepseek-v2-lite")
    assert base.get_config("deepseek_v2_lite") is cfg
    assert "deepseek_v2_lite" not in base.ARCH_NAMES
    assert base.layer_kinds(cfg) == ["mla"] + ["mla_moe"] * 26
    # 15.7 B: the dense layer, 26 MoE layers (64 experts, 2 shared, the
    # router), the embedding and the untied head
    assert cfg.param_count() == 15_706_357_760
    lay = kvpool.build_layout(cfg, 4096 + 256, block_tokens=16)
    assert [(pl.unit_idx, pl.key, pl.reps, pl.nkv, pl.hd)
            for pl in lay.paged] == [(0, "ckv", 27, 1, 576)]
    assert not lay.tail
    assert lay.block_bytes == 27 * 576 * 16 * 2 == 497_664
    assert lay.blocks_for_decode(4096, 256) == 272


def test_qwen3_4b_layout_is_unchanged():
    """Both qwen3-4b cells' layouts, as they were before latent rows were
    paged: one K and one V leaf of 36 layers of 8 heads of 128."""
    cfg = base.get_config("qwen3-4b")
    for max_len, blocks in ((1024 + 192, 76), (3072 + 16, 193)):
        lay = kvpool.build_layout(cfg, max_len, block_tokens=16)
        assert lay.paged == tuple(
            kvpool.PagedLeaf(0, key, 36, max_len, 8, 128)
            for key in ("k", "v"))
        assert (lay.block_words, lay.blocks_per_request, lay.tail_words,
                lay.kv_dtype, lay.ring) == \
            (1_179_648, blocks, 1, "bfloat16", False)


def test_spans_and_counter_on_a_wall_clocked_tracer(params):
    tr = SpanTracer(clock=WallClock())
    sched = _serve(params, tracer=tr, n=3, new=4)
    stack, inside = collections.defaultdict(list), collections.Counter()
    for ev in tr.events:
        if ev.ph == "B":
            st = stack[(ev.pid, ev.tid)]
            if ev.name.split(".")[-1] in ("mla", "moe"):
                inside[(st[-1] if st else None, ev.name)] += 1
            st.append(ev.name)
        elif ev.ph == "E":
            stack[(ev.pid, ev.tid)].pop()
    steps = sched.stats.decode_steps
    assert inside[("decode.model", "decode.mla")] >= 3 * steps
    assert inside[("decode.model", "decode.moe")] == \
        inside[("decode.model", "decode.mla")] * 2 // 3
    assert inside[("prefill", "prefill.mla")] == 3 * 3
    assert inside[("prefill", "prefill.moe")] == 3 * 2
    assert set(inside) == {("decode.model", "decode.mla"),
                           ("decode.model", "decode.moe"),
                           ("prefill", "prefill.mla"),
                           ("prefill", "prefill.moe")}
    counts = [ev.args for ev in tr.events if ev.ph == "C"
              and ev.name == "moe"]
    assert len(counts) == inside[("decode.model", "decode.moe")] + 6
    assert all(c["dropped"] == 0 and 1 <= c["max_per_expert"] <= c["tokens"]
               and 1 <= c["experts_touched"] <= _cfg().num_experts
               for c in counts)


def test_ranges_under_a_recording_profiler_and_none_otherwise(params):
    cfg = _cfg()
    assert LayerSpans.make("decode", None, ("p", "t")) is None
    assert LayerSpans.make("decode", SpanTracer(), ("p", "t")) is None
    toks = torch.arange(6)[None]
    cache = kvcache.init_cache(cfg, 1, 8, "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with layerspans.use(LayerSpans.make("prefill", None,
                                            ("p", "t"))) as spans:
            model.prefill(params, cfg, {"tokens": toks}, cache)
    names = collections.Counter(e.name for e in prof.events())
    assert names["prefill.mla"] == 3 and names["prefill.moe"] == 2
    assert not spans.counting


def test_the_launcher_serves_it():
    from repro_torch.launch import serve
    sched = serve.main(["--disagg", "--device", "cpu", "--arch",
                        "deepseek-v2-lite", "--prompt-len", "12",
                        "--max-new", "4", "--requests", "2"])
    assert all(len(r.out) == 4 for r in sched.requests.values())
    assert math.isfinite(sched.stats.bytes_migrated) and \
        sched.stats.bytes_migrated > 0
