"""The paged decode step's persistent leaf buffers and its CUDA graph, on
the CPU (the graph itself replays only on a card: ``tests/test_torch_cuda.py``
holds it bitwise to the eager step there).

- ``PagedDecodeView.assemble`` rebuilds every paged leaf into the engine's
  persistent buffers, bitwise the leaves it builds into new tensors, for
  reduced qwen3-4b and DeepSeek-V2-Lite across admissions, evictions and
  copy-on-write; the slot banks hold no paged leaf.
- On the CPU the engine's paged path runs the eager step: its tokens and
  pool bytes are those of the route that rebuilds the leaves in new
  tensors, and the tally counts every step eager under ``cpu``.
- Where the graph does not engage, each step is counted under its reason:
  ``cpu``, ``meta``, ``dense``, ``layer_kind``; and ``moe_batch``, a
  dropless MoE too wide to route without the host, by the rule alone.
- The capture's plumbing with stand-in graph objects: one segment a part
  the model marks, the paged leaves adopted and the rest copied, the
  routing read back as the eager counter reads it.
"""
import contextlib

import pytest
import torch

from repro_torch.configs import base
from repro_torch.models import decode_graph, model
from repro_torch.obs import layerspans
from repro_torch.obs.layerspans import LayerSpans
from repro_torch.obs.tracer import SpanTracer, WallClock
from repro_torch.serve.engine import Engine
from repro_torch.serve.paged_attn import PagedDecodeView

from _torch_decode_traffic import build
from _torch_threads import one_intra_op_thread  # noqa: F401

ARCHS = ["qwen3-4b", "deepseek-v2-lite"]


def _pools(sched):
    return {dt: pool.clone() for dt, pool in sched.heap.pools.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_buffers_hold_bitwise_the_leaves_assemble_builds(arch, monkeypatch):
    """Every step of a run with admissions, evictions and copy-on-write:
    the leaves ``assemble`` rebuilds in the engine's buffers are bitwise
    those it rebuilds in new tensors, and are views of the buffers; the
    banks never hold a paged leaf."""
    sched = build(arch, "cpu")
    lay = sched.pool.layout
    assemble = PagedDecodeView.assemble
    seen = []

    def checked(view, heap, cache, out=None):
        got = assemble(view, heap, cache, out=out)
        want = assemble(view, heap, cache)
        assert out is not None
        for pl in lay.paged:
            key = (pl.unit_idx, pl.key)
            leaf = got["blocks"][pl.unit_idx][pl.key]
            assert torch.equal(leaf, want["blocks"][pl.unit_idx][pl.key])
            assert leaf.data_ptr() == out[key].data_ptr()
            assert pl.key not in cache["blocks"][pl.unit_idx]
        seen.append(view.pe)
        return got

    monkeypatch.setattr(PagedDecodeView, "assemble", checked)
    sched.run()
    st = sched.stats
    assert st.evictions == st.admissions == 16 and st.cow_copies > 0
    assert st.decode_steps >= 20 and len(seen) >= st.decode_steps
    assert set(seen) == set(sched.decode_pes)
    assert len(sched.engine._buffers) == 1          # one set, both PEs
    for bank in sched.banks.values():
        for pl in lay.paged:
            assert pl.key not in bank.cache["blocks"][pl.unit_idx]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_cpu_paged_path_runs_eager_and_serves_as_before(arch,
                                                            monkeypatch):
    """The paged path over the persistent buffers against the same run
    with the leaves rebuilt in new tensors each step: tokens, stats and
    every pool byte equal after every step; every step eager, counted
    under ``cpu``."""
    fresh = build(arch, "cpu")
    gather = PagedDecodeView.gather
    with monkeypatch.context() as m:
        m.setattr(PagedDecodeView, "gather",
                  lambda view, heap, cache, buffers=None:
                  gather(view, heap, cache))
        states = []
        while not fresh.done():
            fresh.step()
            states.append(_pools(fresh))
    sched = build(arch, "cpu")
    for want in states:
        sched.step()
        for dt, pool in sched.heap.pools.items():
            assert torch.equal(pool, want[dt])
    assert sched.done()
    for rid, req in sched.requests.items():
        assert req.out == fresh.requests[rid].out
    assert sched.stats == fresh.stats
    tally = sched.stats.decode_graph
    steps = sum(tally.eager_steps.values())
    assert (tally.captures, tally.replays) == (0, 0)
    assert tally.eager_steps == {"cpu": steps} and steps >= \
        sched.stats.decode_steps
    assert not sched.engine._graphs


def test_each_eager_step_is_counted_under_its_reason():
    dense = build("qwen3-4b", "cpu", requests=3, dense=True)
    dense.run()
    assert dense.stats.decode_graph.eager_steps == {
        "dense": dense.stats.decode_graph.counter()["eager_steps"]} and \
        dense.stats.decode_steps > 0
    hybrid = build("zamba2-2.7b", "cpu", requests=3)
    hybrid.run()
    assert set(hybrid.stats.decode_graph.eager_steps) == {"layer_kind"}

    cfg = base.reduced(base.get_config("qwen3-4b"))
    eng = Engine(cfg, model.init_params(cfg, device="meta"), max_len=16,
                 device="meta")
    slots = eng.init_slots(2, paged=True)
    tally = decode_graph.DecodeGraphTally()
    assert eng._decode_graph(slots, slots.cache, None, tally) is None
    assert tally.eager_steps == {"meta": 1}
    assert tally.counter() == {"captures": 0, "replays": 0,
                               "eager_steps": 1, "eager_meta": 1}

    card = torch.device("cuda", 0)
    mla = base.reduced(base.get_config("deepseek-v2-lite"))
    zamba = base.reduced(base.get_config("zamba2-2.7b"))
    assert decode_graph.eager_reason(cfg, card, 8) is None
    assert decode_graph.eager_reason(mla, card, 64) is None
    assert decode_graph.eager_reason(mla, card, 65) == "moe_batch"
    assert decode_graph.eager_reason(zamba, card, 2) == "layer_kind"
    assert decode_graph.eager_reason(mla, torch.device("cpu"), 2) == "cpu"


class _Graph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: capture runs the
    work eagerly, a replay does nothing."""
    made = []

    def __init__(self):
        self.replays = 0
        _Graph.made.append(self)

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        self.replays += 1


def _no_cuda(monkeypatch):
    class Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

    cuda = torch.cuda
    for name, value in (
            ("CUDAGraph", _Graph), ("Stream", Stream),
            ("stream", lambda s: contextlib.nullcontext()),
            ("current_stream", lambda device=None: Stream()),
            ("synchronize", lambda device=None: None),
            ("empty_cache", lambda: None),
            ("graph_pool_handle", lambda: ("pool",))):
        monkeypatch.setattr(cuda, name, value)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_capture_segments_at_the_model_part_marks(arch, monkeypatch):
    """With stand-in graph objects (capture runs the step, replay does
    nothing), a capture's first call gives the eager step's logits and
    cache; its named segments are the model's part marks in order; the
    paged leaves are adopted and the other leaves copied; a wall-clocked
    tracer gets each MoE call's routing as the eager counter gives it."""
    _no_cuda(monkeypatch)
    _Graph.made = []
    cfg = base.reduced(base.get_config(arch))
    parts = [p for kind in base.layer_kinds(cfg)
             for p in {"mla": ["mla"], "mla_moe": ["mla", "moe"]}.get(
                 kind, [])]
    params = model.init_params(cfg, seed=3, device="cpu")
    eng = Engine(cfg, params, max_len=12, device="cpu")
    slots = eng.init_slots(2)
    gen = torch.Generator().manual_seed(4)
    cache = {"blocks": [{k: torch.randn(leaf.shape, generator=gen).to(
        leaf.dtype) for k, leaf in e.items()} for e in slots.cache["blocks"]]}
    tok, pos = torch.tensor([[5], [7]]), torch.tensor([3, 9])
    paged = {(0, key) for key in cache["blocks"][0]}
    graph = decode_graph.DecodeGraph(paged)

    def spans():
        return LayerSpans.make("decode", SpanTracer(clock=WallClock()),
                               ("p", "t"))

    with layerspans.use(spans()) as eager_spans:
        want_logits, want_cache = model.decode_step(params, cfg, tok, pos,
                                                    cache)
    with layerspans.use(spans()) as step_spans:
        logits, new_cache = model.decode_step(params, cfg, tok, pos, cache,
                                              graph=graph)
    assert graph.ready and torch.equal(logits, want_logits)
    for entry, want in zip(new_cache["blocks"], want_cache["blocks"]):
        for key, leaf in entry.items():
            assert torch.equal(leaf, want[key])
    names = [name for name, _ in graph.graphs if name is not None]
    assert names == parts
    assert all(g.replays == 1 for _, g in graph.graphs)
    for (ui, key), leaf in ((k, graph.cache["blocks"][k[0]][k[1]])
                            for k in paged):
        assert leaf is cache["blocks"][ui][key]
    assert graph.tok is not tok and torch.equal(graph.tok, tok)

    def moe_counts(sp):
        return [ev.args for ev in sp.tracer.events
                if ev.ph == "C" and ev.name == "moe"]
    assert moe_counts(step_spans) == moe_counts(eager_spans)
    assert len(moe_counts(step_spans)) == parts.count("moe") and \
        all(c["dropped"] == 0 for c in moe_counts(step_spans))
    ranges = [ev.name for ev in step_spans.tracer.events if ev.ph == "B"]
    assert ranges == [f"decode.{p}" for p in names]

    # a later call copies the non-adopted inputs in and replays
    tok2 = torch.tensor([[1], [2]])
    model.decode_step(params, cfg, tok2, pos + 1, cache, graph=graph)
    assert torch.equal(graph.tok, tok2) and torch.equal(graph.pos, pos + 1)
    assert all(g.replays == 2 for _, g in graph.graphs)
    assert len(_Graph.made) == len(graph.graphs) > len(parts)
