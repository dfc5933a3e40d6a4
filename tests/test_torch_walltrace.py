"""The port's span tracer on a wall clock (``obs/tracer.py::WallClock``):
a reduced disaggregated run traced on it validates, closes every span,
stamps integer microseconds that never go back on a track and carries
each event's scheduler step; the spans inside a step (the decode step's
parts, its readback, staging) nest where they belong; a span and a
``record_function`` range around the same call agree on the torch
profiler's clock once rebased by the trace's start; the heap's tally
counts its copies and stores exactly; and tracing changes no token, while a
step-clocked or absent tracer records none of the wall-only spans.
"""
import collections
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import base
from repro_torch.core import context, heap as heap_mod, rma
from repro_torch.models import kvcache, model
from repro_torch.obs import Obs, Profiler, load_obs_env
from repro_torch.obs.export import (chrome_trace, events_from_doc,
                                    request_chains, validate)
from repro_torch.obs.tracer import NULL_TRACER, SpanTracer, WallClock
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.kvxfer import KVMigrator
from repro_torch.serve.scheduler import DisaggScheduler
from repro_torch.train import tree

from _torch_lockstep import fleet_engines, fleet_specs
from _torch_threads import one_intra_op_thread  # noqa: F401

MAXLEN = 24
DECODE_PARTS = ("decode.assemble", "decode.model", "decode.sample",
                "decode.writeback")
WALL_ONLY = DECODE_PARTS + ("decode.readback", "kvx.stage", "heap")


@pytest.fixture(scope="module")
def params():
    cfg = base.reduced(base.get_config("qwen3-4b"))
    return model.init_params(cfg, seed=0, device="cpu")


def _serve(params, tracer, prof=None, **kw):
    cfg = base.reduced(base.get_config("qwen3-4b"))
    ctx, heap = context.init(npes=4, node_size=4, device="cpu")
    ctx.tracer = tracer
    if prof is not None:
        prof.attach(ctx)
    eng = Engine(cfg, params, max_len=MAXLEN, device="cpu")
    pool = KVPool.create(heap, cfg, MAXLEN, num_blocks=24, max_slots=2,
                         block_tokens=4)
    sched = DisaggScheduler(ctx, heap, eng, pool, KVMigrator(ctx, pool),
                            prefill_pes=[0, 1], decode_pes=[2, 3],
                            num_slots=2, scfg=ServeConfig(max_new_tokens=5),
                            admit_delay_steps=1, **kw)
    rng = np.random.default_rng(2)
    shared = torch.from_numpy(rng.integers(0, 512, size=(1, 10))).long()
    for i in range(5):
        if i % 2:
            sched.submit({"tokens": shared}, prefix_len=10)
        else:
            sched.submit({"tokens": torch.from_numpy(
                rng.integers(0, 512, size=(1, 9))).long()})
    return sched, sched.run()


def _slices(events):
    """Closed ``B``/``E`` slices: (name, (pid, tid), start, end, args)."""
    out, stacks = [], collections.defaultdict(list)
    for ev in events:
        if ev.ph == "B":
            stacks[(ev.pid, ev.tid)].append(ev)
        elif ev.ph == "E":
            b = stacks[(ev.pid, ev.tid)].pop()
            assert b.name == ev.name
            out.append((ev.name, (ev.pid, ev.tid), b.ts, ev.ts,
                        b.args or {}))
    return out


CASES = [{}, {"stream_chunks": 1, "shared_prefix": True},
         {"fused_attn": True}]


@pytest.mark.parametrize("kw", CASES)
def test_wall_trace_validates_and_closes_every_span(params, kw):
    tr = SpanTracer(clock=WallClock())
    sched, _ = _serve(params, tr, **kw)
    doc = chrome_trace(tr)
    assert doc["otherData"]["clock"] == "wall"
    assert validate(doc) == []
    assert tr.open_spans() == {"slices": {}, "async": {}}
    last = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "M":
            continue
        assert type(ev["ts"]) is int and type(ev["step"]) is int
        track = (ev["pid"], ev["tid"])
        assert ev["ts"] >= last.get(track, 0)
        last[track] = ev["ts"]
    steps = [ev.step for ev in events_from_doc(doc)]
    assert steps == sorted(steps) and steps[-1] == sched._step - 1
    names = collections.Counter(ev.name for ev in tr.events
                                if ev.ph in "BC")
    n_decode = names["decode"]
    assert n_decode > 0
    assert all(names[n] == n_decode for n in DECODE_PARTS
               + ("decode.readback",))
    assert names["kvx.stage"] == sched.stats.prefills
    assert names["heap"] == n_decode + sched.stats.prefills
    for chain in request_chains(tr).values():
        assert chain[-1]["args"]["outcome"] == "finished"


@pytest.mark.parametrize("kw", CASES[:2])
def test_spans_nest_inside_decode_and_the_prefill_phase(params, kw):
    """The decode step's four parts tile its ``decode`` slice in order on
    the same track, the readback follows it, and each ``kvx.stage`` lies
    inside its request's ``prefill`` lifeline phase, after the
    ``prefill`` slice on the prefill PE's track."""
    tr = SpanTracer(clock=WallClock())
    _serve(params, tr, **kw)
    slices = _slices(tr.events)
    decodes = [s for s in slices if s[0] == "decode"]
    for name, track, a, b, _ in slices:
        if name in DECODE_PARTS:
            assert any(t == track and da <= a and b <= db
                       for _, t, da, db, _ in decodes), name
    by_track = collections.defaultdict(list)
    for s in slices:
        by_track[s[1]].append(s)
    for track, ss in by_track.items():
        seq = [s[0] for s in ss if s[0].startswith("decode")]
        for i in range(0, len(seq), 6):
            assert seq[i:i + 6] == list(DECODE_PARTS) + [
                "decode", "decode.readback"], (track, seq[i:i + 6])
    chains = request_chains(tr)
    prefills = [s for s in slices if s[0] == "prefill"]
    stages = [s for s in slices if s[0] == "kvx.stage"]
    assert stages
    for _, track, a, b, args in stages:
        phase = [e for e in chains[args["rid"]] if e["phase"] == "prefill"]
        assert phase and phase[0]["t0"] <= a and b <= phase[0]["t1"]
        assert any(t == track and pb <= a and pargs["rid"] == args["rid"]
                   for _, t, _, pb, pargs in prefills)


def test_span_and_record_function_agree_after_rebasing():
    """A wall-clock span and a ``record_function`` range around the same
    call, under ``torch.profiler`` on the CPU: the range's ``time_range``
    plus the trace's start lies within 1 ms of the span at both ends."""
    tr = SpanTracer(clock=WallClock())
    x = torch.randn(256, 256)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(6):
            tr.begin("work", "test", "p", "t")
            with torch.profiler.record_function("test.work"):
                for _ in range(20):
                    x = torch.tanh(x @ x)
            tr.end("work", "test", "p", "t")
    t0_us = prof.profiler.kineto_results.trace_start_ns() / 1000.0
    ranges = sorted((e.time_range.start + t0_us, e.time_range.end + t0_us)
                    for e in prof.events() if e.name == "test.work")
    spans = [(a, b) for _, _, a, b, _ in _slices(tr.events)]
    assert len(ranges) == len(spans) == 6
    for (ra, rb), (sa, sb) in zip(ranges, spans):
        assert abs(ra - sa) < 1000 and abs(rb - sb) < 1000
        assert sb - sa > 0


def test_heap_tally_counts_clones_and_stores_exactly():
    """Stores land in place: a data op's ``copy_bytes`` grows only when a
    pool grows (its old contents) and when a store's source overlaps its
    own destination (the source); every data op counts the bytes it
    stores."""
    heap = heap_mod.create(4, words_per_pool=1024, device="cpu")
    p = heap.calloc((100,), "float32")   # a new pool, zeroed: 128 words
    t = heap.tally
    assert (t.copy_bytes, t.store_bytes, t.writes) == (0, 4 * 128 * 4, 1)
    assert heap.write(p, 1, torch.ones(100)) is heap
    assert heap.write_all(p, torch.zeros(4, 100)) is heap
    assert (t.copy_bytes, t.store_bytes, t.writes) == \
        (0, 4 * 128 * 4 + 400 + 1600, 3)
    b = heap.calloc((300,), "bfloat16")  # another pool: 2 bytes a word
    heap.write(b, 0, torch.ones(300, dtype=torch.bfloat16))
    stored = 4 * 128 * 4 + 400 + 1600 + 4 * 384 * 2 + 600
    assert (t.copy_bytes, t.store_bytes, t.writes) == (0, stored, 5)
    # another PE's row, or another span of the same row: stored as it is
    heap.write(p, 2, heap.read(p, 1))
    heap.write(heap_mod.SymPtr("float32", p.offset + 100, (28,)), 1,
               heap.read(p, 1)[:28])
    assert (t.copy_bytes, t.store_bytes) == (0, stored + 400 + 112)
    # the span one word up from its own source: the source is copied first
    heap.write(heap_mod.SymPtr("float32", p.offset + 1, (99,)), 1,
               heap.read(p, 1)[:99])
    assert (t.copy_bytes, t.store_bytes) == (396, stored + 400 + 112 + 396)
    pool = heap.pools["float32"]
    big = heap.malloc((2000,), "float32")  # grows the pool to 2176 words
    assert heap.pools["float32"] is not pool
    assert t.copy_bytes == 396 + 4 * 1024 * 4
    heap.write(big, 2, torch.ones(2000))
    assert t.copy_bytes == 396 + 4 * 1024 * 4 and t.writes == 9
    assert heap_mod.create(4, device="cpu").tally is not t


def test_deferred_puts_count_their_staged_payloads():
    """A deferred put copies its payload at submission, and the completion
    queue copies a combined run of them into one buffer at the flush: both
    count in ``copy_bytes``, the run's store once in ``store_bytes``."""
    ctx, heap = context.init(npes=2, device="cpu")
    a = heap.malloc((256,), "float32")
    t = heap.tally
    before = (t.copy_bytes, t.store_bytes, t.writes)
    heap = rma.put_nbi(ctx, heap, heap_mod.SymPtr("float32", a.offset,
                                                  (100,)), torch.ones(100), 1)
    heap = rma.put_nbi(ctx, heap, heap_mod.SymPtr("float32", a.offset + 100,
                                                  (28,)), torch.ones(28), 1)
    assert (t.copy_bytes - before[0], t.store_bytes, t.writes) == \
        (512, before[1], before[2])
    heap = rma.quiet(ctx, heap)
    assert (t.copy_bytes - before[0], t.store_bytes - before[1],
            t.writes - before[2]) == (512 + 512, 512, 1)
    assert heap.read(a, 1)[:128].tolist() == [1.0] * 128
    heap = rma.put_nbi(ctx, heap, a, torch.zeros(256), 0)
    heap = rma.quiet(ctx, heap)          # a run of one: no merged buffer
    assert (t.copy_bytes - before[0], t.store_bytes - before[1]) == \
        (512 + 512 + 1024, 512 + 1024)


@pytest.mark.parametrize("kw", CASES)
def test_tracing_changes_no_token_and_off_records_nothing(params, kw):
    """The run with no tracer, with a step-clocked one, with a wall one
    and with an attached profiler: the same tokens, counters, heap words
    and heap tally; the step-clocked trace holds none of the wall-only
    spans and counter; the profiler's samples carry the byte counts of
    what each scope covers."""
    off, outs_off = _serve(params, NULL_TRACER, **kw)
    step = SpanTracer()
    on_step, outs_step = _serve(params, step, **kw)
    wall = SpanTracer(clock=WallClock())
    on_wall, outs_wall = _serve(params, wall, **kw)
    prof = Profiler()
    on_prof, outs_prof = _serve(params, NULL_TRACER, prof=prof, **kw)
    assert NULL_TRACER.timed is False and not hasattr(NULL_TRACER, "events")
    for outs, sched in ((outs_step, on_step), (outs_wall, on_wall),
                        (outs_prof, on_prof)):
        assert {k: v.tolist() for k, v in outs.items()} == \
            {k: v.tolist() for k, v in outs_off.items()}
        assert sched.stats == off.stats
        assert dataclasses.asdict(sched.heap.tally) == \
            dataclasses.asdict(off.heap.tally)
        for dt, pool in off.heap.pools.items():
            assert torch.equal(pool, sched.heap.pools[dt])
    assert not {ev.name for ev in step.events} & set(WALL_ONLY)
    assert all(ev.step is None for ev in step.events)
    assert {ev.name for ev in wall.events} >= set(WALL_ONLY) - (
        {"kvx.stage"} if kw.get("fused_attn") else set())

    samples = collections.defaultdict(list)
    for sm in prof.samples:
        samples[sm.op].append(sm)
    assert set(samples) == {"serve_prefill", "serve_decode", "paged_attn"} \
        | ({"stream_flush"} if kw.get("stream_chunks") else set())
    lay = on_prof.pool.layout
    token_bytes = lay.block_bytes // lay.block_tokens
    prompts = [r.prompt_len for r in on_prof.requests.values()]
    assert [(sm.nbytes, sm.path, sm.tier, sm.work_items)
            for sm in samples["serve_prefill"]] == \
        [(S * token_bytes, "engine", "local", 1) for S in prompts]
    # a request decodes max_new - 1 steps over S, S + 1, ... context tokens
    decode = samples["serve_decode"]
    steps = sum(ev.ph == "B" and ev.name == "decode" for ev in step.events)
    assert len(decode) == len(samples["paged_attn"]) == steps
    assert sum(sm.nbytes for sm in decode) == token_bytes * sum(
        S + j for S in prompts for j in range(5 - 1))
    assert sum(sm.work_items for sm in decode) == off.stats.decode_tokens
    assert [sm.work_items for sm in samples["paged_attn"]] == \
        [sm.work_items for sm in decode]
    # the decode proper reads the bank's whole assembled cache
    cache = kvcache.init_cache(on_prof.engine.cfg, 2, MAXLEN, "cpu")
    kv_bytes = sum(x.numel() * x.element_size() for x in tree.leaves(cache))
    assert {sm.nbytes for sm in samples["paged_attn"]} == {kv_bytes}
    assert {(sm.path, sm.tier) for sm in decode + samples["paged_attn"]} \
        == {("engine", "local")}
    # each installment of one block is flushed once, so a stream's flushes
    # carry 1, 2, ... of its blocks
    flushes = sorted(sm.nbytes for sm in samples["stream_flush"])
    assert flushes == sorted(
        k * lay.block_bytes for S in prompts
        for k in range(1, lay.blocks_for_prompt(S) + 1)
        if kw.get("stream_chunks"))
    assert all((sm.path, sm.tier, sm.work_items) ==
               ("direct", "ici", on_prof.migrator.work_items)
               for sm in samples["stream_flush"])


def test_the_clock_setting_reaches_the_tracer(monkeypatch):
    assert load_obs_env({}).trace_clock == "step"
    cfg = load_obs_env({"ISHMEM_OBS_TRACE": "1",
                        "ISHMEM_OBS_TRACE_CLOCK": "wall"})
    assert cfg.trace_clock == "wall"
    assert Obs.from_config(cfg).tracer.timed
    assert not Obs(trace=True).tracer.timed
    assert Obs(recorder_window=4, trace_clock="wall").tracer.timed
    with pytest.raises(ValueError, match="TRACE_CLOCK"):
        load_obs_env({"ISHMEM_OBS_TRACE_CLOCK": "tsc"})
    with pytest.raises(ValueError):
        Obs(trace=True, trace_clock="tsc")
    from repro_torch.launch import serve as launch_serve
    for name in [n for n in os.environ if n.startswith("ISHMEM_OBS_")]:
        monkeypatch.delenv(name)
    args = launch_serve.parse_args(["--disagg", "--trace", "t.json",
                                    "--trace-clock", "wall"])
    assert launch_serve.make_obs(args)[0].tracer.timed
    monkeypatch.setenv("ISHMEM_OBS_TRACE_CLOCK", "wall")
    args = launch_serve.parse_args(["--disagg", "--trace", "t.json"])
    assert launch_serve.make_obs(args)[0].tracer.timed
    args = launch_serve.parse_args(["--disagg", "--trace", "t.json",
                                    "--trace-clock", "step"])
    assert not launch_serve.make_obs(args)[0].tracer.timed


def test_a_fleet_with_the_whole_bundle_on_the_wall_clock():
    """The fleet with its tracer, metrics, flight recorder and burn-rate
    alerts on a wall clock serves what it serves with none; the trace and
    a postmortem snapshot validate and name their clock, and the alerts
    leave out the critical path, which counts steps."""
    from repro_torch.serve.frontend import Fleet, FleetConfig
    mix = (dict(name="chat", weight=2.0, prompt_lens=(8,), max_new=(4,),
                slo="interactive"),
           dict(name="scan", weight=1.0, prompt_lens=(12,), max_new=(4,),
                slo="batch", shared_prefix_prob=0.5, prefix_groups=1))
    # a rate the fleet falls behind at, so interactive requests run late
    _, specs = fleet_specs(mix, rate=4.0, seed=17, steps=8)

    def run(obs):
        fleet = Fleet(FleetConfig(
            n_pods=2, prefill_per_pod=1, decode_per_pod=2, num_slots=1,
            kv_blocks=96, block_tokens=4, max_len=MAXLEN, max_new=4,
            stream_chunks=1, admission="slo", router="affinity",
            queue_bound=64, seed=17), engine=fleet_engines()[1], obs=obs)
        rep = fleet.run(specs, max_steps=1500)
        rep.pop("obs", None)
        return fleet, rep

    off, rep_off = run(None)
    on, rep_on = run(Obs(trace=True, metrics=True, alerts=True,
                         recorder_window=4, trace_clock="wall"))
    assert rep_on == rep_off and on.outputs() == off.outputs()
    doc = chrome_trace(on.obs.tracer)
    assert doc["otherData"]["clock"] == "wall" and validate(doc) == []
    snap = on.obs.recorder.snapshot(reason="test")
    assert snap["otherData"]["clock"] == "wall" and validate(snap) == []
    steps = {ev["step"] for ev in snap["traceEvents"] if "step" in ev}
    assert steps and min(steps) >= on.elapsed_steps - 1 - 4
    mon = on.obs.monitor
    assert mon.observations == on.elapsed_steps
    late = mon._drilldown(on, "interactive", on.elapsed_steps,
                          tracer=on.obs.tracer)
    assert late and all("segments_steps" not in r for r in late)
