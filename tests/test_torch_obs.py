"""The port's span tracer and its Chrome-trace export (``obs/tracer.py``,
``obs/export.py``): the tracer laws of ``tests/test_obs.py`` that need no
fleet, the export held against the JAX package's on the same event
sequence (the profiler's measured track too), and the overhead contract
on the port's scheduler: a recording tracer changes no token, counter,
heap word or telemetry record.  Then ``tests/test_obs.py``'s laws of the
bundle: the fleet's tracer and metrics off/on law, the online re-fit
against the reference's, the ``Obs`` wiring, the ``ISHMEM_OBS_*``
surface and the metrics registry.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import context as ref_context, cutover as ref_cutover
from repro.obs import OnlineRefitter as RefRefitter, \
    calibrate_mod as ref_calibrate, load_obs_env as ref_load_obs_env, \
    prof_mod as ref_prof
from repro.obs import export as ref_export
from repro.obs.metrics import MetricsRegistry as RefRegistry
from repro.obs.tracer import SpanTracer as RefSpanTracer
from repro.tune import estimator as ref_estimator, table as ref_table
from repro_torch.configs import base
from repro_torch.core import context, cutover
from repro_torch.models import model
from repro_torch.obs.export import (TRACE_SCHEMA_VERSION, chain_gaps,
                                    chrome_trace, chrome_trace_events,
                                    events_from_doc, request_chains,
                                    request_chains_doc, validate,
                                    write_chrome_trace)
from repro_torch.obs import Obs, OnlineRefitter, calibrate_mod, \
    load_obs_env, prof_mod
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER, STEP_QUANTUM, SpanTracer, \
    StepClock
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.kvxfer import KVMigrator
from repro_torch.serve.scheduler import DisaggScheduler

from _torch_lockstep import fleet_engines, fleet_specs
from _torch_threads import one_intra_op_thread  # noqa: F401

MAXLEN = 24


# ---------------------------------------------------------------------------
# step clock and span tracer (tests/test_obs.py)
# ---------------------------------------------------------------------------


def test_step_clock_deterministic_and_monotonic():
    clk = StepClock()
    a, b, c = clk.now(), clk.now(), clk.now()
    assert a < b < c
    clk.set_step(3)
    t = clk.now()
    assert t == 3 * STEP_QUANTUM
    clk.set_step(1)                                # going back is a no-op
    assert clk.step == 3
    assert clk.now() > t
    for _ in range(2 * STEP_QUANTUM):
        last = clk.now()
    assert last < 4 * STEP_QUANTUM


def test_span_tracer_bookkeeping_and_export():
    tr = SpanTracer()
    tr.begin("flush", "cq", "core", "cq", ops=3)
    tr.instant("xfer", "cq", "core", "cq", path="direct")
    tr.end("flush", "cq", "core", "cq", bytes=128)
    tr.async_begin("queued", "req", 7, "pod0", "requests")
    tr.async_end("queued", "req", 7, "pod0", "requests")
    tr.flow_start(7, "migration", "pod0", "pe0")
    tr.flow_end(7, "migration", "pod1", "pe2")
    tr.counter("cq_pending", "core", "cq", pending=0)
    assert tr.open_spans() == {"slices": {}, "async": {}}
    assert len(tr) == 8
    doc = chrome_trace(tr)
    assert validate(doc) == []
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {(m["name"], m["pid"]) for m in meta} >= \
        {("process_name", "core"), ("process_name", "pod0")}
    assert doc["otherData"]["schema_version"] == TRACE_SCHEMA_VERSION


def test_span_tracer_open_spans_reports_leaks():
    tr = SpanTracer()
    tr.begin("flush", "cq", "core", "cq")
    tr.async_begin("decoding", "req", 3, "pod0", "requests")
    leaks = tr.open_spans()
    assert leaks["slices"] == {("core", "cq"): ["flush"]}
    assert leaks["async"] == {("req", 3, "decoding"): 1}
    assert validate(chrome_trace(tr))


def test_span_tracer_truncation_still_closes_spans():
    tr = SpanTracer(max_events=4)
    tr.begin("step", "fleet", "fleet", "steps")
    tr.async_begin("decoding", "req", 1, "pod0", "requests")
    for _ in range(50):
        tr.instant("xfer", "cq", "core", "cq")
    assert tr.dropped > 0 and len(tr.events) <= 4 + 2
    tr.async_end("decoding", "req", 1, "pod0", "requests")
    tr.end("step", "fleet", "fleet", "steps")
    assert tr.open_spans() == {"slices": {}, "async": {}}
    doc = chrome_trace(tr)
    warnings = []
    assert validate(doc, warnings=warnings) == []
    assert len(warnings) == 1 and "dropped" in warnings[0]
    errs = validate(doc)
    assert len(errs) == 1 and errs[0].startswith("warning:")
    assert doc["otherData"]["dropped_events"] == tr.dropped > 0


def _doc(events):
    return {"traceEvents": events}


def test_validate_rejects_malformed_documents():
    ok = {"name": "x", "cat": "t", "ph": "i", "ts": 1, "pid": "p", "tid": "t"}
    assert validate(_doc([ok])) == []
    assert validate({"nope": 1})
    assert validate(_doc([{"ph": "i", "ts": 1}]))
    assert validate(_doc([dict(ok, ts=None)]))
    bad_tid = dict(ok)
    del bad_tid["tid"]
    assert validate(_doc([bad_tid]))
    assert validate(_doc([dict(ok, ts=5), dict(ok, ts=3)]))
    assert validate(_doc([dict(ok, ts=1.5)]))      # wall clock leaked
    assert validate(_doc([dict(ok, dur=0.25)]))
    assert validate(_doc([dict(ok, ph="E", name="f")]))
    assert validate(_doc([dict(ok, ph="B", name="a", ts=1),
                          dict(ok, ph="E", name="b", ts=2)]))
    assert validate(_doc([dict(ok, ph="B", name="a")]))
    assert validate(_doc([dict(ok, ph="e", id="1")]))
    assert validate(_doc([dict(ok, ph="b")]))
    assert validate(_doc([dict(ok, ph="b", id="1")]))
    assert validate(_doc([dict(ok, ph="s", id="9")]))
    assert validate(_doc([dict(ok, ph="f", id="9")]))
    assert validate(_doc([dict(ok, ph="s", id="9", ts=1),
                          dict(ok, ph="s", id="9", ts=2),
                          dict(ok, ph="f", id="9", ts=3)]))


def test_request_chains_and_gap_detection():
    tr = SpanTracer()
    tr.async_begin("queued", "req", 5, "pod0", "requests", prompt_len=8)
    tr.async_end("queued", "req", 5, "pod0", "requests", queue_steps=0)
    tr.async_begin("prefill", "req", 5, "pod0", "requests")
    tr.async_end("prefill", "req", 5, "pod0", "requests", pe=0)
    tr.clock.set_step(2)                           # an untraced hole
    tr.async_begin("decoding", "req", 5, "pod0", "requests")
    tr.async_end("decoding", "req", 5, "pod0", "requests",
                 outcome="finished")
    chains = request_chains(tr)
    assert list(chains) == [5]
    assert [e["phase"] for e in chains[5]] == ["queued", "prefill",
                                               "decoding"]
    assert chains[5][0]["args"] == {"prompt_len": 8, "queue_steps": 0}
    gaps = chain_gaps(chains[5])
    assert len(gaps) == 1 and gaps[0][1] == 2 * STEP_QUANTUM
    assert chain_gaps(chains[5][:2]) == []
    # an open span covers everything after its begin
    open_chain = [{"phase": "a", "t0": 0, "t1": None, "args": {}},
                  {"phase": "b", "t0": 5000, "t1": 5001, "args": {}}]
    assert chain_gaps(open_chain) == []
    # the exported document rebuilds the same chains
    doc = json.loads(json.dumps(chrome_trace(tr)))
    assert request_chains_doc(doc) == chains
    assert [e.id for e in events_from_doc(doc) if e.cat == "req"] == [5] * 6


def test_measured_track_waits_for_the_obs_bundle():
    """The profiler's measured track, now that the bundle exists: from the
    same samples and events, the port's export (track, ``otherData``,
    thread names) equals the reference's byte for byte, validates, and
    leaves the base document unchanged when omitted."""
    tr, rtr = SpanTracer(), RefSpanTracer()
    rng, rrng = np.random.default_rng(8), np.random.default_rng(8)
    _drive(tr, rng)
    _drive(rtr, rrng)
    samples = []
    for mod in (prof_mod, ref_prof):
        samples.append([mod.ProfSample(
            op=("serve_decode", "paged_attn", "stream_flush")[i % 3],
            nbytes=64 << i, path="engine", tier="local", work_items=1 + i,
            step=i // 2, wall_s=1e-3 * (i + 1), model_s=1e-4 * i)
            for i in range(7)])
    track = calibrate_mod.measured_track_events(samples[0])
    rtrack = ref_calibrate.measured_track_events(samples[1])
    assert track == rtrack
    doc = chrome_trace(tr, measured=track)
    assert json.dumps(doc, sort_keys=True) == json.dumps(
        ref_export.chrome_trace(rtr, measured=rtrack), sort_keys=True)
    assert validate(doc) == []
    assert doc["otherData"]["measured_samples"] == 7
    assert json.dumps(chrome_trace(tr, measured=[]), sort_keys=True) == \
        json.dumps(chrome_trace(tr), sort_keys=True)


def _drive(tr, rng):
    """One random event sequence, the same for both packages' tracers."""
    for step in range(4):
        tr.clock.set_step(step)
        for rid in range(3):
            k = int(rng.integers(0, 5))
            if k == 0:
                tr.begin("decode", "sched", "pod0", f"pe{rid}", slots=rid)
                tr.end("decode", "sched", "pod0", f"pe{rid}")
            elif k == 1:
                tr.async_begin("migrating", "req", rid, "pod0", "requests",
                               bytes=int(rng.integers(1, 99)))
                tr.async_end("migrating", "req", rid, "pod0", "requests",
                             wire_model_s=float(rng.random()))
            elif k == 2:
                tr.flow_start(rid, "migration", "pod0", "pe0")
                tr.flow_end(rid, "migration", "pod0", "pe2")
            elif k == 3:
                tr.counter("cq_pending", "core", "cq",
                           pending=int(rng.integers(0, 9)))
            else:
                tr.instant("stream_chunk", "kvx", "pod0", "pe1", rid=rid,
                           chunk=step)


def test_export_matches_reference(tmp_path):
    """The same events through both packages' tracers give the same
    Chrome-trace document, the same chains and the same verdicts."""
    tr, rtr = SpanTracer(max_events=40), RefSpanTracer(max_events=40)
    _drive(tr, np.random.default_rng(5))
    _drive(rtr, np.random.default_rng(5))
    doc = write_chrome_trace(tr, str(tmp_path / "t.json"))
    assert doc == ref_export.chrome_trace(rtr)
    assert json.loads((tmp_path / "t.json").read_text()) == doc
    assert chrome_trace_events(tr.events, dropped=3, other={"why": "x"}) == \
        ref_export.chrome_trace_events(rtr.events, dropped=3,
                                       other={"why": "x"})
    assert request_chains(tr) == ref_export.request_chains(rtr)
    assert validate(doc) == ref_export.validate(doc)
    assert tr.open_spans() == rtr.open_spans()
    for bad in ([{"ph": "E", "name": "a", "ts": 1, "pid": 0, "tid": 0}],
                [{"ph": "s", "name": "a", "ts": 1, "pid": 0, "tid": 0,
                  "id": "3"}]):
        assert validate(_doc(bad)) == ref_export.validate(_doc(bad))


# ---------------------------------------------------------------------------
# tracer off => bitwise identical, on the port's scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    cfg = base.reduced(base.get_config("qwen3-4b"))
    return model.init_params(cfg, seed=0, device="cpu")


def _serve(params, tracer, **kw):
    cfg = base.reduced(base.get_config("qwen3-4b"))
    ctx, heap = context.init(npes=4, node_size=4, device="cpu")
    ctx.tracer = tracer
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


@pytest.mark.parametrize("kw", [{}, {"stream_chunks": 1,
                                     "shared_prefix": True},
                                {"shared_prefix": True},
                                {"paged": False}])
def test_tracer_off_is_bitwise_identical(params, kw):
    """A recording tracer only reads: tokens, every counter, the heap's
    words and the telemetry sequence equal the untraced run's; the trace
    validates, every span closes, and every request has a gap-free chain
    that ends finished."""
    off, outs_off = _serve(params, NULL_TRACER, **kw)
    tr = SpanTracer()
    on, outs_on = _serve(params, tr, **kw)
    assert {k: v.tolist() for k, v in outs_off.items()} == \
        {k: v.tolist() for k, v in outs_on.items()}
    assert off.stats == on.stats
    for dt, pool in off.heap.pools.items():
        assert torch.equal(pool, on.heap.pools[dt])
    assert [(r.op, r.nbytes, r.path, r.t_sec)
            for r in off.ctx.telemetry.trace] == \
        [(r.op, r.nbytes, r.path, r.t_sec) for r in on.ctx.telemetry.trace]
    assert validate(chrome_trace(tr)) == []
    assert tr.open_spans() == {"slices": {}, "async": {}}
    chains = request_chains(tr)
    assert sorted(chains) == sorted(on.requests)
    for chain in chains.values():
        assert chain_gaps(chain) == []
        assert chain[0]["phase"] == "queued"
        assert chain[-1]["args"]["outcome"] == "finished"
        if kw.get("stream_chunks"):
            phases = [e["phase"] for e in chain]
            assert "streaming" in phases and "parked" in phases


# ---------------------------------------------------------------------------
# the bundle (tests/test_obs.py)
# ---------------------------------------------------------------------------


def test_fleet_tracer_and_metrics_off_is_bitwise_identical():
    """No bundle, a bundle with everything off, and one tracing and
    sampling metrics: the same tokens and report; the metrics rows follow
    the fleet's steps."""
    from repro_torch.serve.frontend import Fleet, FleetConfig
    mix = (dict(name="chat", weight=2.0, prompt_lens=(8,), max_new=(4,),
                slo="interactive"),
           dict(name="scan", weight=1.0, prompt_lens=(12,), max_new=(4,),
                slo="batch", shared_prefix_prob=0.5, prefix_groups=1))
    _, specs = fleet_specs(mix, rate=1.0, seed=17, steps=8)

    def run(obs):
        fleet = Fleet(FleetConfig(
            n_pods=2, prefill_per_pod=1, decode_per_pod=2, num_slots=1,
            kv_blocks=96, block_tokens=4, max_len=MAXLEN, max_new=4,
            stream_chunks=1, admission="slo", router="affinity",
            queue_bound=64, seed=17), engine=fleet_engines()[1], obs=obs)
        rep = fleet.run(specs, max_steps=1500)
        rep.pop("obs", None)
        return fleet, rep

    runs = [run(None), run(Obs()), run(Obs(trace=True, metrics=True))]
    assert runs[0][1] == runs[1][1] == runs[2][1]
    assert runs[0][0].outputs() == runs[1][0].outputs() == \
        runs[2][0].outputs()
    fleet, obs = runs[2][0], runs[2][0].obs
    rows = obs.metrics.series
    assert [r["step"] for r in rows] == list(range(1, fleet.elapsed_steps
                                                   + 1))
    assert rows[-1]["pool.blocks_in_use"] == 0
    assert max(r["pool.blocks_in_use"] for r in rows) > 0
    assert fleet.report()["obs"]["trace_events"] == len(obs.tracer.events)
    assert validate(chrome_trace(obs.tracer)) == []


def _stale(mod):
    big = 1 << 30
    return mod.TuningTable(cutovers={
        ("local", 1): big, ("local", 512): big,
        ("ici", 1): big, ("ici", 512): big})


@pytest.mark.parametrize("stale", [True, False])
def test_online_refit_against_reference(stale):
    """A stale warm start is corrected (at least one decision flips, the
    4 MiB probe at one work-item goes to the engine); from a clean start a
    re-fit changes nothing.  Events equal the reference's."""
    from repro_torch.tune import estimator, table as table_mod
    sides = []
    for ctx_mod, cut, est, tab, refit in (
            (context, cutover, estimator, table_mod, OnlineRefitter),
            (ref_context, ref_cutover, ref_estimator, ref_table,
             RefRefitter)):
        kw = {"device": "cpu"} if ctx_mod is context else {}
        ctx, _ = ctx_mod.init(npes=4, node_size=2, tuning=cut.Tuning(
            table=_stale(tab) if stale else None), **kw)
        est.synthetic_sweep(ctx.hw, work_items=(1, 128, 512),
                            sink=ctx.telemetry)
        rf = refit(ctx, period_steps=10, min_samples=8,
                   probe_wis=(1, 128, 512))
        assert rf.maybe_refit(5) is None
        ev = rf.maybe_refit(20)
        assert rf.maybe_refit(21) is None
        sides.append((ev.to_json(), ctx.tuning.table.to_json()))
    assert sides[0] == sides[1]
    changed = sides[0][0]["changed"]
    if stale:
        assert {"tier": "ici", "work_items": 1, "nbytes": 1 << 22,
                "old": "direct", "new": "engine"} in changed
    else:
        assert changed == []
    ctx, _ = context.init(npes=2, node_size=2, device="cpu")
    rf = OnlineRefitter(ctx, period_steps=1, min_samples=8)
    assert rf.maybe_refit(100) is None and rf.history == []
    with pytest.raises(ValueError):
        OnlineRefitter(ctx, period_steps=0)


def test_obs_bundle_wiring(tmp_path):
    obs = Obs()
    assert obs.tracer is NULL_TRACER and obs.metrics is None
    for write in (obs.write_trace, obs.write_metrics, obs.write_prof):
        with pytest.raises(RuntimeError):
            write(str(tmp_path / "x.json"))
    with pytest.raises(RuntimeError):
        obs.calibration_report()
    ctx, _ = context.init(npes=2, node_size=2, device="cpu")
    assert ctx.tracer is NULL_TRACER and ctx.prof is None
    on = Obs(trace=True, refit_period=25, trace_limit=4096, calibration=True)
    on.attach(ctx)
    assert ctx.tracer is on.tracer and on.tracer.max_events == 4096
    assert ctx.prof is on.prof and on.prof is not None
    assert on.refitter.period_steps == 25
    assert on.refitter.sample_source == "wallclock"
    with pytest.raises(RuntimeError):
        Obs(trace=True).write_trace(str(tmp_path / "t.json"), measured=True)


@pytest.mark.parametrize("environ", [
    {}, {"ISHMEM_OBS_TRACE": "1", "ISHMEM_OBS_METRICS": "m.json",
         "ISHMEM_OBS_REFIT": "50", "ISHMEM_OBS_REFIT_MIN_SAMPLES": "16",
         "ISHMEM_OBS_TRACE_LIMIT": "64K"},
    {"ISHMEM_OBS_TRACE": "off"}, {"ISHMEM_OBS_TRACE": "t.json"},
    {"ISHMEM_OBS_REFIT": "often"}, {"ISHMEM_OBS_REFIT": "-1"},
    {"ISHMEM_OBS_TRACE_LIMIT": "lots"}])
def test_obs_env_surface_exact(environ):
    try:
        want = ref_load_obs_env(environ)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            load_obs_env(environ)
        assert str(got.value) == str(e)
        return
    got = load_obs_env(environ)
    assert {k: getattr(got, k) for k in got.__dataclass_fields__} == \
        {k: getattr(want, k) for k in want.__dataclass_fields__}
    assert Obs.from_config(got).tracer.enabled == got.trace


def test_metrics_registry_units_against_reference(tmp_path):
    docs = []
    for reg in (MetricsRegistry(), RefRegistry()):
        reg.count("flushes")
        reg.count("flushes", 2)
        reg.gauge("queue_depth", 7)
        for v in (1, 2, 1000):
            reg.observe("xfer_bytes", v)
        row = reg.sample(step=3)
        assert row == {"step": 3, "queue_depth": 7.0, "flushes": 3.0}
        docs.append(reg.write(str(tmp_path / "metrics.json")))
        assert json.loads((tmp_path / "metrics.json").read_text()) == \
            docs[-1]
    assert docs[0] == docs[1]
    assert docs[0]["histograms"]["xfer_bytes"] == {"0": 1, "1": 1, "9": 1}
