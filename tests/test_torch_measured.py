"""The port's measured-time layer (``obs/prof.py``, ``obs/calibrate.py``,
the measured track of ``obs/export.py``) held to the JAX package's.

- the off/on law of ``tests/test_measured.py`` on the port's fleet: a
  recording profiler (and the rest of the bundle) changes no token, no
  report field and no byte of the step-clocked trace;
- scopes pair wall seconds with the model's pricing of the same region,
  wall-clock records stay in their own telemetry stream, the scope's call
  waits for CUDA work (identity on CPU tensors);
- under one scripted clock in both packages, the profiler's samples, the
  calibration report, the measured track and the wall-clock tuning table
  are exact;
- provenance through the estimator, table merges and the refitter, and the
  ``ISHMEM_OBS_PROF`` / ``ISHMEM_OBS_CALIBRATION`` surface, exact.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import context as ref_context
from repro.obs import OnlineRefitter as RefRefitter, \
    calibrate_mod as ref_calibrate, load_obs_env as ref_load_obs_env, \
    prof_mod as ref_prof
from repro.tune import estimator as ref_estimator, table as ref_table, \
    telemetry as ref_telemetry
from repro_torch.core import context
from repro_torch.obs import (Obs, OnlineRefitter, calibrate_mod,
                             chrome_trace, load_obs_env, prof_mod, validate)
from repro_torch.obs.prof import NULL_PROF, ProfClock, Profiler
from repro_torch.obs.tracer import STEP_QUANTUM
from repro_torch.serve.frontend import Fleet, FleetConfig
from repro_torch.tune import estimator, table as table_mod, \
    telemetry as telemetry_mod

from _torch_lockstep import MAXLEN, fleet_engines, fleet_specs
from _torch_threads import one_intra_op_thread  # noqa: F401

NEW = 4
MIX = (dict(name="chat", weight=2.0, prompt_lens=(8,), max_new=(NEW,),
            slo="interactive"),
       dict(name="scan", weight=1.0, prompt_lens=(12,), max_new=(NEW,),
            slo="batch", shared_prefix_prob=0.5, prefix_groups=1))
FLEET_KW = dict(n_pods=2, prefill_per_pod=1, decode_per_pod=2, num_slots=2,
                kv_blocks=96, block_tokens=4, max_len=MAXLEN, max_new=NEW,
                stream_chunks=1, admission="slo", router="affinity", seed=11)


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch, tmp_path):
    """No stray ``ISHMEM_*`` variable, and dumps land in a temporary
    directory."""
    for name in list(os.environ):
        if name.startswith("ISHMEM_"):
            monkeypatch.delenv(name)
    monkeypatch.chdir(tmp_path)


def _serve(obs):
    _, specs = fleet_specs(MIX, rate=1.0, seed=17, steps=8)
    fleet = Fleet(FleetConfig(**FLEET_KW), engine=fleet_engines()[1],
                  obs=obs)
    rep = fleet.run(specs, max_steps=1500)
    rep.pop("obs", None)
    return fleet, rep


# ---------------------------------------------------------------------------
# the off/on law on the port's fleet
# ---------------------------------------------------------------------------


def test_profiling_off_is_bitwise_identical():
    """No bundle, a tracer alone, and the whole bundle with the profiler:
    the same tokens and report; the two traces byte for byte."""
    bare, rep_bare = _serve(None)
    off, rep_off = _serve(Obs(trace=True))
    on, rep_on = _serve(Obs(trace=True, prof=True, metrics=True,
                            audit_period=1, recorder_window=8, alerts=True))
    assert rep_bare == rep_off == rep_on
    assert rep_on["completed"] >= 4
    assert bare.outputs() == off.outputs() == on.outputs()
    doc_off, doc_on = chrome_trace(off.obs.tracer), chrome_trace(on.obs.tracer)
    assert json.dumps(doc_off, sort_keys=True) == \
        json.dumps(doc_on, sort_keys=True)
    assert validate(doc_on) == []
    prof = on.obs.prof
    assert {"serve_prefill", "serve_decode", "paged_attn",
            "stream_flush"} <= {s.op for s in prof.samples}
    tel = on.ctx.telemetry
    assert tel.nsamples("wallclock") > 0 < tel.source_time("wallclock")
    assert all(r.source == telemetry_mod.MODEL_SOURCE for r in tel.trace)
    assert tel.total_time() == off.ctx.telemetry.total_time()
    assert on.obs.auditor.checks == on.elapsed_steps
    assert on.obs.auditor.violation_count == 0
    # the measured track is additive and step-clocked
    track = calibrate_mod.measured_track_events(prof.samples)
    assert len(track) == len(prof.samples)
    doc_with = chrome_trace(on.obs.tracer, measured=track)
    assert validate(doc_with) == []
    assert len(doc_with["traceEvents"]) > len(doc_on["traceEvents"])
    assert json.dumps(chrome_trace(on.obs.tracer), sort_keys=True) == \
        json.dumps(doc_on, sort_keys=True)
    for ev in track:
        assert ev["pid"] == "measured" and ev["ph"] == "i"
        assert isinstance(ev["ts"], int)
        assert ev["ts"] // STEP_QUANTUM == ev["args"]["step"]


def test_validate_rejects_wallclock_shaped_timestamps():
    def doc(**ev):
        base = {"name": "x", "cat": "c", "ph": "i", "s": "t",
                "pid": "p", "tid": "t", "ts": 0}
        base.update(ev)
        return {"traceEvents": [base]}

    assert validate(doc()) == [] and validate(doc(ts=3.0)) == []
    assert any("non-integral ts" in e for e in validate(doc(ts=1.5)))
    assert any("non-integral dur" in e
               for e in validate(doc(ph="X", dur=2.5)))


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------


class _ScriptClock(ProfClock):
    def __init__(self, vals):
        self.vals = list(vals)

    def now(self):
        return self.vals.pop(0)


def test_scope_pairs_wall_with_model_delta():
    ctx, _ = context.init(npes=2, node_size=2, device="cpu")
    prof = Profiler(clock=_ScriptClock([10.0, 10.5])).attach(ctx)
    assert ctx.prof is prof
    prof.set_step(5)
    t0 = ctx.telemetry.total_time()
    x = {"a": [torch.ones(3), (torch.zeros(2), 7)], "b": "label"}
    with prof.scope("copy", nbytes=4096, path="direct", tier="ici",
                    work_items=4) as ps:
        ctx.telemetry.record(telemetry_mod.OpRecord(
            "put", 4096, "direct", "ici", 0.25, 4))
        assert ps(x) is x                       # CPU tensors: no wait
    (s,) = prof.samples
    assert dataclasses.astuple(s) == ("copy", 4096, "direct", "ici", 4, 5,
                                      0.5, 0.25)
    tel = ctx.telemetry
    assert tel.total_time() == t0 + 0.25
    assert tel.source_time("wallclock") == 0.5
    key = ("copy", "direct", "ici", 4)
    assert key in tel.sources["wallclock"] and key not in tel.buckets
    prof.set_step(3)
    assert prof.step == 5
    assert prof_mod.block_until_ready(x) is x


def test_block_until_ready_syncs_each_cuda_device(monkeypatch):
    """The port's ``jax.block_until_ready``: one ``torch.cuda.synchronize``
    per CUDA device found in any nesting, none for CPU tensors (checked
    with fake tensors standing for the card's and a recording stub)."""
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    cpu = torch.ones(2)
    assert prof_mod.block_until_ready([cpu, {"k": (cpu, 3)}]) is not None
    assert seen == []
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a = torch.empty(2, device="cuda:0")
        b = torch.empty(2, device="cuda:1")
    prof_mod.block_until_ready({"x": [a, (b, a)], "y": cpu})
    assert [str(d) for d in seen] == ["cuda:0", "cuda:1"]


def test_null_prof_is_inert():
    assert not NULL_PROF.enabled
    with NULL_PROF.scope("copy", nbytes=1) as ps:
        obj = object()
        assert ps(obj) is obj
    assert NULL_PROF.samples == []
    ctx, _ = context.init(npes=2, node_size=2, device="cpu")
    with pytest.raises(RuntimeError):
        NULL_PROF.attach(ctx)


# ---------------------------------------------------------------------------
# exact against the reference
# ---------------------------------------------------------------------------


def _canned(mod):
    rng = np.random.default_rng(4)
    out = []
    for i in range(60):
        op = ("serve_decode", "stream_flush", "serve_prefill",
              "paged_attn", "other_op")[i % 5]
        model = 0.0 if op == "serve_prefill" else float(rng.random()) * 1e-3
        out.append(mod.ProfSample(
            op=op, nbytes=int(rng.integers(1, 1 << 22)),
            path=("engine", "direct", "proxy")[i % 3],
            tier=("local", "ici", "dcn")[i % 3], work_items=1 + i % 4,
            step=i // 3, wall_s=float(rng.random()) * 1e-2, model_s=model))
    return out


def test_calibration_report_exact_against_reference(tmp_path):
    ps, rs = _canned(prof_mod), _canned(ref_prof)
    rep, ref = calibrate_mod.report_from_samples(ps), \
        ref_calibrate.report_from_samples(rs)
    assert json.dumps(rep, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert calibrate_mod.render(rep) == ref_calibrate.render(ref)
    assert calibrate_mod.measured_overlay(ps) == \
        ref_calibrate.measured_overlay(rs)
    assert calibrate_mod.measured_track_events(ps) == \
        ref_calibrate.measured_track_events(rs)
    worst = [w["ratio_p50"] for w in rep["worst"]]
    assert worst == sorted(worst, reverse=True)
    # sample files cross between the packages
    prof = Profiler(sink_records=False)
    prof.samples = ps
    prof.save(str(tmp_path / "port.json"))
    back = ref_prof.load_samples(str(tmp_path / "port.json"))
    assert [dataclasses.astuple(s) for s in back] == \
        [dataclasses.astuple(s) for s in rs]
    rprof = ref_prof.Profiler(sink_records=False)
    rprof.samples = rs
    rprof.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "ref.json").read_text() == \
        (tmp_path / "port.json").read_text()
    # the sink join over both streams
    recs = [("put", 1024, "direct", "ici", 1e-3, 1, "model"),
            ("put", 1024, "direct", "ici", 4e-3, 1, "wallclock"),
            ("lonely", 8, "direct", "ici", 9e-3, 1, "wallclock")]
    sinks = []
    for tel in (telemetry_mod, ref_telemetry):
        sink = tel.TelemetrySink()
        for r in recs:
            sink.record(tel.OpRecord(*r))
        sinks.append(sink)
    assert calibrate_mod.sink_join(sinks[0]) == \
        ref_calibrate.sink_join(sinks[1])
    assert [r["op"] for r in calibrate_mod.sink_join(sinks[0])] == ["put"]


def test_scripted_clock_scopes_and_wallclock_table_exact():
    """The same scripted clock and the same scopes in both packages: the
    samples, the wall-clock tuning table a context fits from them, and the
    refitter's hot swap agree exactly."""
    rng = np.random.default_rng(9)
    script = [float(x) for x in np.cumsum(rng.random(400) * 1e-3)]
    sides = []
    for ctx_mod, prof_m in ((context, prof_mod), (ref_context, ref_prof)):
        kw = {"device": "cpu"} if ctx_mod is context else {}
        ctx, _ = ctx_mod.init(npes=4, node_size=2, **kw)
        prof = prof_m.Profiler(clock=_ScriptClock(script)).attach(ctx)
        for i in range(100):
            prof.set_step(i // 4)
            n = 1 << (6 + i % 14)
            with prof.scope("stream_flush", nbytes=n,
                            path=("direct", "engine")[i % 2], tier="ici",
                            work_items=(32, 128)[i % 3 == 0]) as ps:
                ctx.record("put", n, "direct", "ici", 32)
                ps(None)
        tbl = ctx.fit_tuning_table(sample_source="wallclock")
        sides.append((prof, ctx, tbl))
    (p, pctx, ptbl), (r, rctx, rtbl) = sides
    assert [dataclasses.astuple(s) for s in p.samples] == \
        [dataclasses.astuple(s) for s in r.samples]
    assert ptbl.to_json() == rtbl.to_json()
    assert ptbl.source == "wallclock" and ptbl.cutovers
    assert pctx.tuning.table is ptbl
    assert json.dumps(calibrate_mod.report_from_samples(p.samples),
                      sort_keys=True) == \
        json.dumps(ref_calibrate.report_from_samples(r.samples),
                   sort_keys=True)
    pe = OnlineRefitter(pctx, period_steps=1, min_samples=1,
                        sample_source="wallclock").maybe_refit(30)
    re_ = RefRefitter(rctx, period_steps=1, min_samples=1,
                      sample_source="wallclock").maybe_refit(30)
    assert pe.to_json() == re_.to_json()
    assert all("wallclock" in x.source
               for x in pctx.tuning.table.profiles.values())


def test_provenance_through_estimator_and_merge(tmp_path):
    recs = [("put", n, "direct", "ici", 1e-6 + n / 1e9, 1, "wallclock")
            for n in (1 << 10, 1 << 12, 1 << 14, 1 << 16)]
    sink = telemetry_mod.TelemetrySink()
    rsink = ref_telemetry.TelemetrySink()
    for r in recs:
        sink.record(telemetry_mod.OpRecord(*r))
        rsink.record(ref_telemetry.OpRecord(*r))
    tbl = estimator.build_table(sink, source="wallclock",
                                sample_source="wallclock")
    assert tbl.to_json() == ref_estimator.build_table(
        rsink, source="wallclock", sample_source="wallclock").to_json()
    assert tbl.profiles and all(p.source == "wallclock"
                                for p in tbl.profiles.values())
    assert not estimator.build_table(sink).profiles
    for a, b in (("wallclock", "wallclock"), ("", "wallclock"),
                 ("wallclock", ""), ("wallclock", "model")):
        assert table_mod._merge_source(a, b) == ref_table._merge_source(a, b)
    key = ("direct", "ici", 0)
    a = table_mod.TuningTable(profiles={key: table_mod.PathProfile(
        1e-6, 1e9, nsamples=4, source="wallclock")}, source="wallclock")
    b = table_mod.TuningTable(profiles={key: table_mod.PathProfile(
        2e-6, 2e9, nsamples=4, source="model")}, source="model")
    assert a.merge(b).profiles[key].source == "wallclock+model"
    path = str(tmp_path / "t.json")
    tbl.save(path)
    assert "wallclock" in ref_table.TuningTable.load(path).source


@pytest.mark.parametrize("environ", [
    {}, {"ISHMEM_OBS_PROF": "1"}, {"ISHMEM_OBS_PROF": "/tmp/prof.json"},
    {"ISHMEM_OBS_CALIBRATION": "/tmp/cal.json"},
    {"ISHMEM_OBS_CALIBRATION": "1", "ISHMEM_OBS_PROF": "0"}])
def test_obs_env_prof_and_calibration_exact(environ):
    got, want = load_obs_env(environ), ref_load_obs_env(environ)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if environ.get("ISHMEM_OBS_CALIBRATION"):
        assert got.prof and got.calibration
