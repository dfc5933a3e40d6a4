"""The port's observability bundle (``obs/__init__.py``: critical paths,
the analyze CLI, auditors, flight recorder, burn-rate alerts, metrics,
online re-fit) held to the JAX package's.

- one fleet with the whole bundle on (trace, metrics, auditors every step,
  an 8-step recorder, alerts, a re-fit every 4 steps from profiled samples
  under a counting clock) steps in lockstep with the reference's: metrics
  rows, audit summaries without their wall fields, recorder dumps, re-fit
  history, alerts, samples and the trace agree per step;
- seeded refcount, residency and signal corruptions of two fleets in
  lockstep draw the same violations from both packages' auditors, and the
  enforcing hook dumps a postmortem that validates;
- an overloaded streaming fleet: exact critical paths, clean audits, a
  burn-rate alert naming a request truly past its deadline;
- the analyze CLI reads traces written by either package alike;
- ring eviction by step, window repair, crash dumps, the environment.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

from repro.obs import Obs as RefObs, load_obs_env as ref_load_obs_env
from repro.obs import analyze as ref_analyze, critical as ref_critical
from repro.obs.alerts import BurnRateMonitor as RefMonitor, \
    BurnWindow as RefWindow
from repro.obs.audit import FleetAuditor as RefAuditor
from repro.obs.export import chrome_trace as ref_chrome_trace
from repro.obs.recorder import FlightRecorder as RefRecorder, \
    RingTracer as RefRingTracer
from repro.obs.tracer import SpanTracer as RefSpanTracer
from repro_torch.obs import (Obs, RingTracer, load_obs_env, request_chains,
                             validate)
from repro_torch.obs import analyze as analyze_mod, critical, export
from repro_torch.obs.alerts import BurnRateMonitor, BurnWindow, \
    parse_windows
from repro_torch.obs.audit import AuditError, FleetAuditor
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.tracer import STEP_QUANTUM, SpanTracer
from repro_torch.serve.frontend import Fleet, FleetConfig
from repro_torch.serve.scheduler import DECODING

from _torch_lockstep import MAXLEN, fleet_engines, fleet_specs, \
    run_fleet_lockstep, same_report
from _torch_threads import one_intra_op_thread  # noqa: F401

NEW = 4


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch, tmp_path):
    """No stray ``ISHMEM_*`` variable; dumps land in a temporary
    directory."""
    for name in list(os.environ):
        if name.startswith("ISHMEM_"):
            monkeypatch.delenv(name)
    monkeypatch.chdir(tmp_path)


def _fleet_kw(**over):
    kw = dict(n_pods=2, prefill_per_pod=1, decode_per_pod=2, num_slots=2,
              kv_blocks=96, block_tokens=4, max_len=MAXLEN, max_new=NEW,
              stream_chunks=1, admission="slo", router="affinity", seed=11)
    kw.update(over)
    return kw


def _tenants(shared=0.0):
    return (dict(name="chat", weight=2.0, prompt_lens=(8,), max_new=(NEW,),
                 slo="interactive"),
            dict(name="scan", weight=1.0, prompt_lens=(12,), max_new=(12,),
                 slo="batch", shared_prefix_prob=shared, prefix_groups=1))


# ---------------------------------------------------------------------------
# the whole bundle, in lockstep with the reference's
# ---------------------------------------------------------------------------


def test_obs_bundle_fleet_lockstep(tmp_path):
    """Nominal load with every part of the bundle on: the port's fleet and
    bundle step with the reference's, and the burn-rate monitor stays
    silent while the auditors find nothing."""
    obs = dict(trace=True, metrics=True, audit_period=1, recorder_window=8,
               alerts=True, refit_period=4, refit_min_samples=8, prof=True,
               calibration=True)
    rf, pf, specs, rep = run_fleet_lockstep(
        _fleet_kw(queue_bound=64), _tenants(shared=0.5), rate=0.8, seed=11,
        steps=10, obs=obs, obs_dir=tmp_path)
    ro, po = rf.obs, pf.obs
    assert rep["completed"] == rep["offered"] == len(specs) >= 6
    assert len(po.metrics.series) == pf.elapsed_steps
    assert po.auditor.checks == pf.elapsed_steps
    assert po.auditor.violation_count == 0
    assert po.monitor.observations == pf.elapsed_steps
    assert po.monitor.fired == [] and po.monitor.active == set()
    assert len(po.refitter.history) >= 2
    assert po.prof.samples and pf.ctx.tuning.table is not None
    assert pf.ctx.tuning.table.source == "wallclock"
    assert json.dumps(po.calibration_report(), sort_keys=True) == \
        json.dumps(ro.calibration_report(), sort_keys=True)
    assert pf.ctx.fit_tuning_table(arm=False, sample_source="wallclock") \
        .to_json() == rf.ctx.fit_tuning_table(
            arm=False, sample_source="wallclock").to_json()
    for measured in (False, True):
        pdoc = po.write_trace(str(tmp_path / "p.json"), measured=measured)
        rdoc = ro.write_trace(str(tmp_path / "r.json"), measured=measured)
        assert validate(pdoc) == []
        same_report(rdoc, pdoc, "trace")
    summary = pf.report()["obs"]
    assert summary["audit"]["violations"] == 0
    assert summary["refits"] == len(po.refitter.history)


# ---------------------------------------------------------------------------
# seeded corruption, both packages' auditors
# ---------------------------------------------------------------------------


def _violations(found):
    return sorted(json.dumps(v.to_json(), sort_keys=True) for v in found)


def test_seeded_corruptions_draw_the_reference_violations(tmp_path):
    """Two fleets in lockstep; whenever a corruption's condition first
    holds, it is seeded into both, both auditors run, and the violations
    must be the same records (and name the right rule); the fleets are then
    restored.  Last, the enforcing hook on the port raises ``AuditError``
    within one audit period and dumps a postmortem that validates."""
    from repro.serve.frontend import Fleet as RefFleet, \
        FleetConfig as RefFleetConfig
    kw = _fleet_kw(admission="slo", router="least_loaded", num_slots=1,
                   queue_bound=6, kv_blocks=128, stream_chunks=2)
    reng, peng = fleet_engines()
    rspecs, pspecs = fleet_specs(_tenants(shared=1.0), rate=2.0, seed=23,
                                 steps=10)
    rf = RefFleet(RefFleetConfig(**kw), engine=reng)
    pf = Fleet(FleetConfig(**kw), engine=peng)

    def refcount(f):
        ids = next((v for v in f.pool.block_tables.values() if v), None)
        if ids is None:
            return None
        b = ids[0]
        f.pool._refcnt[b] += 1
        return lambda: f.pool._refcnt.__setitem__(b, f.pool._refcnt[b] - 1)

    def residency(f):
        live = [e for e in f.prefix_index.values() if e.refs >= 2]
        if not live:
            return None
        entry = max(live, key=lambda e: e.refs)
        foreign = next(b for b in range(f.pool.num_blocks)
                       if b not in entry.block_ids)
        pe = f.pods[0].sched.decode_pes[0]
        had = pe in entry.resident
        entry.resident.setdefault(pe, set()).add(foreign)

        def undo():
            entry.resident[pe].discard(foreign)
            if not had:
                del entry.resident[pe]
        return undo

    def signal(f):
        for pod in f.pods:
            for req in pod.sched.requests.values():
                if (req.state == DECODING and req.slot >= 0
                        and len(req.out) + 2 < req.max_new):
                    ptr = f.pool.sig_ptr(req.slot)
                    old = f.heap
                    if isinstance(f, Fleet):
                        f.heap = f.heap.write(ptr, req.decode_pe,
                                              torch.ones(1, dtype=torch.int32))
                    else:
                        import jax.numpy as jnp
                        f.heap = f.heap.write(ptr, req.decode_pe,
                                              jnp.ones((1,), jnp.int32))
                    return lambda: setattr(f, "heap", old)
        return None

    todo = {"refcount-": refcount, "residency-": residency,
            "signal-": signal}
    caught = {}
    order = sorted(range(len(pspecs)),
                   key=lambda i: (pspecs[i].step, pspecs[i].idx))
    i = 0
    while todo and (i < len(order) or not pf.done()):
        assert pf.elapsed_steps < 400, "wedged"
        for prefix, corrupt in list(todo.items()):
            undo_p = corrupt(pf)
            if undo_p is None:
                continue
            undo_r = corrupt(rf)
            got, want = FleetAuditor().audit(pf), RefAuditor().audit(rf)
            undo_p()
            undo_r()
            assert got and _violations(got) == _violations(want)
            assert any(v.rule.startswith(prefix) for v in got), got
            assert FleetAuditor().audit(pf) == [] == RefAuditor().audit(rf)
            caught[prefix] = pf.elapsed_steps
            del todo[prefix]
        batch = []
        while i < len(order) and pspecs[order[i]].step <= pf.elapsed_steps:
            batch.append(order[i])
            i += 1
        rf.step([rspecs[j] for j in batch])
        pf.step([pspecs[j] for j in batch])
    assert not todo, f"conditions never held for {sorted(todo)}"
    # the enforcing hook: a corruption raises within one period and dumps
    obs = Obs(audit_period=1, recorder_window=64,
              recorder_path=str(tmp_path / "pm.json"))
    fleet = Fleet(FleetConfig(**kw), engine=peng, obs=obs)
    for step in range(3):
        fleet.step([pspecs[j] for j in order
                    if pspecs[j].step == fleet.elapsed_steps])
    undo = None
    while undo is None:
        fleet.step([pspecs[j] for j in order
                    if pspecs[j].step == fleet.elapsed_steps])
        undo = refcount(fleet)
    injected = fleet.elapsed_steps
    with pytest.raises(AuditError) as err:
        fleet.step([])
    assert fleet.elapsed_steps - injected <= obs.audit_period
    assert {v.rule for v in err.value.violations} & {
        "refcount-conservation", "free-list-referenced"}
    assert len(obs.recorder.dumps) == 1
    doc = json.loads(open(obs.recorder.dumps[0]).read())
    assert validate(doc, warnings=[]) == []
    assert doc["otherData"]["postmortem"]["reason"].startswith("audit:")


# ---------------------------------------------------------------------------
# an overloaded streaming fleet on the port
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _stressed_streaming():
    obs = Obs(trace=True, metrics=True, audit_period=1, alerts=True)
    _, specs = fleet_specs(_tenants(shared=0.5), rate=3.0, seed=23, steps=16)
    fleet = Fleet(FleetConfig(**_fleet_kw(
        admission="slo", router="least_loaded", num_slots=1, queue_bound=3,
        kv_blocks=128, stream_chunks=2)), engine=fleet_engines()[1], obs=obs)
    return fleet, obs, fleet.run(specs, max_steps=2500)


def test_streaming_paths_exact_audits_clean_and_alert_fires():
    fleet, obs, report = _stressed_streaming()
    assert report["shed"] > 0 and report["preempts"] >= 1
    chains = request_chains(obs.tracer)
    assert set(chains) == {rid for _, rid in fleet.placements.values()}
    paths = critical.fleet_paths(chains, obs.tracer.events)
    for rid, p in paths.items():
        assert p["complete"] and p["gaps"] == [], rid
        assert sum(p["segments"].values()) == pytest.approx(
            p["e2e_ticks"], abs=1e-9)
    assert any(p["segments"]["wire"] > 0 for p in paths.values())
    assert any(p["segments"]["preemption"] > 0 for p in paths.values())
    assert obs.auditor.checks == fleet.elapsed_steps
    assert obs.auditor.violation_count == 0
    assert obs.monitor.fired, "overloaded run never alerted"
    alert = obs.monitor.fired[0]
    worst = alert.offenders[0]
    sched = {pod.name: pod.sched for pod in fleet.pods}[worst["pod"]]
    req = sched.requests[worst["rid"]]
    from repro_torch.serve.frontend import slo as slo_mod
    cls = slo_mod.resolve(req.slo, fleet.classes)
    assert cls.name == alert.cls
    if worst["outcome"] == "shed":
        assert req.state == "shed"
    else:
        assert worst["overshoot_steps"] == (
            req.admit_step - req.arrival_step - cls.ttfd_deadline) > 0
    assert worst["segments_steps"]
    rep = critical.analyze_tracer(obs.tracer)
    assert rep["chain_gaps"] == 0 and rep["incomplete_paths"] == 0
    for key, val in rep["what_if"].items():
        assert val <= rep["ttfd"]["p99_steps"] + 1e-9, key


def _drive(tr, rng):
    """One random request-lifeline sequence, the same for both packages'
    tracers."""
    phases = ("queued", "prefill", "staged", "migrating", "decoding")
    for step in range(12):
        tr.clock.set_step(step)
        tr.begin("step", "fleet", "fleet", "steps", step=step)
        for rid in range(4):
            k = step - 2 * rid
            if 0 <= k < len(phases):
                if k:
                    tr.async_end(phases[k - 1], "req", rid, "pod0",
                                 "requests", steps=int(rng.integers(0, 3)))
                tr.async_begin(phases[k], "req", rid, "pod0", "requests",
                               pe=rid % 2)
            elif k == len(phases):
                tr.async_end(phases[-1], "req", rid, "pod0", "requests",
                             outcome="finished")
            tr.instant("xfer", "cq", "core", "cq",
                       bytes=int(rng.integers(1, 1 << 20)))
        tr.end("step", "fleet", "fleet", "steps")


def test_analyze_cli_on_traces_from_either_package(tmp_path, capsys):
    """A trace written by the reference's exporter and one by the port's,
    from the same events: both CLIs print the same report for each, and
    the offline report equals the live one."""
    trp, trr = SpanTracer(), RefSpanTracer()
    _drive(trp, np.random.default_rng(3))
    _drive(trr, np.random.default_rng(3))
    paths = {"port": tmp_path / "port.json", "ref": tmp_path / "ref.json"}
    export.write_chrome_trace(trp, str(paths["port"]))
    with open(paths["ref"], "w") as f:
        json.dump(ref_chrome_trace(trr), f)
    assert json.loads(paths["port"].read_text()) == \
        json.loads(paths["ref"].read_text())
    texts = {}
    for who, path in paths.items():
        for cli, mod in (("port", analyze_mod), ("ref", ref_analyze)):
            out = tmp_path / f"{who}-{cli}.json"
            assert mod.main([str(path), "--json", str(out)]) == 0
            texts[who, cli] = (capsys.readouterr().out,
                               json.loads(out.read_text()))
    first = texts["port", "port"]
    assert "TTFD steps:" in first[0] and "!!" not in first[0]
    assert all(v == first for v in texts.values())
    live = critical.analyze_tracer(trp)
    assert first[1]["ttfd"] == live["ttfd"] == \
        ref_critical.analyze_tracer(trr)["ttfd"]
    # a truncated trace is flagged, not refused
    tr = SpanTracer(max_events=4)
    tr.begin("step", "fleet", "fleet", "steps")
    for _ in range(20):
        tr.instant("xfer", "cq", "core", "cq")
    tr.end("step", "fleet", "fleet", "steps")
    export.write_chrome_trace(tr, str(tmp_path / "trunc.json"))
    assert analyze_mod.main([str(tmp_path / "trunc.json")]) == 0
    assert "!!" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# alerts, recorder, environment
# ---------------------------------------------------------------------------


def test_burn_rate_mechanics_match_reference():
    class _F:
        elapsed_steps = 0
        pods = ()
        classes = None

    rows = []

    class _Reg:
        series = rows

    mons = (BurnRateMonitor(target=0.9, windows=(BurnWindow(2, 2.0),),
                            min_terminal=2),
            RefMonitor(target=0.9, windows=(RefWindow(2, 2.0),),
                       min_terminal=2))
    fired = []
    for bad, term in ((0, 2), (3, 6), (4, 8), (4, 20), (9, 25)):
        rows.append({"step": len(rows) + 1, "class.chat.bad": bad,
                     "class.chat.terminal": term})
        got = [[a.to_json() for a in m.observe(_F(), _Reg())] for m in mons]
        assert got[0] == got[1]
        fired.append(len(got[0]))
    assert fired == [0, 1, 0, 0, 1]
    assert mons[0].summary() == mons[1].summary()
    with pytest.raises(ValueError):
        BurnRateMonitor(target=1.5)
    assert parse_windows("8:6,32:3") == (BurnWindow(8, 6.0),
                                         BurnWindow(32, 3.0))
    with pytest.raises(ValueError):
        parse_windows("")


def test_ring_tracer_and_recorder_match_reference(tmp_path):
    docs = []
    for ring_cls, rec_cls in ((RingTracer, FlightRecorder),
                              (RefRingTracer, RefRecorder)):
        tr = ring_cls(window_steps=4)
        for step in range(20):
            tr.clock.set_step(step)
            tr.begin("step", "fleet", "fleet", "steps")
            tr.instant("xfer", "cq", "core", "cq")
            tr.end("step", "fleet", "fleet", "steps")
        assert tr.evicted > 0
        assert min(ev.ts for ev in tr.events) >= (19 - 4) * STEP_QUANTUM
        small = ring_cls(window_steps=100, max_events=8)
        for _ in range(50):
            small.instant("x", "t", "p", "t")
        assert len(small.events) == 8 and small.evicted == 42
        tr = ring_cls(window_steps=2)
        rec = rec_cls(tr, window_steps=2,
                      path=str(tmp_path / f"{ring_cls.__module__}.json"))
        tr.clock.set_step(0)
        tr.begin("old", "t", "p", "t")
        tr.flow_start(1, "migration", "pod0", "pe0")
        tr.clock.set_step(5)
        tr.async_begin("decoding", "req", 1, "pod0", "requests")
        tr.end("old", "t", "p", "t")
        tr.flow_end(1, "migration", "pod1", "pe2")
        tr.begin("live", "t", "p", "t")
        rec.note_metrics({"step": 5, "g": 1.0})
        docs.append(json.loads(open(rec.dump(reason="crash:test")).read()))
    assert docs[0] == docs[1]
    assert validate(docs[0], warnings=[]) == []
    closes = {(e["ph"], e["name"]) for e in docs[0]["traceEvents"]
              if (e.get("args") or {}).get("truncated")}
    assert closes == {("E", "live"), ("e", "decoding")}


def test_crash_dumps_a_postmortem(tmp_path):
    _, specs = fleet_specs(_tenants(), rate=1.0, seed=11, steps=12)
    obs = Obs(recorder_window=16, recorder_path=str(tmp_path / "pm.json"))
    fleet = Fleet(FleetConfig(**_fleet_kw(queue_bound=64)),
                  engine=fleet_engines()[1], obs=obs)
    with pytest.raises(RuntimeError, match="wedged"):
        fleet.run(specs, max_steps=3)
    doc = json.loads(open(obs.recorder.dumps[0]).read())
    assert validate(doc, warnings=[]) == []
    assert doc["otherData"]["postmortem"]["reason"] == "crash:RuntimeError"


@pytest.mark.parametrize("environ", [
    {},
    {"ISHMEM_OBS_AUDIT": "4", "ISHMEM_OBS_RECORDER": "32",
     "ISHMEM_OBS_RECORDER_PATH": "pm.json", "ISHMEM_OBS_ALERTS": "1",
     "ISHMEM_OBS_ALERT_TARGET": "0.95",
     "ISHMEM_OBS_ALERT_WINDOWS": "4:2,16:1.5"},
    {"ISHMEM_OBS_TRACE": "t.json", "ISHMEM_OBS_METRICS": "1",
     "ISHMEM_OBS_REFIT": "8", "ISHMEM_OBS_REFIT_MIN_SAMPLES": "16"},
    {"ISHMEM_OBS_AUDIT": "-1"}, {"ISHMEM_OBS_RECORDER": "soon"},
    {"ISHMEM_OBS_ALERT_TARGET": "often"},
    {"ISHMEM_OBS_ALERT_WINDOWS": "8"}])
def test_obs_env_exact_and_wiring(environ):
    try:
        want = ref_load_obs_env(environ)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            load_obs_env(environ)
        assert str(got.value) == str(e)
        return
    cfg = load_obs_env(environ)
    assert cfg == type(cfg)(**{k: getattr(want, k)
                               for k in want.__dataclass_fields__})
    obs, ref = Obs.from_config(cfg), RefObs.from_config(want)
    for part in ("auditor", "recorder", "monitor", "metrics", "prof"):
        assert (getattr(obs, part) is None) == (getattr(ref, part) is None)
    assert type(obs.tracer).__name__ == type(ref.tracer).__name__
    assert obs.refit_period == ref.refit_period
    if cfg.recorder_window and not cfg.trace:
        assert isinstance(obs.tracer, RingTracer)
    on = Obs(trace=True, recorder_window=8)
    assert isinstance(on.tracer, SpanTracer) and \
        not isinstance(on.tracer, RingTracer)
    assert on.recorder.tracer is on.tracer
    assert Obs(alerts=True).metrics is not None
    assert not Obs().tracer.enabled


FLEET_CLI = ["--fleet", "--device", "cpu", "--prompt-len", "12",
             "--max-new", "4", "--block-tokens", "4", "--kv-blocks", "96",
             "--slots", "2", "--fleet-steps", "8"]


def test_launcher_bundle_by_flags_and_by_environment(tmp_path, monkeypatch,
                                                     capsys):
    """The launcher with the whole bundle, once by its flags and once by
    the ``ISHMEM_OBS_*`` variables (with ``ISHMEM_*`` tuning knobs set):
    the same tokens, every output written and valid; ``--disagg
    --profile`` on the CPU; the analyze CLI on the fleet's trace."""
    from repro_torch.launch import serve as launch_serve
    flags = ["--metrics", str(tmp_path / "m.json"), "--audit", "1",
             "--recorder", "8", "--alerts", "--refit", "4", "--profile",
             str(tmp_path / "p.json"), "--calibration",
             str(tmp_path / "c.json"), "--trace", str(tmp_path / "t.json")]
    by_flags = launch_serve.main(FLEET_CLI + flags)
    env = tmp_path / "env"
    env.mkdir()
    for name, val in (("TRACE", env / "t.json"), ("METRICS", env / "m.json"),
                      ("AUDIT", 1), ("RECORDER", 8), ("ALERTS", 1),
                      ("REFIT", 4), ("PROF", env / "p.json"),
                      ("CALIBRATION", env / "c.json")):
        monkeypatch.setenv(f"ISHMEM_OBS_{name}", str(val))
    monkeypatch.setenv("ISHMEM_CUTOVER_BYTES", "64K")
    monkeypatch.setenv("ISHMEM_WORK_GROUP_SIZE", "64")
    by_env = launch_serve.main(FLEET_CLI)
    assert by_env.ctx.tuning.cutover_bytes == 64 << 10
    assert by_flags.outputs() == by_env.outputs()
    for run, where in ((by_flags, tmp_path), (by_env, env)):
        summary = run.last_report["obs"]
        assert summary["audit"]["violations"] == 0
        assert summary["refits"] >= 1 and summary["prof"]["samples"] > 0
        doc = json.loads((where / "t.json").read_text())
        assert validate(doc) == []
        assert any(e.get("pid") == "measured" for e in doc["traceEvents"])
        rows = json.loads((where / "m.json").read_text())["series"]
        assert len(rows) == run.elapsed_steps
        cal = json.loads((where / "c.json").read_text())
        assert cal["samples"] == summary["prof"]["samples"]
        assert len(json.loads((where / "p.json").read_text())["samples"]) \
            == cal["samples"]
    out = capsys.readouterr().out
    assert "audit:" in out and "calibration" in out
    for name in list(os.environ):
        if name.startswith("ISHMEM_"):
            monkeypatch.delenv(name)
    sched = launch_serve.main(["--disagg", "--device", "cpu", "--requests",
                               "2", "--max-new", "3", "--profile"])
    prof = sched.ctx.prof
    assert {"serve_prefill", "serve_decode", "paged_attn"} <= \
        {s.op for s in prof.samples}
    assert "profiler:" in capsys.readouterr().out
    assert analyze_mod.main([str(tmp_path / "t.json")]) == 0
    assert "TTFD steps:" in capsys.readouterr().out
