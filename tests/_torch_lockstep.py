"""The port's disaggregated scheduler held to the JAX package's in
lockstep, shared by ``tests/test_torch_serve.py`` (qwen3-4b's modes and
zamba2) and ``tests/test_torch_families.py`` (the seven other
configurations), and the reduced-width scheduler those files build; and
the port's fleet held to the JAX package's fleet in lockstep
(:func:`run_fleet_lockstep`), shared by ``tests/test_torch_fleet.py``,
``tests/test_torch_fault.py`` and ``tests/test_torch_obs_analysis.py``
(with an observability bundle on both fleets, :func:`obs_state`).

Both schedulers step in lockstep, each with a span tracer, and after every
step the control plane must agree exactly: request states, block tables,
refcounts, every int32 heap word (signals, stream signals, headers), the
telemetry record sequence, the scheduler counters, the step's trace events
and the tokens.  Float payloads (pool bytes and each step's logits) agree
to 5e-5, f32 summing in another order; the float pools' NaN words (a
ring's ``kpos`` of -1 in the f32 tail) agree bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import context as ref_context
from repro.models import model as ref_model
from repro.obs.export import chrome_trace as ref_chrome_trace
from repro.obs.tracer import SpanTracer as RefSpanTracer
from repro.serve.engine import Engine as RefEngine, \
    ServeConfig as RefServeConfig
from repro.serve.kvpool import KVPool as RefKVPool
from repro.serve.kvxfer import KVMigrator as RefKVMigrator
from repro.serve.scheduler import DisaggScheduler as RefScheduler
from repro_torch import _bridge
from repro_torch.configs import base
from repro_torch.core import context
from repro_torch.models import model
from repro_torch.obs.export import chrome_trace, validate
from repro_torch.obs.tracer import SpanTracer
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.kvxfer import KVMigrator
from repro_torch.serve.scheduler import DisaggScheduler

MAXLEN = 24
TOL = 5e-5


@functools.lru_cache(maxsize=None)
def family_params(arch):
    """(reference weights, the same on the port's side) of ``arch`` at
    reduced widths, built once per process.  A vision model's cross gates
    are set to 0.5 (they start at 0), so its image embeddings reach the
    tokens."""
    cfg = ref_base.reduced(ref_base.get_config(arch))
    rp = ref_model.init_params(jax.random.key(0), cfg)
    for bp in rp["blocks"]:
        if "gate" in bp:
            bp["gate"] = jnp.full_like(bp["gate"], 0.5)
    return rp, _bridge.to_torch(jax.tree.map(np.asarray, rp), "cpu")


def frontends(arch, seed):
    """The family's frontend embeddings of one request, as numpy (standard
    normal times 0.1), keyed as the batch dict keys them."""
    cfg = ref_base.reduced(ref_base.get_config(arch))
    n = {"audio": cfg.encoder_seq, "vlm": cfg.image_tokens}.get(cfg.family)
    if n is None:
        return {}
    key = "audio_embeds" if cfg.family == "audio" else "image_embeds"
    return {key: 0.1 * np.random.default_rng(seed).normal(
        size=(1, n, cfg.d_model)).astype(np.float32)}



def tok(p):
    return {"tokens": torch.from_numpy(p).long()}


def setup(params, *, npes=4, num_blocks=32, max_slots=3, block_tokens=8,
           arch="qwen3-4b", max_len=MAXLEN):
    cfg = base.reduced(base.get_config(arch))
    ctx, heap = context.init(npes=npes, node_size=npes, device="cpu")
    eng = Engine(cfg, params, max_len=max_len, device="cpu")
    pool = KVPool.create(heap, cfg, max_len, num_blocks=num_blocks,
                         max_slots=max_slots, block_tokens=block_tokens)
    return cfg, ctx, heap, eng, pool


def port_sched(params, *, decode_pes=(2, 3), num_slots=3, NEW=6, admit_delay=0,
           eos_id=-1, temperature=0.0, seed=0, paged=True, stream_chunks=0,
           shared_prefix=False, **kw):
    cfg, ctx, heap, eng, pool = setup(params, **kw)
    sched = DisaggScheduler(ctx, heap, eng, pool, KVMigrator(ctx, pool),
                            prefill_pes=[0, 1], decode_pes=list(decode_pes),
                            num_slots=num_slots,
                            scfg=ServeConfig(max_new_tokens=NEW,
                                             eos_id=eos_id,
                                             temperature=temperature,
                                             seed=seed),
                            admit_delay_steps=admit_delay, paged=paged,
                            stream_chunks=stream_chunks,
                            shared_prefix=shared_prefix)
    return sched


def telemetry_state(sink):
    """A sink's aggregates per provenance stream: counts, bytes, modeled
    seconds, extremes, log2 size histograms and the sample reservoirs with
    their decimation state."""
    return {src: {k: (b.count, b.bytes_total, b.time_total, b.t_min,
                      b.t_max, dict(b.size_hist), list(b.samples),
                      b._stride, b._seen)
                  for k, b in buckets.items()}
            for src, buckets in sink.sources.items()}


class CountingClock:
    """A stand-in for ``perf_counter``, one per package: every reading is
    1 ms after the last, so two runs that open and close the same scopes in
    the same order measure the same "wall" seconds."""

    def __init__(self):
        self.t = 0.0

    def now(self):
        self.t += 1e-3
        return self.t


def obs_state(obs):
    """What an ``Obs`` bundle holds that a lockstep run must reproduce:
    metrics rows, audit summaries without their wall fields, recorder
    dumps (by count) and window, burn-rate alerts, re-fit history, the
    profiler's samples (under :class:`CountingClock`)."""
    out = {}
    if obs.metrics is not None:
        out["metrics"] = obs.metrics.snapshot()
    if obs.auditor is not None:
        out["audit"] = {k: v for k, v in obs.auditor.summary().items()
                        if k != "audit_seconds"}
    if obs.recorder is not None:
        r = obs.recorder.summary()
        out["recorder"] = (len(r["dumps"]), r["buffered_events"],
                           r["evicted"], r["window_steps"])
    if obs.monitor is not None:
        out["alerts"] = obs.monitor.summary()
    if obs.refitter is not None:
        out["refit"] = [ev.to_json() for ev in obs.refitter.history]
    if obs.prof is not None:
        out["prof"] = [dataclasses.astuple(x) for x in obs.prof.samples]
    return out


def int_pool(heap, ref):
    pool = heap.pools["int32"]
    return np.asarray(pool) if ref else pool.numpy()


def lockstep_prompts(n_req, prefix, S=10):
    """test_disagg.py::_prompts, handed to both packages as numpy.  With
    ``prefix="whole"`` every request is a sample of the first prompt; with
    ``prefix="divergent"`` the requests share its first 8 tokens (one
    block) and end in 4 tokens of their own."""
    prompts = [np.array(jax.random.randint(
        jax.random.fold_in(jax.random.key(1), i), (1, S), 0, 512))
        for i in range(n_req)]
    if prefix == "whole":
        return [prompts[0]] * n_req, S
    if prefix == "divergent":
        rng = np.random.default_rng(7)
        return [np.concatenate([prompts[0][:, :8], rng.integers(
            0, 512, size=(1, 4)).astype(prompts[0].dtype)], axis=1)
            for _ in range(n_req)], 8
    return prompts, 0


def event_tuple(ev):
    return (ev.ph, ev.name, ev.cat, ev.ts, str(ev.pid), str(ev.tid), ev.id)


def same_args(ra, pa):
    """Event args equal key for key; floats (modeled seconds) to 5e-5."""
    ra, pa = ra or {}, pa or {}
    assert sorted(ra) == sorted(pa)
    for k, v in ra.items():
        if isinstance(v, float) or isinstance(pa[k], float):
            assert pa[k] == pytest.approx(float(v), rel=TOL, abs=TOL), k
        else:
            assert pa[k] == v, k


def run_lockstep(case, ref_params, params, monkeypatch):
    """Serve ``case``'s requests on both packages in lockstep and hold
    them to each other after every step (the module docstring), then to
    what the case names: streaming, prefix hits and copy-on-writes, no
    sharing for a ring or multimodal batch, a wrapping ring, embeddings
    that reach the tokens."""
    NEW = 6
    n_req, num_slots, admit_delay = (case["n_req"], case["num_slots"],
                                     case["admit_delay"])
    mode = dict(paged=case.get("paged", True),
                stream_chunks=case.get("stream_chunks", 0),
                shared_prefix="prefix" in case)
    prompts, prefix_len = lockstep_prompts(n_req, case.get("prefix"),
                                            case.get("S", 10))
    arch = case.get("arch", "qwen3_4b")
    max_len = case.get("max_len", MAXLEN)
    embeds = [frontends(arch, 100 + i) for i in range(n_req)]
    # reference side (test_disagg.py::_setup / _run_disagg)
    rcfg = ref_base.reduced(ref_base.get_config(arch))
    rctx, rheap = ref_context.init(npes=4, node_size=4)
    rctx.tracer = RefSpanTracer()
    reng = RefEngine(rcfg, ref_params, max_len=max_len)
    rpool = RefKVPool.create(rheap, rcfg, max_len, num_blocks=32, max_slots=3,
                             block_tokens=8)
    rsched = RefScheduler(rctx, rheap, reng, rpool, RefKVMigrator(rctx, rpool),
                          prefill_pes=[0, 1], decode_pes=[2, 3],
                          num_slots=num_slots,
                          scfg=RefServeConfig(max_new_tokens=NEW),
                          admit_delay_steps=admit_delay, **mode)
    psched = port_sched(params, num_slots=num_slots, NEW=NEW,
                    admit_delay=admit_delay, arch=arch, max_len=max_len,
                    **mode)
    psched.ctx.tracer = SpanTracer()
    rtr, ptr = rctx.tracer, psched.ctx.tracer
    # every decode step's logits, both sides
    rlogits, plogits = [], []
    rdecode = reng._decode
    reng._decode = lambda *a: (lambda out: rlogits.append(
        np.asarray(out[0])) or out)(rdecode(*a))
    pdecode = model.decode_step
    monkeypatch.setattr(engine_mod.model, "decode_step", lambda *a, **kw: (
        lambda out: plogits.append(out[0].numpy()) or out)(pdecode(*a, **kw)))
    for p, emb in zip(prompts, embeds):
        rsched.submit({"tokens": jnp.asarray(p),
                       **{k: jnp.asarray(e) for k, e in emb.items()}},
                      prefix_len=prefix_len)
        psched.submit({**tok(p), **{k: torch.from_numpy(e)
                                     for k, e in emb.items()}},
                      prefix_len=prefix_len)
    steps = 0
    while not (rsched.done() and psched.done()):
        n_ev = len(rtr.events)
        assert len(ptr.events) == n_ev
        rsched.step()
        psched.step()
        steps += 1
        assert steps < 200
        assert [(r.rid, r.state, r.slot, r.decode_pe)
                for r in rsched.requests.values()] == \
            [(r.rid, r.state, r.slot, r.decode_pe)
             for r in psched.requests.values()]
        assert [r.out for r in rsched.requests.values()] == \
            [r.out for r in psched.requests.values()]
        assert rpool.block_tables == psched.pool.block_tables
        assert rpool._refcnt == psched.pool._refcnt
        np.testing.assert_array_equal(int_pool(rsched.heap, True),
                                      int_pool(psched.heap, False))
        for dt, pool in psched.heap.pools.items():
            if dt != "int32":
                want = np.asarray(rsched.heap.pools[dt], np.float32)
                got = pool.float().numpy()
                np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
                nan = np.isnan(want)      # int32 bits (a ring's kpos of -1)
                np.testing.assert_array_equal(got.view(np.int32)[nan],
                                              want.view(np.int32)[nan])
        for f in dataclasses.fields(psched.stats):
            assert getattr(rsched.stats, f.name) == getattr(
                psched.stats, f.name), f.name
        assert [(r.op, r.nbytes, r.path, r.tier, r.work_items, r.t_sec,
                 r.source) for r in rctx.telemetry.trace] == \
            [(r.op, r.nbytes, r.path, r.tier, r.work_items, r.t_sec,
              r.source) for r in psched.ctx.telemetry.trace]
        assert telemetry_state(rctx.telemetry) == \
            telemetry_state(psched.ctx.telemetry)
        assert [event_tuple(e) for e in rtr.events[n_ev:]] == \
            [event_tuple(e) for e in ptr.events[n_ev:]]
        for re_, pe_ in zip(rtr.events[n_ev:], ptr.events[n_ev:]):
            same_args(re_.args, pe_.args)
    for rid, r in rsched.requests.items():
        assert r.out == psched.requests[rid].out
    assert len(rlogits) == len(plogits) > 0
    for a, b in zip(rlogits, plogits):
        np.testing.assert_allclose(b, a, atol=TOL, rtol=TOL)
    assert rctx.pending.stats.coalescing_ratio() == \
        psched.ctx.pending.stats.coalescing_ratio()
    rdoc, pdoc = ref_chrome_trace(rtr), chrome_trace(ptr)
    assert validate(pdoc) == [] and ptr.open_spans() == \
        {"slices": {}, "async": {}}
    assert rdoc["otherData"] == pdoc["otherData"]
    assert len(rdoc["traceEvents"]) == len(pdoc["traceEvents"])
    for re_, pe_ in zip(rdoc["traceEvents"], pdoc["traceEvents"]):
        assert {k: v for k, v in re_.items() if k != "args"} == \
            {k: v for k, v in pe_.items() if k != "args"}
        same_args(re_.get("args"), pe_.get("args"))
    # the cases exercise what they name
    st = psched.stats
    if mode["stream_chunks"]:
        assert st.stream_chunks >= n_req
        assert psched.pool.stats()["streams_active"] == 0
    if case.get("prefix") == "whole" and arch == "qwen3_4b":
        assert (st.prefix_hits, st.cow_copies) == (n_req - 1, n_req)
    if case.get("prefix") == "divergent":
        assert (st.prefix_hits, st.cow_copies) == (n_req - 1, 0)
    sharable = "prefix" in case and not psched.pool.layout.ring and \
        not embeds[0]
    if "prefix" in case and not sharable:
        assert (st.prefix_hits, st.bytes_wire_saved) == (0, 0)
    elif "prefix" in case and not mode["stream_chunks"]:
        assert st.bytes_wire_saved > 0      # resident blocks skipped
    if arch == "h2o_danube_3_4b":
        # the prefill leaves slots 60-63 empty (-1, NaN patterns in the
        # migrated tails), and decode wraps: position 64 lands in slot 0
        lay = psched.pool.layout
        assert lay.ring and lay.blocks_for_decode(60, NEW) == 8
        _, _, cache1 = psched.engine.prefill_request(
            psched.requests[0].batch)
        assert int((cache1["blocks"][0]["kpos"] == -1).sum()) == 2 * 4
        assert max(int(b.cache["blocks"][0]["kpos"].max())
                   for b in psched.banks.values()) == 64
    if embeds[0]:                         # the embeddings reached the tokens
        for rid, req in psched.requests.items():
            plain = dict(req.batch)
            (key,) = embeds[0]
            plain[key] = torch.zeros_like(plain[key])
            if psched.engine.generate_in_slot(
                    plain, psched.scfg, num_slots=num_slots,
                    slot=req.slot) != req.out:
                break
        else:
            pytest.fail("no request's tokens depend on its embeddings")
    assert psched.pool.stats()["blocks_in_use"] == 0




# ---------------------------------------------------------------------------
# the fleet in lockstep
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def fleet_engines(max_len=MAXLEN):
    """(reference Engine, port Engine) over the same reduced qwen3-4b
    weights (f32), built once per process so the reference's jitted
    closures are shared by every fleet."""
    rp, pp = family_params("qwen3_4b")
    cfg = ref_base.reduced(ref_base.get_config("qwen3_4b"))
    return (RefEngine(cfg, rp, max_len=max_len),
            Engine(base.reduced(base.get_config("qwen3-4b")), pp,
                   max_len=max_len, device="cpu"))


def fleet_specs(tenants, *, rate, seed, steps, process="poisson", **kw):
    """One arrival schedule from both packages' traffic engines (the same
    tenant mix, given as dicts): they must agree field for field and
    token for token.  Returns (reference specs, port specs)."""
    from repro.serve.frontend import TenantSpec as RefTenant, \
        TrafficEngine as RefTraffic
    from repro_torch.serve.frontend import TenantSpec, TrafficEngine
    vocab = base.reduced(base.get_config("qwen3-4b")).vocab_size
    rs = RefTraffic([RefTenant(**t) for t in tenants], rate=rate,
                    vocab=vocab, seed=seed, process=process,
                    **kw).schedule(steps)
    ps = TrafficEngine([TenantSpec(**t) for t in tenants], rate=rate,
                       vocab=vocab, seed=seed, process=process,
                       **kw).schedule(steps)
    assert [(a.idx, a.step, a.tenant, a.slo, a.max_new, a.prefix_len)
            for a in rs] == [(b.idx, b.step, b.tenant, b.slo, b.max_new,
                              b.prefix_len) for b in ps]
    for a, b in zip(rs, ps):
        assert a.tokens.dtype == b.tokens.dtype
        np.testing.assert_array_equal(a.tokens, b.tokens)
    return rs, ps


def _ring_counters(proxy):
    if proxy is None:
        return None
    r = proxy.ring
    return (r.write_reserve, r.consumed_published, r.read_index,
            list(r.slot_tag), len(r.delivered),
            [(i, m.payload) for i, m in r.delivered], sorted(r.completions),
            r.spin_count, r.store_ops, r.publish_ops, r.overwrite_errors,
            proxy.backpressure, sorted(proxy._staging))


def same_report(a, b, path="report"):
    """Two fleet reports equal key for key; floats (modeled seconds,
    percentiles, goodput) to 5e-5."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            same_report(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_report(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(float(a), rel=TOL, abs=TOL), path
    else:
        assert a == b, path


def _fleet_state(fleet):
    pods = fleet.pods + fleet.dead_pods
    return ([p.name for p in fleet.pods], [p.name for p in fleet.dead_pods],
            [[(r.rid, r.state, r.slot, r.decode_pe, r.prefill_pe,
               r.preemptions, r.replay_target, r.replayed, list(r.out))
              for r in p.sched.requests.values()] for p in pods],
            [(p.sched.prefill_pes, p.sched.decode_pes,
              {pe: list(v) for pe, v in p.sched.slot_req.items()},
              [r.rid for r in p.sched.queue], [r.rid for r in p.sched.staged],
              [r.rid for r in p.sched.streaming],
              [r.rid for r in p.sched.parked],
              [r.rid for r in p.sched.preempted],
              [r.rid for r in p.sched.migrating]) for p in pods],
            dict(fleet.placements), sorted(fleet.ctx.fault.dead_pes),
            fleet.ctx.fault.dcn_down, [p.name for p in fleet.router.pods],
            dict(fleet.router.stats),
            {k: (e.block_ids, e.whole_prompt, e.home_pe,
                 {pe: sorted(v) for pe, v in e.resident.items()}, e.refs)
             for k, e in fleet.prefix_index.items()})


def run_fleet_lockstep(fleet_kw, tenants, *, rate, seed, steps,
                       fault_plan=None, max_steps=1500, check_every=1,
                       obs=None, obs_dir=None, **traffic_kw):
    """Build the JAX fleet and the port's from ``fleet_kw`` (FleetConfig
    fields), play one arrival schedule into both and step them together.
    After every ``check_every``-th step (and the last) they must agree
    exactly on states, queues, slot owners, placements, the prefix index,
    block tables, refcounts, homes, every int32 heap word, the proxy ring's
    counters, the completion queue's errors and stats and every token;
    float pools to 5e-5 with NaN words (poisoned rows) bit for bit; and
    ``report()`` (floats to 5e-5).  ``obs`` (``Obs`` keyword arguments)
    gives each fleet its package's bundle, with a :class:`CountingClock`
    for a profiler and the recorders' dumps under ``obs_dir``; then
    :func:`obs_state` must agree too (floats to 5e-5), each new dump must
    validate and equal the reference's, and the telemetry's streams agree
    exactly.  Returns (reference fleet, port fleet, port specs, port
    report)."""
    from repro.serve.frontend import Fleet as RefFleet, \
        FleetConfig as RefFleetConfig
    from repro_torch.serve.frontend import Fleet, FleetConfig
    reng, peng = fleet_engines(fleet_kw.get("max_len", MAXLEN))
    rspecs, pspecs = fleet_specs(tenants, rate=rate, seed=seed, steps=steps,
                                 **traffic_kw)
    robs = pobs = None
    if obs is not None:
        from repro.obs import Obs as RefObs
        from repro_torch.obs import Obs
        robs = RefObs(recorder_path=str(obs_dir / "ref_dump.json"), **obs)
        pobs = Obs(recorder_path=str(obs_dir / "port_dump.json"), **obs)
        for o in (robs, pobs):
            if o.prof is not None:
                o.prof.clock = CountingClock()
    rf = RefFleet(RefFleetConfig(**fleet_kw), engine=reng,
                  fault_plan=fault_plan, obs=robs)
    pf = Fleet(FleetConfig(**fleet_kw), engine=peng, fault_plan=fault_plan,
               obs=pobs)
    dumps_seen = [0]

    def check_obs():
        same_report(obs_state(robs), obs_state(pobs), "obs")
        assert telemetry_state(rf.ctx.telemetry) == \
            telemetry_state(pf.ctx.telemetry)
        if pobs.recorder is not None and \
                len(pobs.recorder.dumps) > dumps_seen[0]:
            import json
            dumps_seen[0] = len(pobs.recorder.dumps)
            with open(pobs.recorder.dumps[-1]) as f:
                pdoc = json.load(f)
            with open(robs.recorder.dumps[-1]) as f:
                rdoc = json.load(f)
            assert validate(pdoc) == []
            same_report(rdoc, pdoc, "dump")

    def check():
        assert _fleet_state(rf) == _fleet_state(pf)
        assert rf.pool.block_tables == pf.pool.block_tables
        assert rf.pool._refcnt == pf.pool._refcnt
        assert rf.pool._home == pf.pool._home
        assert sorted(rf.pool._free) == sorted(pf.pool._free)
        assert _ring_counters(rf.proxy) == _ring_counters(pf.proxy)
        assert rf.ctx.pending.errors == pf.ctx.pending.errors
        assert dataclasses.asdict(rf.ctx.pending.stats) == \
            dataclasses.asdict(pf.ctx.pending.stats)
        assert len(rf.ctx.pending) == len(pf.ctx.pending)
        # the allocated words only (past the cursor both rows are zero or,
        # once a PE died, poison, which the chaos tests read whole); plain
        # numpy tests first, numpy.testing's asserts only to report
        assert pf.heap._cursor == rf.heap._cursor
        used = pf.heap._cursor.get("int32", 0)
        ri = np.asarray(rf.heap.pools["int32"][:, :used])
        pi = pf.heap.pools["int32"][:, :used].numpy()
        if not np.array_equal(ri, pi):
            np.testing.assert_array_equal(ri, pi)
        for dt, pool in pf.heap.pools.items():
            if dt == "int32":
                continue
            used = pf.heap._cursor.get(dt, 0)
            want = np.asarray(rf.heap.pools[dt][:, :used], np.float32)
            got = pool[:, :used].float().numpy()
            nan = np.isnan(want)
            if not (np.array_equal(np.isnan(got), nan)
                    and np.all(np.abs(got[~nan] - want[~nan])
                               <= TOL + TOL * np.abs(want[~nan]))
                    and np.array_equal(got.view(np.int32)[nan],
                                       want.view(np.int32)[nan])):
                np.testing.assert_array_equal(np.isnan(got), nan)
                np.testing.assert_allclose(got[~nan], want[~nan], atol=TOL,
                                           rtol=TOL)
                np.testing.assert_array_equal(got.view(np.int32)[nan],
                                              want.view(np.int32)[nan])
        rrep, prep = rf.report(), pf.report()
        assert ("obs" in prep) == (pobs is not None)
        rrep.pop("obs", None)
        prep.pop("obs", None)
        same_report(rrep, prep)
        if pobs is not None:
            check_obs()

    order = sorted(range(len(pspecs)),
                   key=lambda i: (pspecs[i].step, pspecs[i].idx))
    i = 0
    while i < len(order) or not (rf.done() and pf.done()):
        assert pf.elapsed_steps < max_steps, "fleet wedged"
        batch = []
        while i < len(order) and pspecs[order[i]].step <= pf.elapsed_steps:
            batch.append(order[i])
            i += 1
        rf.step([rspecs[j] for j in batch])
        pf.step([pspecs[j] for j in batch])
        if pf.elapsed_steps % check_every == 0:
            check()
    check()
    assert rf.done() and pf.done()
    ro, po = rf.outputs(), pf.outputs()
    assert {k: [int(t) for t in np.asarray(v).ravel()]
            for k, v in ro.items()} == po
    return rf, pf, pspecs, pf.report()
