"""The port's cluster frontend — traffic engine, router, SLO admission,
preemption, parked streams, the host-proxy ring under a migration storm and
the fleet — held against the JAX package.

Mirrors ``tests/test_fleet.py``.  Schedules, env knobs, the policy's
choices and percentiles must agree exactly.  Schedulers and fleets step in
lockstep with the reference's at reduced widths in f32 (``_sched_pair``
here, ``_torch_lockstep.run_fleet_lockstep`` for fleets): after each step
states, queues, slot owners, block tables, refcounts, every int32 heap
word, the proxy ring's counters, ``report()`` and every token agree
exactly, float pools to 5e-5.  Every completed request's tokens also equal
the port's single-PE ``Engine.generate`` (greedy), whatever the schedule.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import context as ref_context, proxy as ref_proxy
from repro.serve.frontend import SLOPolicy as RefSLOPolicy, \
    load_fleet_env as ref_load_fleet_env, percentile as ref_percentile
from repro.serve.frontend import slo as ref_slo
from repro.serve.kvpool import KVPool as RefKVPool
from repro.serve.kvxfer import KVMigrator as RefKVMigrator
from repro.serve.scheduler import DisaggScheduler as RefScheduler, \
    Request as RefRequest
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.core import context, proxy
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.frontend import SLOPolicy, load_fleet_env, \
    percentile
from repro_torch.serve.frontend import slo as slo_mod
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.kvxfer import KVMigrator
from repro_torch.serve.scheduler import DECODING, FINISHED, SHED, \
    DisaggScheduler, Request

from _torch_lockstep import MAXLEN, fleet_engines, fleet_specs, int_pool, \
    run_fleet_lockstep
from _torch_threads import one_intra_op_thread  # noqa: F401

NEW = 4
MIX = (dict(name="chat", weight=2.0, prompt_lens=(8,), max_new=(NEW,),
            slo="interactive"),
       dict(name="scan", weight=1.0, prompt_lens=(12,), max_new=(NEW,),
            slo="batch", shared_prefix_prob=0.5, prefix_groups=1))


def _fleet_kw(**over):
    kw = dict(n_pods=2, prefill_per_pod=1, decode_per_pod=2, num_slots=2,
              kv_blocks=96, block_tokens=4, max_len=MAXLEN, max_new=NEW,
              stream_chunks=1, admission="slo", router="affinity", seed=11)
    kw.update(over)
    return kw


def _baseline(spec):
    _, eng = fleet_engines()
    return eng.generate({"tokens": torch.from_numpy(spec.tokens).long()},
                        ServeConfig(max_new_tokens=spec.max_new))[0].tolist()


def _vocab():
    return fleet_engines()[1].cfg.vocab_size


# ---------------------------------------------------------------------------
# traffic engine, env knobs, percentiles
# ---------------------------------------------------------------------------


def test_traffic_schedule_is_deterministic():
    """One (seed, tenants, rate) gives one schedule, on both packages, the
    shared prefix-group prompts included; another seed differs."""
    _, sa = fleet_specs(MIX, rate=1.0, seed=5, steps=16)
    _, sb = fleet_specs(MIX, rate=1.0, seed=5, steps=16)
    assert len(sa) == len(sb) > 0
    for x, y in zip(sa, sb):
        assert (x.step, x.tenant, x.slo, x.max_new, x.prefix_len) == \
            (y.step, y.tenant, y.slo, y.max_new, y.prefix_len)
        np.testing.assert_array_equal(x.tokens, y.tokens)
    _, sc = fleet_specs(MIX, rate=1.0, seed=6, steps=16)
    assert [s.step for s in sc] != [s.step for s in sa] or \
        any(not np.array_equal(x.tokens, y.tokens) for x, y in zip(sa, sc))


def test_traffic_bursty_and_mix_accounting():
    from repro.serve.frontend import TenantSpec as RefTenant, \
        TrafficEngine as RefTraffic
    from repro_torch.serve.frontend import TenantSpec, TrafficEngine
    kw = dict(rate=1.0, vocab=_vocab(), seed=9, process="bursty",
              burst_len=4, burst_factor=4.0)
    rs, specs = fleet_specs(MIX, steps=64, **{k: v for k, v in kw.items()
                                               if k != "vocab"})
    counts = np.bincount([s.step for s in specs], minlength=64)
    assert counts.var() > counts.mean()          # overdispersed
    ref_load = RefTraffic([RefTenant(**t) for t in MIX],
                          **kw).offered_load(rs)
    load = TrafficEngine([TenantSpec(**t) for t in MIX],
                         **kw).offered_load(specs)
    assert load == ref_load and load["requests"] == len(specs)
    assert set(load["by_slo"]) <= {"interactive", "batch"}
    shared = [s for s in specs if s.prefix_len > 0]
    assert shared and all(s.prefix_len == s.prompt_len for s in shared)
    assert len({s.prefix_key() for s in shared}) == 1


def test_fleet_env_knobs():
    env = {"ISHMEM_FLEET_PODS": "3", "ISHMEM_FLEET_ROUTER": "least_loaded",
           "ISHMEM_FLEET_ADMISSION": "fcfs",
           "ISHMEM_FLEET_QUEUE_BOUND": "7", "ISHMEM_FLEET_SEED": "2",
           "ISHMEM_FLEET_STREAM_CHUNKS": "0"}
    for load in (ref_load_fleet_env, load_fleet_env):
        cfg = load(env)
        assert (cfg.pods, cfg.router, cfg.admission, cfg.queue_bound,
                cfg.seed, cfg.stream_chunks) == (3, "least_loaded", "fcfs",
                                                 7, 2, 0)
        assert load({}).router == "affinity"
        for bad in ({"ISHMEM_FLEET_ROUTER": "psychic"},
                    {"ISHMEM_FLEET_QUEUE_BOUND": "0"},
                    {"ISHMEM_FLEET_PODS": "two"}):
            with pytest.raises(ValueError):
                load(bad)
    assert dataclasses.asdict(load_fleet_env(env)) == \
        dataclasses.asdict(ref_load_fleet_env(env))


def test_percentile_helper():
    for pct in (percentile, ref_percentile):
        assert pct([], 99) == 0.0
        assert pct([3.0], 50) == 3.0
        xs = list(range(1, 101))
        assert pct(xs, 50) == pytest.approx(50.5)
        assert pct(xs, 99) == pytest.approx(99.01)
        assert pct(xs, 0) == 1.0 and pct(xs, 100) == 100.0
    rng = np.random.default_rng(3)
    xs = rng.normal(size=37).tolist()
    for q in (0, 13, 50, 99, 100):
        assert percentile(xs, q) == ref_percentile(xs, q)


# ---------------------------------------------------------------------------
# SLO policy units (no model, no heap), both packages
# ---------------------------------------------------------------------------


def _req(cls, rid, slo, arrival=0, out_len=0, state=DECODING, preempts=0):
    r = cls(rid=rid, batch={"tokens": np.zeros((1, 4), np.int32)},
            max_new=NEW, slo=slo)
    r.arrival_step = arrival
    r.out = [1] * out_len
    r.state = state
    r.preemptions = preempts
    return r


@pytest.mark.parametrize("side", ["port", "ref"])
def test_slo_policy_orders_sheds_and_preempts(side):
    Pol, Req, mod = ((SLOPolicy, Request, slo_mod) if side == "port"
                     else (RefSLOPolicy, RefRequest, ref_slo))
    pol = Pol(queue_bound=2)
    q = [_req(Req, 0, "batch", arrival=0), _req(Req, 1, "interactive", 5),
         _req(Req, 2, "interactive", arrival=3)]
    assert pol.select(q) == 2
    assert [r.rid for r in pol.waiting_order(q)] == [2, 1, 0]
    assert not pol.admit(_req(Req, 3, "batch"), queue_len=2)
    assert pol.admit(_req(Req, 3, "interactive"), queue_len=2)
    assert not pol.admit(_req(Req, 3, "interactive"), queue_len=4)
    decoding = [_req(Req, 4, "batch", out_len=3),
                _req(Req, 5, "batch", out_len=1),
                _req(Req, 6, "interactive", out_len=9)]
    assert pol.preempt_victim(_req(Req, 7, "interactive"), decoding).rid == 4
    assert pol.preempt_victim(_req(Req, 8, "batch"), decoding) is None
    immune = [_req(Req, 9, "batch", out_len=3, preempts=pol.max_preemptions)]
    assert pol.preempt_victim(_req(Req, 10, "interactive"), immune) is None
    assert mod.resolve("no-such-class").name == mod.DEFAULT_CLASS
    assert {k: dataclasses.asdict(v) for k, v in mod.CLASSES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_slo.CLASSES.items()}


# ---------------------------------------------------------------------------
# one scheduler per package, in lockstep
# ---------------------------------------------------------------------------


def _sched_pair(*, npes=4, node_size=4, num_blocks=48, max_slots=2,
                max_streams=16, max_new=NEW, policy=None, proxy_slots=None,
                coalesce=True, **kw):
    """(reference scheduler, port scheduler) over the same reduced weights,
    built alike; ``policy`` is "slo" or None; ``proxy_slots`` attaches a
    host proxy of that many slots to each migrator."""
    reng, peng = fleet_engines()
    rctx, rheap = ref_context.init(npes=npes, node_size=node_size)
    pctx, pheap = context.init(npes=npes, node_size=node_size, device="cpu")
    if not coalesce:
        rctx.tuning = dataclasses.replace(rctx.tuning, nbi_coalesce=False)
        pctx.tuning = dataclasses.replace(pctx.tuning, nbi_coalesce=False)
    rpool = RefKVPool.create(rheap, reng.cfg, MAXLEN, num_blocks=num_blocks,
                             max_slots=max_slots, block_tokens=4,
                             max_streams=max_streams)
    ppool = KVPool.create(pheap, peng.cfg, MAXLEN, num_blocks=num_blocks,
                          max_slots=max_slots, block_tokens=4,
                          max_streams=max_streams)
    rpx = ppx = None
    if proxy_slots:
        rpx = ref_proxy.HostProxy(rctx, slots=proxy_slots)
        ppx = proxy.HostProxy(pctx, slots=proxy_slots)
    kw.setdefault("prefill_pes", [0, 1])
    kw.setdefault("decode_pes", [2, 3])
    kw.setdefault("num_slots", 1)
    rs = RefScheduler(rctx, rheap, reng, rpool,
                      RefKVMigrator(rctx, rpool, proxy=rpx),
                      scfg=RefServeConfig(max_new_tokens=max_new),
                      policy=RefSLOPolicy(queue_bound=64) if policy else None,
                      **kw)
    ps = DisaggScheduler(pctx, pheap, peng, ppool,
                         KVMigrator(pctx, ppool, proxy=ppx),
                         scfg=ServeConfig(max_new_tokens=max_new),
                         policy=SLOPolicy(queue_bound=64) if policy else None,
                         **kw)
    return rs, ps


def _submit(pair, prompt, **kw):
    import jax.numpy as jnp
    rs, ps = pair
    a = rs.submit({"tokens": jnp.asarray(prompt)}, **kw)
    b = ps.submit({"tokens": torch.from_numpy(prompt).long()}, **kw)
    assert a == b
    return b


def _step_pair(pair, n=None):
    """Step both schedulers ``n`` times (None: until both are done),
    holding them to each other after every step."""
    rs, ps = pair
    k = 0
    while (n is None and not (rs.done() and ps.done())) or \
            (n is not None and k < n):
        rs.step()
        ps.step()
        k += 1
        assert k < 400, "wedged"
        assert [(r.rid, r.state, r.slot, r.decode_pe, r.preemptions, r.out)
                for r in rs.requests.values()] == \
            [(r.rid, r.state, r.slot, r.decode_pe, r.preemptions, r.out)
             for r in ps.requests.values()]
        assert rs.pool.block_tables == ps.pool.block_tables
        assert rs.pool._refcnt == ps.pool._refcnt
        ri, pi = int_pool(rs.heap, True), int_pool(ps.heap, False)
        if not np.array_equal(ri, pi):
            np.testing.assert_array_equal(ri, pi)
        used = ps.heap._cursor["float32"]
        want = np.asarray(rs.heap.pools["float32"][:, :used])
        got = ps.heap.pools["float32"][:, :used].numpy()
        if not np.all(np.abs(got - want) <= 5e-5 + 5e-5 * np.abs(want)):
            np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-5)
        for f in dataclasses.fields(ps.stats):
            assert getattr(rs.stats, f.name) == pytest.approx(
                getattr(ps.stats, f.name), rel=5e-5, abs=5e-5), f.name


def _prompts(n, S, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, _vocab(), (1, S)).astype(np.int32)
            for _ in range(n)]


def test_preemption_resume_is_bitwise():
    """A batch request is preempted mid-decode by a later interactive one
    (one slot a decode PE) and resumes on the same PE; every stream equals
    its uninterrupted baseline."""
    pair = _sched_pair(policy="slo", max_new=12)
    p = _prompts(3, 10, 0)
    _submit(pair, p[0], max_new=12, slo="batch")
    _submit(pair, p[1], max_new=12, slo="batch")
    _step_pair(pair, 4)
    ps = pair[1]
    assert all(r.state == DECODING for r in ps.requests.values())
    _submit(pair, p[2], max_new=4, slo="interactive")
    _step_pair(pair)
    assert ps.stats.preempts >= 1 and ps.stats.resumes == ps.stats.preempts
    preempted = [r for r in ps.requests.values() if r.preemptions]
    assert preempted and all(r.state == FINISHED for r in preempted)
    _, eng = fleet_engines()
    for rid, (prompt, n) in enumerate([(p[0], 12), (p[1], 12), (p[2], 4)]):
        base = eng.generate({"tokens": torch.from_numpy(prompt).long()},
                            ServeConfig(max_new_tokens=n))
        assert base[0].tolist() == ps.requests[rid].out
    assert ps.pool.stats()["blocks_in_use"] == 0


def test_preemption_with_shared_prefix_and_cow():
    """Preempting a mapper of a shared prefix keeps its un-fired COW
    reserve alive across the park (``detach_keep``; refcounts exact), and
    the resumed decode still matches the baseline."""
    pair = _sched_pair(policy="slo", max_new=10, decode_pes=[2],
                       shared_prefix=True)
    p = _prompts(1, 10, 1)[0]
    _submit(pair, p, max_new=10, prefix_len=10, slo="batch")
    _step_pair(pair, 3)
    ps = pair[1]
    assert ps.requests[0].state == DECODING
    _submit(pair, p, max_new=4, prefix_len=10, slo="interactive")
    _step_pair(pair)
    assert ps.stats.preempts >= 1
    _, eng = fleet_engines()
    for rid, n in ((0, 10), (1, 4)):
        assert eng.generate({"tokens": torch.from_numpy(p).long()},
                            ServeConfig(max_new_tokens=n))[0].tolist() == \
            ps.requests[rid].out
    assert ps.pool.stats()["blocks_in_use"] == 0


def test_parked_stream_beats_whole_prefill_at_one_slot():
    """One slot a decode PE: streamed blocks park in the pool and the slot
    binds at close, so the admission wire window shrinks against the
    whole-prefill hand-off; every stream signal word is recycled."""
    runs = {}
    prompts = _prompts(4, 12, 2)
    for stream in (0, 1):
        pair = _sched_pair(num_blocks=64, stream_chunks=stream,
                           admit_delay_steps=1)
        for p in prompts:
            _submit(pair, p)
        _step_pair(pair)
        runs[stream] = pair[1]
    for rid in runs[0].requests:
        assert runs[0].requests[rid].out == runs[1].requests[rid].out
    assert np.mean(runs[1].stats.ttfd_model_s) < \
        np.mean(runs[0].stats.ttfd_model_s)
    st = runs[1]
    assert len(st.pool._stream_free) == st.pool.max_streams
    for i in range(st.pool.max_streams):
        for pe in (2, 3):
            assert int(st.heap.read(st.pool.stream_sig_ptr(i), pe)) == 0


def test_stream_signal_exhaustion_backpressures():
    pair = _sched_pair(num_blocks=64, max_streams=1, stream_chunks=1)
    prompts = _prompts(4, 12, 3)
    for p in prompts:
        _submit(pair, p)
    _step_pair(pair)
    ps = pair[1]
    assert ps.stats.stalled_on_streams > 0
    _, eng = fleet_engines()
    for i, p in enumerate(prompts):
        assert eng.generate({"tokens": torch.from_numpy(p).long()},
                            ServeConfig(max_new_tokens=NEW))[0].tolist() == \
            ps.requests[i].out


def test_arrival_time_threads_into_latency_stats():
    pair = _sched_pair()
    _submit(pair, _prompts(1, 8, 4)[0], arrival_step=-5, t_arrival=-1.0)
    _step_pair(pair)
    st = pair[1].stats
    assert st.ttfd_arrival_steps[0] == st.ttfd_steps[0] + 5
    assert st.queue_delay_steps[0] == 5
    assert st.ttfd_arrival_model_s[0] > st.ttfd_model_s[0]
    req = pair[1].requests[0]
    assert req.finish_step >= req.admit_step >= req.prefill_step
    assert st.e2e_steps[0] == req.finish_step + 5


def test_migration_storm_backpressures_bounded_ring():
    """A cross-pod migration storm through a 2-slot host-proxy ring, write
    combining off so every block is its own ring message: the flush drains
    the ring mid-run (backpressure) instead of wedging or dropping, and
    every stream decodes its baseline's tokens."""
    pair = _sched_pair(node_size=2, num_blocks=64, max_slots=3, num_slots=3,
                       proxy_slots=2, coalesce=False, admit_delay_steps=1)
    prompts = _prompts(6, 12, 5)
    for p in prompts:
        _submit(pair, p)
    _step_pair(pair)
    rs, ps = pair
    px = ps.migrator.proxy
    assert px.backpressure == rs.migrator.proxy.backpressure > 0
    assert px.ring.overwrite_errors == 0
    assert len(px.ring.delivered) == len({i for i, _ in px.ring.delivered})
    assert len(px.ring.delivered) == len(rs.migrator.proxy.ring.delivered)
    assert ps.stats.bytes_cross_pod == ps.stats.bytes_migrated > 0
    _, eng = fleet_engines()
    for i, p in enumerate(prompts):
        assert eng.generate({"tokens": torch.from_numpy(p).long()},
                            ServeConfig(max_new_tokens=NEW))[0].tolist() == \
            ps.requests[i].out


# ---------------------------------------------------------------------------
# fleets in lockstep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("router,admission,seed",
                         [("random", "slo", 11), ("round_robin", "fcfs", 13),
                          ("affinity", "slo", 17)])
def test_fleet_outputs_bitwise_under_any_routing(router, admission, seed):
    """random / round-robin / affinity routing x FCFS / SLO admission, with
    preemption and shared prefixes in play: the port's fleet steps with
    the reference's, and every completed request equals its baseline."""
    _, pf, specs, rep = run_fleet_lockstep(
        _fleet_kw(router=router, admission=admission, seed=seed,
                  num_slots=1, queue_bound=64), MIX, rate=1.0, seed=seed,
        steps=10)
    assert rep["completed"] == rep["offered"] == len(specs) > 0
    outs = pf.outputs()
    for spec in specs:
        assert _baseline(spec) == outs[spec.idx]
    assert pf.pool.stats()["blocks_in_use"] == 0


def test_fleet_slo_beats_fcfs_and_sheds_past_bound():
    """One overloaded schedule twice: SLO admission lowers interactive p99
    TTFD-from-arrival against FCFS, sheds past its bound (as SHED, not
    wedged) and preempts."""
    heavy = (dict(name="chat", prompt_lens=(8,), max_new=(NEW,),
                  slo="interactive"),
             dict(name="scan", prompt_lens=(12,), max_new=(12,),
                  slo="batch"))
    from repro_torch.serve.frontend import Fleet, FleetConfig
    kw = dict(router="least_loaded", num_slots=1, queue_bound=3,
              kv_blocks=128, stream_chunks=2)
    # the SLO arm in lockstep with the reference's; the FCFS control on
    # the port alone (the comparison is between the port's two arms)
    _, pf, _, slo = run_fleet_lockstep(
        _fleet_kw(admission="slo", **kw), heavy, rate=3.0, seed=23,
        steps=16, max_steps=2500, check_every=4)
    sheds = [r for pod in pf.pods
             for r in pod.sched.requests.values() if r.state == SHED]
    assert len(sheds) == slo["shed"]
    _, specs = fleet_specs(heavy, rate=3.0, seed=23, steps=16)
    fcfs = Fleet(FleetConfig(**_fleet_kw(admission="fcfs", **kw)),
                 engine=fleet_engines()[1]).run(specs, max_steps=2500)
    reports = {"slo": slo, "fcfs": fcfs}
    assert reports["slo"]["by_class"]["interactive"]["ttfd_p99_steps"] < \
        reports["fcfs"]["by_class"]["interactive"]["ttfd_p99_steps"]
    assert reports["slo"]["shed"] > 0 and reports["slo"]["preempts"] >= 1


def test_fleet_affinity_reduces_cross_pod_bytes():
    """Prefix-affinity routing against seeded-random routing on a
    shared-prefix workload: affinity pulls fewer bytes across pods (the
    proxy ring carries the difference)."""
    tenants = (dict(name="samples", prompt_lens=(12,), max_new=(NEW,),
                    slo="standard", shared_prefix_prob=0.8,
                    prefix_groups=1),)
    moved, delivered = {}, {}
    for router in ("random", "affinity"):
        _, pf, _, rep = run_fleet_lockstep(
            _fleet_kw(router=router, seed=5), tenants, rate=0.6, seed=5,
            steps=20, check_every=8)
        assert rep["completed"] == rep["offered"]
        moved[router] = rep["wire"]["bytes_cross_pod"]
        delivered[router] = rep["proxy"]["delivered"]
    assert moved["random"] > 0 and delivered["random"] > 0
    assert moved["affinity"] < moved["random"]
