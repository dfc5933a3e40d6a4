"""The port's chaos harness: deterministic fault injection against the
fleet, held against the JAX package.

Mirrors ``tests/test_fault.py`` without its auditor and postmortem checks
(the observability bundle is not ported yet).  Fault plans, their seeded
random draws, the ``ISHMEM_FAULT_*`` knobs and ``scramble_rows``'s poison
bits must agree exactly with the reference.  Every chaos run steps the
port's fleet in lockstep with the reference's
(``_torch_lockstep.run_fleet_lockstep``: states, tables, refcounts, int32
heap words, ring counters, ``errors`` records, reports and tokens exact,
float pools to 5e-5, poisoned rows bit for bit), and then holds the port's
to the acceptance law against its own no-fault control run: no surviving
request decodes a token that differs from the control's (zero wrong
tokens), every request ends in a terminal state, the shared pool unwinds
to zero blocks, and every dead PE's rows hold the poison bit for bit.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import context as ref_context
from repro.serve.fault import FaultPlan as RefFaultPlan, \
    load_fault_env as ref_load_fault_env, scramble_rows as ref_scramble
from repro_torch import _bridge
from repro_torch.core import context
from repro_torch.serve.fault import FaultPlan, load_fault_env, scramble_rows
from repro_torch.serve.frontend import Fleet, FleetConfig
from repro_torch.serve.scheduler import TERMINAL

from _torch_lockstep import MAXLEN, fleet_engines, fleet_specs, \
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
              stream_chunks=1, admission="fcfs", router="affinity", seed=11,
              queue_bound=64)
    kw.update(over)
    return kw


@functools.lru_cache(maxsize=None)
def _control(seed, shape=()):
    """The port's no-fault outputs of workload ``seed`` at fleet shape
    ``shape`` (FleetConfig overrides as a tuple of pairs)."""
    _, specs = fleet_specs(MIX, rate=1.0, seed=seed, steps=6)
    fleet = Fleet(FleetConfig(**_fleet_kw(**dict(shape))),
                  engine=fleet_engines()[1])
    rep = fleet.run(specs)
    return fleet.outputs(), rep


def _chaos(plan, seed=11, shape=()):
    """The chaos run in lockstep with the reference's, then the acceptance
    law against the port's control (module docstring).  Returns the port's
    fleet and report."""
    control, _ = _control(seed, tuple(shape))
    _, pf, specs, rep = run_fleet_lockstep(
        _fleet_kw(**dict(shape)), MIX, rate=1.0, seed=seed, steps=6,
        fault_plan=plan)
    outs = pf.outputs()
    wrong = [s.idx for s in specs
             if outs[s.idx] and outs[s.idx] != control[s.idx]]
    assert not wrong, f"wrong tokens on surviving requests {wrong}"
    for pod in pf.pods + pf.dead_pods:
        for r in pod.sched.requests.values():
            assert r.state in TERMINAL, (pod.name, r.rid, r.state)
    ps = pf.pool.stats()
    assert (ps["blocks_in_use"], ps["streams_active"],
            ps["requests_resident"]) == (0, 0, 0), ps
    _assert_poisoned(pf.heap, sorted(pf.ctx.fault.dead_pes))
    return pf, rep


def _assert_poisoned(heap, pes):
    for dt, pool in heap.pools.items():
        for pe in pes:
            row = pool[pe]
            if row.dtype.is_floating_point:
                bits = row.view(torch.int16 if row.element_size() == 2
                                else torch.int32)
                want = 0x7FC0 if row.element_size() == 2 else 0x7FC00000
                assert bool((bits == want).all()), (dt, pe)
            else:
                assert bool((row == torch.iinfo(row.dtype).min + 1).all()), \
                    (dt, pe)


# ---------------------------------------------------------------------------
# FaultPlan grammar, seeding, env knobs, poisoning (no model)
# ---------------------------------------------------------------------------


def _events(plan):
    return [(e.step, e.kind, e.arg) for e in plan.events], plan.seed


def test_fault_plan_grammar_roundtrip_and_validation():
    spec = " kill_pod=pod1@6, kill_pe=4@2 ,partition=3@8"
    plan = FaultPlan.parse(spec)
    assert _events(plan) == _events(RefFaultPlan.parse(spec))
    assert [e.spec() for e in plan.events] == \
        ["kill_pe=4@2", "kill_pod=pod1@6", "partition=3@8"]
    assert FaultPlan.parse(plan.spec()) == plan
    assert FaultPlan.parse("").events == ()
    for bad in ("kill_pe=4", "explode=1@2", "kill_pe=x@2", "kill_pe=4@-1",
                "partition=-3@2", "kill_pe@2"):
        for parse in (FaultPlan.parse, RefFaultPlan.parse):
            with pytest.raises(ValueError):
                parse(bad)


def test_fault_plan_random_is_pure_function_of_seed():
    kw = dict(max_step=10, pes=(1, 2, 4, 5), pods=("pod0", "pod1"),
              n_events=3)
    for seed in range(12):
        a = FaultPlan.random(seed, **kw)
        assert a == FaultPlan.random(seed, **kw)
        assert _events(a) == _events(RefFaultPlan.random(seed, **kw))
        assert all(e.kind in ("kill_pe", "kill_pod", "partition")
                   for e in a.events)
    assert FaultPlan.random(7, **kw) != FaultPlan.random(8, **kw)
    assert _events(FaultPlan.random(3, max_step=6, pes=(2,))) == \
        _events(RefFaultPlan.random(3, max_step=6, pes=(2,)))
    with pytest.raises(ValueError):
        FaultPlan.random(0, max_step=10)


def test_fault_env_knobs():
    for load in (load_fault_env, ref_load_fault_env):
        cfg = load({"ISHMEM_FAULT_PLAN": "kill_pe=2@3",
                    "ISHMEM_FAULT_SEED": "5"})
        assert (cfg.plan, cfg.seed) == ("kill_pe=2@3", 5)
        assert load({}) == load({"ISHMEM_FAULT_PLAN": ""})
        for bad in ({"ISHMEM_FAULT_PLAN": "explode=1@2"},
                    {"ISHMEM_FAULT_SEED": "many"},
                    {"ISHMEM_FAULT_SEED": "-1"}):
            with pytest.raises(ValueError):
                load(bad)


def test_scramble_rows_poisons_only_dead_rows():
    """The same dead rows poisoned with the same bits as the reference's,
    in each pool dtype the port keeps; live rows untouched."""
    rng = np.random.default_rng(0)
    vals = {"float32": rng.normal(size=8).astype(np.float32),
            "bfloat16": rng.normal(size=16).astype(np.float32),
            "int32": rng.integers(-9, 9, 4).astype(np.int32)}
    rctx, rheap = ref_context.init(npes=4, node_size=4)
    pctx, pheap = context.init(npes=4, node_size=4, device="cpu")
    for dt, v in vals.items():
        rp = rheap.malloc(v.shape, dt)
        pp = pheap.malloc(v.shape, dt)
        for pe in range(4):
            rheap = rheap.write(rp, pe, jnp.asarray(v + pe).astype(dt))
            pheap = pheap.write(pp, pe, torch.from_numpy(v + pe).to(
                getattr(torch, dt)))
    rheap = ref_scramble(rheap, [2])
    pheap = scramble_rows(pheap, [2])
    assert sorted(rheap.pools) == sorted(pheap.pools)
    for dt in pheap.pools:
        want = _bridge.array_to_torch(np.asarray(rheap.pools[dt]), "cpu")
        got = pheap.pools[dt]
        bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
        assert torch.equal(want.view(bits), got.view(bits)), dt
    _assert_poisoned(pheap, [2])
    for dt, v in vals.items():
        for pe in (0, 1, 3):
            row = pheap.pools[dt][pe]
            assert not bool(torch.isnan(row.float()).any()) if \
                row.dtype.is_floating_point else \
                bool((row != torch.iinfo(row.dtype).min + 1).any())


# ---------------------------------------------------------------------------
# chaos: kill grid, random plans, drain/join, escalation
# ---------------------------------------------------------------------------
# pod0 = PE 0 (prefill) + PEs 1, 2 (decode); pod1 = PE 3 + PEs 4, 5


@pytest.mark.parametrize("workload_seed", (11, 23))
@pytest.mark.parametrize("victim_pe", (2, 4))
@pytest.mark.parametrize("kill_step", (2, 4))
def test_chaos_kill_grid_zero_wrong_tokens_no_leaks(workload_seed,
                                                    victim_pe, kill_step):
    pf, rep = _chaos(f"kill_pe={victim_pe}@{kill_step}", seed=workload_seed)
    assert victim_pe in pf.ctx.fault.dead_pes
    assert rep["fault"]["dead_pes"] == [victim_pe]


@pytest.mark.parametrize("chaos_seed", (0, 1, 2, 3))
def test_chaos_random_plan_sweep(chaos_seed):
    """Seeded random plans mixing PE kills, whole-pod loss and partitions
    (the reference's draws, so the same plans): the same law."""
    plan = FaultPlan.random(chaos_seed, max_step=6, pes=(1, 2, 4, 5),
                            pods=("pod0", "pod1"), n_events=2)
    pf, rep = _chaos(plan)
    assert [(e["step"], e["kind"], e["arg"]) for e in rep["fault"]["events"]
            if e["kind"] != "heal"] == _events(plan)[0]


def test_chaos_drain_join_loses_nothing():
    """Drain and join are not failures: every request completes with the
    control's tokens and the drained pod rejoins the rotation."""
    pf, rep = _chaos("drain=pod0@1,join=pod0@5")
    control, rep0 = _control(11)
    assert rep["completed"] == rep0["completed"] == rep["offered"]
    assert pf.outputs() == control
    assert len(pf.router.pods) == 2


def test_chaos_lone_prefill_kill_escalates_to_adoption():
    pf, _ = _chaos("kill_pe=0@2")
    assert [p.name for p in pf.dead_pods] == ["pod0"]
    assert [p.name for p in pf.pods] == ["pod1"]


# ---------------------------------------------------------------------------
# seeded regression scenarios
# ---------------------------------------------------------------------------


def test_regression_kill_decode_pe_mid_stream():
    """A decode PE dies with streams in flight to it: its requests
    re-migrate from live home PEs and replay their decoded tokens."""
    _, rep = _chaos("kill_pe=4@5")
    recov = rep["recovered"]
    assert recov["remigrated"] >= 1 and recov["replayed_tokens"] >= 1
    assert recov["recovered_requests"] >= 1


def test_regression_kill_prefill_pe_with_staged_blocks():
    """A prefill PE dies holding staged blocks (two prefill PEs a pod, so
    no escalation): prefix entries homed on it drop and victims recompute
    from the prompt."""
    shape = (("prefill_per_pod", 2), ("decode_per_pod", 2))
    pf, rep = _chaos("kill_pe=0@4", shape=shape)
    assert rep["recovered"]["recomputed"] >= 1
    assert pf.pods[0].name == "pod0" and 0 not in pf.pods[0].sched.prefill_pes


def test_regression_partition_parks_cross_pod_traffic():
    """The dcn fabric partitions for 3 steps: cross-pod ops stay queued,
    the heal drains them, and nothing is a casualty."""
    shape = (("router", "random"),)
    pf, rep = _chaos("partition=3@2", shape=shape)
    control, rep0 = _control(11, shape)
    assert not pf.ctx.fault.dcn_down
    assert rep["completed"] == rep0["completed"] == rep["offered"]
    assert pf.outputs() == control
    assert [e["kind"] for e in rep["fault"]["events"]] == ["partition",
                                                           "heal"]


def test_regression_whole_pod_adoption():
    """Whole-pod loss: survivors adopt the dead pod's requests under new
    rids with full token replay; the report carries the fault record."""
    pf, rep = _chaos("kill_pod=pod1@3")
    assert rep["fault"]["dead_pods"] == ["pod1"]
    assert sorted(rep["fault"]["dead_pes"]) == [3, 4, 5]
    assert [e["kind"] for e in rep["fault"]["events"]] == ["kill_pod"]
    assert rep["recovered"]["recovered_requests"] >= 1
