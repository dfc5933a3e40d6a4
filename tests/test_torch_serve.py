"""The whole slice: the port's disaggregated paged serving against the
JAX package's, plus the port's own serving laws.

The cross-package run uses the config, weights, prompts and flags of
``tests/test_disagg.py::_run_disagg`` (reduced qwen3-4b in f32, 4 PEs, 4-5
requests over 2 decode PEs), whole-prefill, streamed, with shared
prefixes and dense-rehydrated, and reduced zamba2 streamed (its Mamba2
states ride the f32 tail); the runner, ``tests/_torch_lockstep.py``, also
serves the seven other configurations in ``tests/test_torch_families.py``.
Both schedulers step in lockstep, each
with a span tracer, and after every step the control plane must agree
exactly: request states, block tables, refcounts, every int32 heap word
(signals, stream signals, headers), the telemetry record sequence, the
scheduler counters, the step's trace events and the tokens.  Float payloads —
pool bytes and each step's logits — agree to 5e-5 (f32 sums in another
order, as in ``test_torch_model.py``).  The JAX side keeps its defaults
(no kernels); ``test_torch_kernels.py`` covers the kernels one by one.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.core import context as ref_context, teams as ref_teams
from repro.models import model as ref_model
from repro.serve.engine import Engine as RefEngine, \
    ServeConfig as RefServeConfig
from repro.serve.kvpool import KVPool as RefKVPool
from repro.serve.kvxfer import KVMigrator as RefKVMigrator
from repro.serve.scheduler import DisaggScheduler as RefScheduler
from repro_torch import _bridge
from repro_torch.core import signal as signal_mod
from repro_torch.launch import serve as launch_serve
from repro_torch.obs.export import chain_gaps, request_chains_doc, validate
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.kvxfer import KVMigrator, expected_signal
from repro_torch.serve.scheduler import DisaggScheduler

from _torch_lockstep import MAXLEN, TOL, family_params, port_sched as _sched, \
    run_lockstep, setup as _setup, tok as _tok
from _torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def ref_params():
    cfg = ref_base.reduced(ref_base.get_config("qwen3_4b"))
    return ref_model.init_params(jax.random.key(0), cfg)


@pytest.fixture(scope="module")
def params(ref_params):
    return _bridge.to_torch(jax.tree.map(np.asarray, ref_params), "cpu")


def _prompts(n, S=10, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=(1, S)).astype(np.int32)
            for _ in range(n)]


def _run(params, prompts, **kw):
    sched = _sched(params, **kw)
    for p in prompts:
        sched.submit(_tok(p))
    return sched, sched.run()


# ---------------------------------------------------------------------------
# the slice against the JAX package
# ---------------------------------------------------------------------------


LOCKSTEP = [
    pytest.param(dict(n_req=5, num_slots=3, admit_delay=0), id="5-3-0"),
    pytest.param(dict(n_req=5, num_slots=1, admit_delay=1), id="5-1-1"),
    pytest.param(dict(n_req=4, num_slots=2, admit_delay=2), id="4-2-2"),
    pytest.param(dict(n_req=4, num_slots=2, admit_delay=1, stream_chunks=1),
                 id="stream1"),
    pytest.param(dict(n_req=4, num_slots=1, admit_delay=1, stream_chunks=2),
                 id="stream2"),
    pytest.param(dict(n_req=4, num_slots=1, admit_delay=1, prefix="whole"),
                 id="prefix-whole-cow"),
    pytest.param(dict(n_req=4, num_slots=1, admit_delay=1,
                      prefix="divergent"), id="prefix-divergent"),
    pytest.param(dict(n_req=4, num_slots=1, admit_delay=1, stream_chunks=1,
                      prefix="whole"), id="stream1-prefix-whole"),
    pytest.param(dict(n_req=5, num_slots=2, admit_delay=1, paged=False),
                 id="dense"),
    pytest.param(dict(n_req=4, num_slots=2, admit_delay=1, stream_chunks=1,
                      arch="zamba2_2_7b"), id="zamba2-stream1"),
]


@pytest.mark.parametrize("case", LOCKSTEP)
def test_disagg_matches_reference_step_by_step(ref_params, params,
                                               monkeypatch, case):
    """Both schedulers, each with a span tracer, step in lockstep.  After
    every step: request states, block tables, refcounts, the whole int32
    heap (signals, stream signals, headers), the float pools within 5e-5
    and their NaN bit patterns exactly, every SchedStats field, the
    telemetry sequence, the step's trace events and the tokens.  At the end
    the exported Chrome traces agree event by event and both validate
    (``tests/_torch_lockstep.py``)."""
    if case.get("arch", "qwen3_4b") != "qwen3_4b":
        ref_params, params = family_params(case["arch"])
    run_lockstep(case, ref_params, params, monkeypatch)


def test_migrated_pool_bytes_match_reference(ref_params, params):
    """After one stage + migrate + admit, the destination row's payload
    equals the reference's (allclose: the K/V came from f32 prefills)."""
    p = _prompts(1, S=13)[0]
    rcfg = ref_base.reduced(ref_base.get_config("qwen3_4b"))
    rctx, rheap = ref_context.init(npes=4, node_size=4)
    reng = RefEngine(rcfg, ref_params, max_len=MAXLEN)
    rpool = RefKVPool.create(rheap, rcfg, MAXLEN, num_blocks=16, max_slots=2,
                             block_tokens=4)
    rmig = RefKVMigrator(rctx, rpool)
    rtok, _, rcache = reng.prefill_request({"tokens": jnp.asarray(p)},
                                           jax.random.key(0))
    rheap, rids = rmig.stage(rheap, 0, rcache, prompt_len=13, src_pe=1)
    rheap, rrep = rmig.migrate(rheap, 0, src_pe=1, dst_pe=3, slot=1,
                               prompt_len=13, first_token=rtok)
    rheap, rhdr = rmig.try_admit(rheap, 1, 3, rrep.expected_signal)
    cfg, ctx, heap, eng, pool = _setup(params, num_blocks=16, max_slots=2,
                                       block_tokens=4)
    mig = KVMigrator(ctx, pool)
    tok, _, cache = eng.prefill_request(_tok(p))
    heap, ids = mig.stage(heap, 0, cache, prompt_len=13, src_pe=1)
    heap, rep = mig.migrate(heap, 0, src_pe=1, dst_pe=3, slot=1,
                            prompt_len=13, first_token=tok)
    heap, hdr = mig.try_admit(heap, 1, 3, rep.expected_signal)
    assert (tok, ids, hdr) == (rtok, rids, rhdr)
    assert dataclasses.asdict(rep) == {
        k: v for k, v in dataclasses.asdict(rrep).items()
        if k in dataclasses.asdict(rep)}
    for pe in (1, 3):
        np.testing.assert_allclose(
            heap.read(pool.data, pe).numpy(),
            np.asarray(rheap.read(rpool.data, pe)), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# the port's own laws (mirrors tests/test_disagg.py and tests/test_paged.py)
# ---------------------------------------------------------------------------


def test_e2e_disagg_matches_baselines_bitwise(params):
    """Every request's disaggregated stream equals the lockstep single-PE
    Engine.generate and the equal-shape slot baseline, with more requests
    than slots (rotation and eviction)."""
    prompts = _prompts(5)
    sched, outs = _run(params, prompts)
    assert sched.stats.evictions == len(prompts)
    for i, p in enumerate(prompts):
        gen = sched.engine.generate(_tok(p), ServeConfig(max_new_tokens=6))
        assert gen[0].tolist() == outs[i].tolist()
        assert sched.engine.generate_in_slot(
            _tok(p), ServeConfig(max_new_tokens=6), num_slots=3,
            slot=sched.requests[i].slot) == outs[i].tolist()
    buckets = sched.ctx.telemetry.buckets
    assert any(k[0] == "kvxfer_block" for k in buckets)
    assert any(k[0] == "put_nbi" for k in buckets)
    assert sched.ctx.pending.stats.coalescing_ratio() > 1.0


def test_e2e_disagg_batched_baseline(params):
    prompts = _prompts(3)
    sched, outs = _run(params, prompts)
    base_out = sched.engine.generate(
        {"tokens": torch.from_numpy(np.concatenate(prompts)).long()},
        ServeConfig(max_new_tokens=6))
    for i in range(3):
        assert base_out[i].tolist() == outs[i].tolist()


def test_blocks_invisible_until_admission(params):
    """After migrate() the decode PE's rows are untouched (ops deferred);
    try_admit is the completion point that lands the data and opens the
    gate."""
    cfg, ctx, heap, eng, pool = _setup(params)
    mig = KVMigrator(ctx, pool)
    tok, _, cache1 = eng.prefill_request(_tok(_prompts(1)[0]))
    heap, ids = mig.stage(heap, 0, cache1, prompt_len=10, src_pe=0)
    heap, rep = mig.migrate(heap, 0, src_pe=0, dst_pe=2, slot=0,
                            prompt_len=10, first_token=tok)
    assert len(ctx.pending) > 0
    for bid in ids:
        ptr = pool.block_ptr(bid)
        assert torch.equal(heap.read(ptr, 2), torch.zeros(ptr.size))
        assert ctx.pending.pending_for(ptr, 2) is not None
    assert int(heap.read(pool.sig_ptr(0), 2)) == 0
    assert float(heap.read(pool.block_ptr(ids[0]), 0).abs().max()) > 0
    heap, hdr = mig.try_admit(heap, 0, 2, rep.expected_signal)
    assert hdr == {"req_id": 0, "prompt_len": 10, "first_token": tok,
                   "n_blocks": len(ids)}
    for bid in ids:
        assert torch.equal(heap.read(pool.block_ptr(bid), 2),
                           heap.read(pool.block_ptr(bid), 0))
    assert len(ctx.pending) == 0


@pytest.mark.parametrize("n_extra_blocks,probe", [(1, 0), (1, 2), (2, 1),
                                                  (3, 3), (4, 5), (6, 4)])
def test_partial_signal_never_admits(params, n_extra_blocks, probe):
    """While the waited value is above the signal's count, every block not
    yet signalled reads zero at the destination; the full wait admits and
    forces the rest."""
    cfg, ctx, heap, eng, pool = _setup(params, num_blocks=16, max_slots=1,
                                       block_tokens=4)
    mig = KVMigrator(ctx, pool)
    S = min(4 * n_extra_blocks + 2, MAXLEN - 1)
    tok, _, cache1 = eng.prefill_request(_tok(_prompts(1, S=S, seed=3)[0]))
    heap, ids = mig.stage(heap, 0, cache1, prompt_len=S, src_pe=0)
    heap, rep = mig.migrate(heap, 0, src_pe=0, dst_pe=1, slot=0,
                            prompt_len=S, first_token=tok)
    expected = rep.expected_signal
    assert expected == expected_signal(len(ids))
    partial = min(probe, expected - 1)
    if partial > 0:
        heap, cur, ok = signal_mod.signal_wait_until(
            ctx, heap, pool.sig_ptr(0), 1, "ge", partial)
        assert ok
        for bid in ids:
            ptr = pool.block_ptr(bid)
            if ctx.pending.pending_for(ptr, 1) is not None:
                assert torch.equal(heap.read(ptr, 1), torch.zeros(ptr.size))
    heap, hdr = mig.try_admit(heap, 0, 1, expected)
    assert hdr is not None
    assert int(heap.read(pool.sig_ptr(0), 1)) == expected
    assert len(ctx.pending) == 0


def test_assemble_rebuilds_the_dense_cache(params):
    """After admission, the view's gather (K3's plain version here) rebuilds
    the admitted slot's K/V byte for byte as the prefill left it, zeros past
    the prompt (growth block included), and all-zero unmapped slots."""
    cfg, ctx, heap, eng, pool = _setup(params, block_tokens=4)
    mig = KVMigrator(ctx, pool)
    tok, _, cache1 = eng.prefill_request(_tok(_prompts(1, S=11)[0]))
    heap, ids = mig.stage(heap, 0, cache1, prompt_len=11, src_pe=0,
                          max_new=4)
    heap, rep = mig.migrate(heap, 0, src_pe=0, dst_pe=3, slot=1,
                            prompt_len=11, first_token=tok)
    heap, _ = mig.try_admit(heap, 1, 3, rep.expected_signal)
    from repro_torch.serve.paged_attn import PagedDecodeView
    view = PagedDecodeView(pool, 3, 3)
    growth = [i for i in ids if pool.home_of(i) is None]
    assert growth
    heap = view.attach(heap, 1, 0, fresh_ids=growth)
    cache = view.assemble(heap, eng.init_slots(3).cache)
    for key in ("k", "v"):
        leaf, want = cache["blocks"][0][key], cache1["blocks"][0][key]
        assert torch.equal(leaf[:, 1], want[:, 0])
        assert torch.equal(leaf[:, 0], torch.zeros_like(leaf[:, 0]))
        assert torch.equal(leaf[:, 2], torch.zeros_like(leaf[:, 2]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_tail_packing_is_lossless(dtype):
    """Non-paged leaves travel as one f32 vector: f32 as is, bf16 upcast
    exactly, int32 bit-cast (``Tensor.view``), all back bit for bit."""
    from repro_torch.serve.kvpool import _pack_leaf_f32, _unpack_leaf_f32
    rng = np.random.default_rng(len(dtype))
    x = torch.from_numpy(rng.normal(size=(2, 1, 5)).astype(np.float32) * 1e3)
    x = x.to(getattr(torch, dtype)) if dtype != "int32" else \
        torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(2, 1, 5),
                                      dtype=np.int64).astype(np.int32))
    packed = _pack_leaf_f32(x)
    assert packed.dtype == torch.float32 and packed.shape == (10,)
    assert torch.equal(_unpack_leaf_f32(packed, (2, 1, 5), dtype), x)


def test_admission_blocked_when_signal_short(params):
    cfg, ctx, heap, eng, pool = _setup(params, max_slots=1)
    mig = KVMigrator(ctx, pool)
    tok, _, cache1 = eng.prefill_request(_tok(_prompts(1)[0]))
    heap, _ = mig.stage(heap, 7, cache1, prompt_len=10, src_pe=0)
    heap, rep = mig.migrate(heap, 7, src_pe=0, dst_pe=1, slot=0,
                            prompt_len=10, first_token=tok)
    heap, hdr = mig.try_admit(heap, 0, 1, rep.expected_signal + 1)
    assert hdr is None


def test_rotation_reuses_slots_and_blocks(params):
    """A pool too small for every request at once: stalls are recorded,
    every request still finishes right, and the pool drains to empty."""
    prompts = _prompts(6)
    sched, outs = _run(params, prompts, num_slots=2, NEW=4, num_blocks=6,
                       max_slots=2)
    assert sched.stats.stalled_on_pool > 0 or sched.stats.stalled_on_slots > 0
    assert sched.pool.stats()["blocks_in_use"] == 0
    for i, p in enumerate(prompts):
        assert sched.engine.generate(_tok(p), ServeConfig(
            max_new_tokens=4))[0].tolist() == outs[i].tolist()


def test_eviction_and_slot_reuse_more_requests_than_slots(params):
    """Seven requests over two single-slot decode PEs: every slot serves
    several requests in turn, each eviction returns its blocks and re-arms
    the slot's signal word, and every stream stays bitwise right."""
    prompts = _prompts(7, S=9, seed=5)
    sched, outs = _run(params, prompts, num_slots=1, NEW=5)
    st = sched.stats
    assert (st.prefills, st.migrations, st.admissions, st.evictions) == \
        (7, 7, 7, 7)
    served = {}
    for r in sched.requests.values():
        served.setdefault((r.decode_pe, r.slot), []).append(r.rid)
    assert len(served) == 2 and all(len(v) >= 3 for v in served.values())
    assert sched.pool.free_blocks() == sched.pool.num_blocks
    assert not sched.pool.block_tables
    for pe in sched.decode_pes:
        assert int(sched.heap.read(sched.pool.sig_ptr(0), pe)) == 0
        assert not sched.banks[pe].active.any()
    for i, p in enumerate(prompts):
        assert sched.engine.generate(_tok(p), ServeConfig(
            max_new_tokens=5))[0].tolist() == outs[i].tolist()


def test_eos_early_stop_matches_generate_padding(params):
    p = _prompts(1)[0]
    eng = _setup(params)[3]
    base_out = eng.generate(_tok(p), ServeConfig(max_new_tokens=6))
    eos = int(base_out[0, 1])
    want = eng.generate(_tok(p), ServeConfig(max_new_tokens=6, eos_id=eos))
    sched, outs = _run(params, [p], num_slots=2, eos_id=eos)
    assert outs[0].tolist() == want[0].tolist()
    assert sched.requests[0].finish_step < 6


def test_sampling_is_seeded(params):
    """temperature > 0 draws from torch generators seeded by
    ServeConfig.seed: one seed gives one stream, in the vocabulary, and
    another seed another stream."""
    prompts = _prompts(3)
    runs = {}
    for seed in (0, 0, 1):
        sched, outs = _run(params, prompts, temperature=2.0, seed=seed)
        runs.setdefault(seed, []).append([o.tolist() for o in outs.values()])
    assert runs[0][0] == runs[0][1]
    assert runs[0][0] != runs[1][0]
    assert all(0 <= t < 512 for out in runs[1][0] for t in out)
    eng = _setup(params)[3]
    scfg = ServeConfig(max_new_tokens=5, temperature=2.0, seed=4)
    assert torch.equal(eng.generate(_tok(prompts[0]), scfg),
                       eng.generate(_tok(prompts[0]), scfg))


def test_ttfd_and_migration_accounting(params):
    sched, _ = _run(params, _prompts(5), admit_delay=2)
    st = sched.stats
    assert st.migrations == 5 == st.admissions
    assert st.bytes_migrated > 0
    assert all(t >= 2 for t in st.ttfd_steps)
    assert all(t >= 0 for t in st.ttfd_model_s)


def test_paged_decode_never_rehydrates_dense_cache(params):
    sched, _ = _run(params, _prompts(5))
    lay = sched.pool.layout
    assert lay.paged
    for bank in sched.banks.values():
        for pl in lay.paged:
            leaf = bank.cache["blocks"][pl.unit_idx][pl.key]
            assert torch.equal(leaf, torch.zeros_like(leaf))


def test_growth_blocks_receive_decode_writes(params):
    """Generation crossing a block boundary writes K/V into growth blocks
    that never migrated; output still matches the baseline."""
    p = _prompts(1)[0]
    sched = _sched(params, decode_pes=[2], num_slots=1, NEW=7,
                   block_tokens=4)
    sched.submit(_tok(p))
    touched = {}
    for _ in range(100):
        if sched.done():
            break
        sched.step()
        for rid, ids in sched.pool.block_tables.items():
            for bid in (i for i in ids if sched.pool.home_of(i) is None):
                val = float(sched.heap.read(sched.pool.block_ptr(bid), 2)
                            .abs().max())
                touched[bid] = max(touched.get(bid, 0.0), val)
    assert sched.done()
    assert touched and max(touched.values()) > 0
    assert sched.engine.generate(_tok(p), ServeConfig(
        max_new_tokens=7))[0].tolist() == sched.requests[0].out


OBS_FLAGS = ("--trace", "--metrics", "--refit", "--refit-min-samples",
             "--audit", "--recorder", "--alerts", "--profile",
             "--calibration")


def _ref_parser(monkeypatch):
    """The reference launcher's parser, caught as its ``main`` parses."""
    import argparse
    from repro.launch import serve as ref_serve

    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        raise Caught(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(Caught) as got:
        ref_serve.main()
    monkeypatch.undo()
    return got.value.args[0]


@pytest.mark.parametrize("kw", [{"obs": dict(metrics=True,
                                             audit_period=1)}])
def test_unported_modes_raise(params, kw, monkeypatch, tmp_path):
    """Nothing of the serving stack is left unported: a scheduler takes
    ``policy=``, the observability flags parse as the reference's (type,
    default, nargs, const) and reach an ``Obs`` bundle, and a fleet runs
    with one attached (a metrics row and an audit pass a step)."""
    from repro_torch.obs import Obs
    from repro_torch.serve.frontend import Fleet, FleetConfig
    from repro_torch.serve.scheduler import AdmissionPolicy
    cfg, ctx, heap, eng, pool = _setup(params)
    sched = DisaggScheduler(ctx, heap, eng, pool, KVMigrator(ctx, pool),
                            prefill_pes=[0, 1], decode_pes=[2, 3],
                            num_slots=3, policy=AdmissionPolicy())
    assert isinstance(sched.policy, AdmissionPolicy)
    ref = {a.option_strings[0]: a for a in _ref_parser(monkeypatch)._actions
           if a.option_strings}
    port = {a.option_strings[0]: a
            for a in launch_serve.build_parser()._actions if a.option_strings}
    for flag in OBS_FLAGS:
        r, p = ref[flag], port[flag]
        assert (type(r), r.dest, r.type, r.default, r.nargs, r.const) == \
            (type(p), p.dest, p.type, p.default, p.nargs, p.const), flag
    for name in list(os.environ):
        if name.startswith("ISHMEM_OBS_"):
            monkeypatch.delenv(name)
    args = launch_serve.parse_args(
        ["--fleet", "--metrics", "m.json", "--refit", "4", "--audit", "2",
         "--recorder", "8", "--alerts", "--profile", "--calibration",
         str(tmp_path / "c.json"), "--refit-min-samples", "3"])
    obs, trace, metrics, prof, cal = launch_serve.make_obs(args)
    assert (trace, metrics, prof, cal) == (None, "m.json", None,
                                          str(tmp_path / "c.json"))
    assert obs.audit_period == 2 and obs.recorder.window_steps == 8
    assert obs.refit_period == 4 and obs.refit_min_samples == 3
    assert obs.monitor is not None and obs.prof is not None
    assert launch_serve.make_obs(launch_serve.parse_args(["--fleet"]))[0] \
        is None
    fleet = Fleet(FleetConfig(max_len=MAXLEN, max_new=2), engine=eng,
                  obs=Obs(**kw["obs"]))
    fleet.step([])
    fleet.step([])
    assert len(fleet.obs.metrics.series) == 2
    assert fleet.obs.auditor.checks == 2
    assert fleet.report()["obs"]["audit"]["violations"] == 0


def test_launcher_refuses_streaming_with_fused_attn():
    """As in the reference: per-block signals already stream, so
    ``--stream-chunks`` with ``--fused-attn`` raises."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        launch_serve.main(["--disagg", "--device", "cpu", "--requests", "1",
                           "--prompt-len", "8", "--max-new", "2",
                           "--fused-attn", "--stream-chunks", "1"])


def test_launcher_runs_on_cpu(capsys):
    sched = launch_serve.main(["--disagg", "--device", "cpu", "--requests",
                               "4", "--prompt-len", "12", "--max-new", "5"])
    st = sched.stats
    assert (st.prefills, st.migrations, st.admissions, st.evictions) == \
        (4, 4, 4, 4)
    assert "[serve] disagg arch=qwen3-4b" in capsys.readouterr().out
    out = launch_serve.main(["--device", "cpu", "--batch", "2",
                             "--prompt-len", "6", "--max-new", "3"])
    assert tuple(out.shape) == (2, 3)


LAUNCH_MODES = {
    "stream": ["--stream-chunks", "2"],
    "prefix": ["--shared-prefix"],
    "dense": ["--dense-rehydrate"],
}


@pytest.mark.parametrize("mode", sorted(LAUNCH_MODES))
def test_launcher_new_modes_on_cpu(ref_params, capsys, tmp_path, mode):
    """The launcher's streaming, shared-prefix and dense-rehydrate modes at
    the smoke's serving shape, reduced (8 requests over 2 + 2 PEs, 3 slots,
    block 8, a 20-token prompt, so the whole-prompt prefix ends in a
    partial block), each with ``--trace``: every request bitwise equal to
    the single-PE baseline, the trace valid with one finished chain per
    request, and the mode's counters equal to the JAX scheduler's on the
    same shape."""
    trace = tmp_path / "trace.json"
    argv = ["--disagg", "--device", "cpu", "--requests", "8",
            "--prompt-len", "20", "--max-new", "5", "--slots", "3",
            "--block-tokens", "8", "--kv-blocks", "64", "--trace",
            str(trace)] + LAUNCH_MODES[mode]
    sched = launch_serve.main(argv)
    out = capsys.readouterr().out
    st = sched.stats
    assert (st.prefills, st.migrations, st.admissions, st.evictions) == \
        (8, 8, 8, 8)
    assert len(sched.ctx.pending) == 0
    assert sched.pool.stats()["blocks_in_use"] == 0
    for rid, req in sched.requests.items():
        assert sched.engine.generate(req.batch, ServeConfig(
            max_new_tokens=5))[0].tolist() == req.out
    doc = json.loads(trace.read_text())
    assert validate(doc) == []
    chains = request_chains_doc(doc)
    assert sorted(chains) == list(range(8))
    for chain in chains.values():
        assert chain_gaps(chain) == []
        assert chain[-1]["args"]["outcome"] == "finished"
    assert "trace:" in out
    # the JAX scheduler on the same shape (counters do not depend on the
    # weights: no eos)
    rcfg = ref_base.reduced(ref_base.get_config("qwen3_4b"))
    rctx, rheap = ref_context.init(npes=4, node_size=4)
    pre, dec = ref_teams.disagg_partition(ref_teams.world(4), 2)
    reng = RefEngine(rcfg, ref_params, max_len=25)
    rpool = RefKVPool.create(rheap, rcfg, 25, num_blocks=64, max_slots=3,
                             block_tokens=8)
    rsched = RefScheduler(
        rctx, rheap, reng, rpool, RefKVMigrator(rctx, rpool),
        prefill_pes=pre.pes(), decode_pes=dec.pes(), num_slots=3,
        scfg=RefServeConfig(max_new_tokens=5), admit_delay_steps=1,
        paged=mode != "dense", stream_chunks=2 if mode == "stream" else 0,
        shared_prefix=mode == "prefix")
    for req in sched.requests.values():
        rsched.submit({"tokens": jnp.asarray(req.batch["tokens"].numpy())},
                      prefix_len=20 if mode == "prefix" else 0)
    rsched.run()
    for f in dataclasses.fields(st):
        assert getattr(rsched.stats, f.name) == getattr(st, f.name), f.name
    if mode == "stream":
        assert st.stream_chunks == 8 * 2        # 3 blocks: 2 + 1 a request
        assert "streaming: 16 wire installments of 2 block(s)" in out
    if mode == "prefix":
        assert (st.prefix_hits, st.cow_copies) == (7, 8)
        assert st.bytes_wire_saved > 0
        assert "shared prefix: 7 hits" in out
    if mode == "dense":
        assert "decode-cache=dense-rehydrate" in out


@pytest.mark.parametrize("arch,flags", [
    ("zamba2-2.7b", []), ("zamba2-2.7b", ["--fused-attn"]),
    ("xlstm-125m", [])])
def test_launcher_serves_recurrent_families_on_cpu(capsys, arch, flags):
    """``--arch zamba2-2.7b`` (paged K/V of the shared attention block,
    Mamba2 states in the tail) and ``--arch xlstm-125m`` (a tail-only
    layout) at reduced widths: the counters balance, the pool drains, and
    every request equals the single-PE baseline bitwise."""
    sched = launch_serve.main(["--disagg", "--device", "cpu", "--arch", arch,
                               "--requests", "5", "--prompt-len", "12",
                               "--max-new", "4", "--slots", "2"] + flags)
    st = sched.stats
    assert (st.prefills, st.migrations, st.admissions, st.evictions) == \
        (5, 5, 5, 5)
    assert sched.pool.stats()["blocks_in_use"] == 0
    assert len(sched.ctx.pending) == 0
    assert bool(sched.pool.layout.paged) == arch.startswith("zamba2")
    for req in sched.requests.values():
        assert sched.engine.generate_in_slot(
            req.batch, sched.scfg, num_slots=2, slot=req.slot) == req.out
    assert f"[serve] disagg arch={arch}" in capsys.readouterr().out
