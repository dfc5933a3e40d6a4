"""The port's disaggregated scheduler held to the JAX package's in
lockstep, shared by ``tests/test_torch_serve.py`` (qwen3-4b's modes and
zamba2) and ``tests/test_torch_families.py`` (the seven other
configurations), and the reduced-width scheduler those files build.

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
    monkeypatch.setattr(engine_mod.model, "decode_step", lambda *a: (
        lambda out: plogits.append(out[0].numpy()) or out)(pdecode(*a)))
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
        assert [(r.op, r.nbytes, r.path, r.tier, r.work_items, r.t_sec)
                for r in rctx.telemetry.trace] == \
            [(r.op, r.nbytes, r.path, r.tier, r.work_items, r.t_sec)
             for r in psched.ctx.telemetry.trace]
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


