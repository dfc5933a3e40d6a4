"""The port's ring kernels (K4-K8), ring allreduces and comms backends,
held against the JAX package.

The reference runs each Pallas ring kernel per PE under ``shard_map`` on the
8 host devices, in interpret mode (as ``tests/test_ring_kernels.py`` runs
them); the port takes the same inputs PE-stacked and, on the CPU, runs each
kernel's plain version.  Inputs come from numpy seeds.  Data movement is
compared bitwise; the reduce-scatter to the reference's 1e-5, the TP layer
to its 1e-4.  ``ShmemOps`` is held against the JAX ``ShmemOps`` result by
result and telemetry record by record (modeled seconds equal as floats).
The reference's ``psum_overlap`` fails on jax 0.9.0, so the port's is held
against ``EngineOps.psum``.  ``tests/test_torch_cuda.py`` holds the CUDA
kernels against their plain versions on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.comms import api as ref_api
from repro.core import cutover as ref_cutover
from repro.kernels import ops as ref_ops
from repro.tune import telemetry as ref_telemetry
from repro_torch import _bridge
from repro_torch.comms import api
from repro_torch.core import cutover
from repro_torch.kernels import ops, ring_collectives as rc, rma_copy
from repro_torch.launch import serve as launch_serve, shmem_collectives
from repro_torch.tune import telemetry
from _torch_threads import one_intra_op_thread  # noqa: F401

NPES = 8


def _t(a):
    return _bridge.array_to_torch(np.asarray(a), "cpu")


def _both(x: np.ndarray, dtype: str = "float32"):
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _sm(npes, f, ins, outs):
    mesh = jax.make_mesh((npes,), ("x",), devices=jax.devices()[:npes])
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=ins, out_specs=outs,
                                 check_vma=False))


@pytest.fixture
def counts():
    ops.reset_launches()
    yield ops.LAUNCHES
    assert ops.LAUNCHES == {name: 0 for name in ops.LAUNCHES}, \
        "a CPU tensor launched a kernel"


# ---------------------------------------------------------------------------
# K4-K8 against the Pallas ring kernels (test_ring_kernels' grid)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("npes,dtype", [(2, "float32"), (4, "float32"),
                                        (8, "float32"), (4, "bfloat16")])
def test_ring_allgather_matches_pallas(npes, dtype, counts):
    jx, tx = _both(_normal(npes, (npes, 256)), dtype)
    want = _sm(npes, lambda v: ref_ops.ring_allgather(
        v[0], axis_name="x", npes=npes)[None], P("x", None),
        P("x", None, None))(jx)
    got = rc.ring_allgather(tx)
    assert got.shape == (npes, npes, 256) and torch.equal(got, _t(want))


@pytest.mark.parametrize("npes", [2, 4, 8])
def test_ring_reduce_scatter_matches_pallas(npes, counts):
    jx, tx = _both(_normal(10 + npes, (npes, npes, 128)))
    want = _sm(npes, lambda v: ref_ops.ring_reduce_scatter(
        v[0], axis_name="x", npes=npes)[None], P("x", None, None),
        P("x", None))(jx)
    got = rc.ring_reduce_scatter(tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("root", [0, 3, 7])
def test_push_broadcast_matches_pallas(root, counts):
    jx, tx = _both(_normal(20 + root, (NPES, 384)))
    want = _sm(NPES, lambda v: ref_ops.push_broadcast(
        v[0], axis_name="x", npes=NPES, root=root)[None], P("x", None),
        P("x", None))(jx)
    assert torch.equal(rc.push_broadcast(tx, root), _t(want))


def test_barrier_push_matches_pallas(counts):
    want = _sm(NPES, lambda: ref_ops.barrier_push(axis_name="x", npes=NPES),
               (), P("x"))()
    got = rc.barrier_push(NPES, device="cpu")
    assert got.dtype == torch.int32 and got.tolist() == want.tolist() \
        == [1] * NPES


@pytest.mark.parametrize("offset,w", [(1, 1), (3, 4)])
def test_remote_put_matches_pallas(offset, w, counts):
    """w | n here: the reference drops the tail otherwise (ROADMAP queue
    3)."""
    jx, tx = _both(_normal(30 + offset, (NPES, 256)))
    want = _sm(NPES, lambda v: ref_ops.remote_put(
        v[0], axis_name="x", npes=NPES, target_offset=offset,
        work_items=w)[None], P("x", None), P("x", None))(jx)
    got = rma_copy.remote_put(tx, target_offset=offset, work_items=w)
    assert torch.equal(got, _t(want))
    assert torch.equal(got, torch.roll(tx, offset, 0))


def test_remote_put_lands_the_tail(counts):
    """n = 259, w = 2: every element lands, the last one included."""
    x = torch.from_numpy(_normal(40, (4, 259)))
    got = rma_copy.remote_put(x, target_offset=1, work_items=2)
    assert torch.equal(got, torch.roll(x, 1, 0))
    assert torch.equal(got[:, -1], torch.roll(x[:, -1], 1, 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_copy_kernels_take_every_dtype(dtype, counts):
    x = (torch.from_numpy(_normal(50, (4, 3, 37))) * 50).to(
        getattr(torch, dtype))
    assert torch.equal(rc.ring_allgather(x)[2], x)
    col = x[:, 0, 0].contiguous()
    assert torch.equal(rc.ring_allgather(col)[1], col)
    assert torch.equal(rc.push_broadcast(x, 1)[3], x[1])
    assert torch.equal(rma_copy.remote_put(x, target_offset=3),
                       torch.roll(x, 3, 0))


def test_reduce_scatter_bf16_adds_in_bf16(counts):
    """acc stays in x's dtype, as the reference's acc_v does."""
    x = torch.from_numpy(_normal(60, (4, 4, 64))).bfloat16()
    got = rc.ring_reduce_scatter(x)
    acc = [x[p, (p - 1) % 4] for p in range(4)]
    for s in range(3):
        acc = [(acc[(p - 1) % 4].float() + x[p, (p - 2 - s) % 4].float())
               .bfloat16() for p in range(4)]
    assert got.dtype == torch.bfloat16 and torch.equal(got, torch.stack(acc))


@pytest.mark.parametrize("npes", [1, 2, 5, 8, 11])
def test_reduce_scatter_fold_order(npes, counts):
    """Chunk c is folded as ``(...(x[c+1][c] + x[c+2][c]) + ...) +
    x[c][c]`` (indices mod P), the order the kernel pulls in (11 PEs take
    two groups of 8 loads).  The data mix magnitudes so that bf16 rounding
    tells this order from a sum over p = 0 .. P-1."""
    rng = np.random.default_rng(70 + npes)
    x = torch.from_numpy((rng.normal(size=(npes, npes, 96)) * 10.0 ** rng
                          .integers(-3, 4, size=(npes, npes, 96)))
                         .astype(np.float32)).bfloat16()
    want, naive = [], []
    for c in range(npes):
        acc = x[(c + 1) % npes, c]
        for j in range(1, npes):
            acc = (acc.float() + x[(c + 1 + j) % npes, c].float()).bfloat16()
        want.append(acc)
        acc = x[0, c]
        for p in range(1, npes):
            acc = (acc.float() + x[p, c].float()).bfloat16()
        naive.append(acc)
    got = rc.ring_reduce_scatter(x)
    assert torch.equal(got, torch.stack(want))
    if npes > 2:
        assert not torch.equal(got, torch.stack(naive))


def test_wrappers_reject_bad_input(counts):
    with pytest.raises(ValueError):
        rc.ring_reduce_scatter(torch.zeros(4, 3, 8))     # not (P, P, ...)
    with pytest.raises(TypeError):
        rc.ring_reduce_scatter(torch.zeros(2, 2, 8, dtype=torch.int32))
    with pytest.raises(TypeError):
        rc.ring_allgather(torch.zeros(2, 8, dtype=torch.float64))
    with pytest.raises(ValueError):
        rc.ring_allgather(torch.zeros(8, 4).t())          # not contiguous
    with pytest.raises(ValueError):
        rc.push_broadcast(torch.zeros(4, 8), root=4)
    with pytest.raises(ValueError):
        rc.ring_allgather(torch.zeros(()))                # no PE axis
    with pytest.raises(ValueError):
        rc.barrier_push(0, device="cpu")


def test_non_cpu_tensors_never_take_the_plain_version(counts):
    """Meta tensors (the dry-run) get empty meta outputs of each kernel's
    shapes, and neither version runs."""
    meta = torch.device("meta")
    x = torch.zeros(4, 8, device=meta)
    for fn, shape in ((rc.ring_allgather, (4, 4, 8)),
                      (rma_copy.remote_put, (4, 8)),
                      (lambda t: rc.push_broadcast(t, 0), (4, 8))):
        out = fn(x)
        assert out.is_meta and out.shape == shape
    out = rc.ring_reduce_scatter(torch.zeros(4, 4, 8, device=meta))
    assert out.is_meta and out.shape == (4, 8)
    out = rc.barrier_push(4, device="meta")
    assert out.is_meta and out.shape == (4,) and out.dtype == torch.int32
    assert not any(counts.values())


# ---------------------------------------------------------------------------
# ring allreduces (repro/kernels/ops.py:77-111)
# ---------------------------------------------------------------------------


def test_ring_allreduce_matches_pallas(counts):
    jx, tx = _both(_normal(70, (NPES, NPES, 128)))
    want = _sm(NPES, lambda v: ref_ops.ring_allreduce(
        v[0], axis_name="x", npes=NPES)[None], P("x", None, None),
        P("x", None, None))(jx)
    got = ops.ring_allreduce(tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ring_allreduce_nbi_is_the_sum(counts):
    x = torch.from_numpy(_normal(71, (NPES, 64)))
    got = ops.ring_allreduce_nbi(x)
    torch.testing.assert_close(got, x.sum(0).expand_as(x), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(ops.ring_step_nbi(x), torch.roll(x, 1, 0))


# ---------------------------------------------------------------------------
# ShmemOps against the JAX ShmemOps, record by record
# ---------------------------------------------------------------------------


def _records(sink):
    return [(r.op, r.nbytes, r.path, r.tier, r.t_sec, r.work_items)
            for r in sink.trace]


def _pair(method, x: np.ndarray, ins, outs, *args, npes=NPES, **kw):
    """Run ``method`` on the JAX ShmemOps (per PE, under shard_map) and on
    the port's (stacked); returns both results and both record lists."""
    ref_sink, sink = ref_telemetry.TelemetrySink(), telemetry.TelemetrySink()
    ref = ref_api.get_ops("shmem", npes=npes, telemetry=ref_sink)
    port = api.get_ops("shmem", npes=npes, telemetry=sink)
    jx, tx = _both(x)
    want = _sm(npes, lambda v: getattr(ref, method)(v[0], "x", *args,
                                                    **kw)[None], ins, outs)(jx)
    got = getattr(port, method)(tx, *args, **kw)
    return got, _t(want), _records(sink), _records(ref_sink)


@pytest.mark.parametrize("shape", [(NPES, 64), (NPES, 40, 520)],
                         ids=["fcollect-branch", "rs-ag-branch"])
def test_psum_matches_reference(shape, counts):
    """Both branches: 256 B per PE takes fcollect + local sum, 83 KB per PE
    takes RS+AG over padded rows."""
    spec = P(*("x",) + (None,) * (len(shape) - 1))
    got, want, recs, ref_recs = _pair("psum", _normal(80, shape), spec, spec)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert recs == ref_recs and len(recs) == 1


def test_all_gather_matches_reference(counts):
    got, want, recs, ref_recs = _pair("all_gather", _normal(81, (NPES, 256)),
                                      P("x", None), P("x", None, None))
    assert torch.equal(got, want) and recs == ref_recs


def test_reduce_scatter_matches_reference(counts):
    got, want, recs, ref_recs = _pair(
        "reduce_scatter", _normal(82, (NPES, NPES, 128)), P("x", None, None),
        P("x", None))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert recs == ref_recs


def test_broadcast_matches_reference(counts):
    got, want, recs, ref_recs = _pair("broadcast", _normal(83, (NPES, 256)),
                                      P("x", None), P("x", None), root=5)
    assert torch.equal(got, want) and recs == ref_recs


def test_ppermute_matches_reference(counts):
    perm = [(i, (i + 3) % NPES) for i in range(NPES)]
    got, want, recs, ref_recs = _pair("ppermute", _normal(84, (NPES, 256)),
                                      P("x", None), P("x", None), perm)
    assert torch.equal(got, want) and recs == ref_recs


def test_psum_hierarchical_matches_reference(mesh2x4, counts):
    x = _normal(85, (8, 6, 256))
    ref = ref_api.get_ops("shmem", npes=4)
    spec = P(("data", "model"), None, None)
    want = jax.jit(jax.shard_map(
        lambda v: ref.psum_hierarchical(v[0], "model", "data")[None],
        mesh=mesh2x4, in_specs=spec, out_specs=spec, check_vma=False))(
        jnp.asarray(x))
    got = api.get_ops("shmem", npes=4).psum_hierarchical(
        torch.from_numpy(x).reshape(2, 4, 6, 256))
    np.testing.assert_allclose(got.reshape(8, 6, 256).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1, 2].numpy(), x.sum(0), rtol=1e-5,
                               atol=1e-5)


def test_tp_layer_matches_reference(counts):
    """test_tp_layer_end_to_end: y = psum(relu(x @ w1) @ w2) per PE."""
    d, ff = 128, 512
    w1 = _normal(86, (NPES, d, ff // NPES)) * 0.05
    w2 = _normal(87, (NPES, ff // NPES, d)) * 0.05
    x = _normal(88, (4, d))
    ref_sink, sink = ref_telemetry.TelemetrySink(), telemetry.TelemetrySink()
    ref = ref_api.get_ops("shmem", npes=NPES, telemetry=ref_sink)

    def layer(w1s, w2s):
        h = jax.nn.relu(jnp.asarray(x) @ w1s[0])
        return ref.psum(h @ w2s[0], "x")[None]

    want = jax.jit(jax.shard_map(
        layer, mesh=jax.make_mesh((NPES,), ("x",)),
        in_specs=(P("x", None, None), P("x", None, None)),
        out_specs=P("x", None, None), check_vma=False))(jnp.asarray(w1),
                                                        jnp.asarray(w2))
    port = api.get_ops("shmem", npes=NPES, telemetry=sink)
    h = torch.relu(torch.from_numpy(x) @ torch.from_numpy(w1))
    got = port.psum(h @ torch.from_numpy(w2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert _records(sink) == _records(ref_sink)


@pytest.mark.parametrize("shape", [(NPES, 64), (NPES, 64, 1024)],
                         ids=["nbi-branch", "rs-ag-branch"])
def test_psum_overlap_matches_engine_psum(shape, counts):
    x = torch.from_numpy(_normal(89, shape))
    sink = telemetry.TelemetrySink()
    port = api.get_ops("shmem", npes=NPES, telemetry=sink)
    torch.testing.assert_close(port.psum_overlap(x),
                               api.get_ops("xla").psum(x), rtol=1e-5,
                               atol=1e-5)
    nbytes = x[0].numel() * 4
    rec = sink.trace[-1]
    assert (rec.op, rec.nbytes, rec.path) == ("psum_nbi", nbytes, "direct")
    assert rec.t_sec == ref_cutover.t_ring_allreduce(
        nbytes, NPES, work_items=128, tier="ici", overlap=True)


def test_engine_ops_match_lax(counts):
    """EngineOps, the tests' oracle, against XlaOps' lax collectives."""
    x = _normal(90, (NPES, NPES, 16))
    ref, eng = ref_api.get_ops("xla"), api.get_ops("xla")
    tx = torch.from_numpy(x)
    spec3 = P("x", None, None)
    for method, args, outs in (("psum", (), spec3),
                               ("all_gather", (), P("x", None, None, None)),
                               ("reduce_scatter", (), P("x", None)),
                               ("broadcast", (3,), spec3),
                               ("ppermute", ([(0, 2), (5, 1)],), spec3)):
        want = _sm(NPES, lambda v: getattr(ref, method)(v[0], "x", *args)[None],
                   spec3, outs)(jnp.asarray(x))
        np.testing.assert_allclose(getattr(eng, method)(tx, *args).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=method)


def test_modeled_overlap_and_get_ops(counts):
    ref = ref_api.get_ops("shmem", npes=NPES)
    port = api.get_ops("shmem", npes=NPES)
    for nbytes in (4, 10240, 607744, 1 << 24):
        assert port.modeled_overlap_efficiency(nbytes) == \
            ref.modeled_overlap_efficiency(nbytes)
    assert api.get_ops("xla").name == "xla" and port.name == "shmem"
    with pytest.raises(ValueError):
        api.get_ops("shmem")
    with pytest.raises(ValueError):
        api.get_ops("nccl")
    with pytest.raises(ValueError):
        port.psum(torch.zeros(4, 8))                   # wrong PE axis


# ---------------------------------------------------------------------------
# the slice as a whole: the collectives launcher, and serve's overlap report
# ---------------------------------------------------------------------------


def test_collectives_launcher_on_cpu(counts):
    """The example's steps, the TP MLP on every psum branch, the logits
    reduce, the layer broadcast, the ppermute and the facade, at reduced
    widths on 4 PEs; every check inside raises on failure."""
    report = shmem_collectives.main(["--device", "cpu", "--npes", "4",
                                     "--prefill-tokens", "64",
                                     "--decode-batch", "2"])
    errs = report["max_abs_err"]
    assert len(errs) > 20 and max(errs.values()) < 1e-4
    psums = [(op, n) for op, n, _ in report["records"]]
    assert psums[:5] == [("psum", 64 * 256 * 4), ("psum", 256 * 4),
                         ("psum", 2 * 256 * 4), ("psum_nbi", 256 * 4),
                         ("psum_nbi", 64 * 256 * 4)]
    assert ("ppermute", 64 * 256 * 4) in psums
    assert report["facade_records"] > 10


def test_serve_overlap_report_matches_reference(capsys):
    launch_serve.main(["--device", "cpu", "--batch", "1", "--max-new", "1",
                       "--prompt-len", "4", "--overlap-report",
                       "--comms-npes", "4"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "overlap" in ln or " B=" in ln or "wins" in ln]
    ref = ref_api.get_ops("shmem", npes=4)
    assert "d_model=2560 vocab=151936 npes=4" in lines[0]
    want = [f"x{ref.modeled_overlap_efficiency(B * 2560 * 4):.2f}"
            for B in (1, 2, 4, 8, 16, 32, 64, 128, 256)]
    got = [ln.split("overlap ")[1].split()[0] for ln in lines
           if "hidden B=" in ln]
    assert got == want


# ---------------------------------------------------------------------------
# the collective cost models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sync", "broadcast", "fcollect",
                                  "alltoall", "reduce"])
def test_collective_cost_models_match_reference(kind):
    for npes in (2, 4, 8, 16):
        for wi in (1, 8, 128, 1024):
            for nbytes in (1, 64, 4096, 65536, 1 << 20, 1 << 26):
                for path in ("direct", "engine"):
                    assert cutover.t_collective(
                        kind, nbytes, npes, work_items=wi, path=path) == \
                        ref_cutover.t_collective(kind, nbytes, npes,
                                                 work_items=wi, path=path)
                assert cutover.choose_collective_path(
                    kind, nbytes, npes, work_items=wi) == \
                    ref_cutover.choose_collective_path(kind, nbytes, npes,
                                                       work_items=wi)
        for eb in (2, 4):
            assert cutover.collective_cutover_elems(kind, npes, eb) == \
                ref_cutover.collective_cutover_elems(kind, npes, eb)


@pytest.mark.parametrize("tier", ["local", "ici", "dcn"])
def test_ring_models_match_reference(tier):
    tuned = (cutover.Tuning(), cutover.Tuning(cutover_bytes=4096),
             cutover.Tuning(force_path="engine"))
    ref_tuned = (ref_cutover.Tuning(), ref_cutover.Tuning(cutover_bytes=4096),
                 ref_cutover.Tuning(force_path="engine"))
    for tu, rtu in zip(tuned, ref_tuned):
        for npes in (1, 2, 8):
            for nbytes in (1, 4096, 1 << 20, 1 << 26):
                for wi in (None, 8, 128):
                    kw = dict(work_items=wi, tier=tier)
                    assert cutover.t_ring_step(nbytes, tuning=tu, **kw) == \
                        ref_cutover.t_ring_step(nbytes, tuning=rtu, **kw)
                    for ov in (False, True):
                        assert cutover.t_ring_allreduce(
                            nbytes, npes, tuning=tu, overlap=ov,
                            step_compute_bytes=nbytes / 3, **kw) == \
                            ref_cutover.t_ring_allreduce(
                                nbytes, npes, tuning=rtu, overlap=ov,
                                step_compute_bytes=nbytes / 3, **kw)
                    assert cutover.overlap_efficiency(
                        nbytes, npes, tuning=tu, **kw) == \
                        ref_cutover.overlap_efficiency(nbytes, npes,
                                                       tuning=rtu, **kw)
        assert cutover.choose_collective_path(
            "reduce", 1 << 20, 8, tier=tier, tuning=tu) == \
            ref_cutover.choose_collective_path("reduce", 1 << 20, 8,
                                               tier=tier, tuning=rtu)
    for wi in (1, 8, 128, 1024):
        assert cutover.cutover_bytes(work_items=wi, tier=tier) == \
            ref_cutover.cutover_bytes(work_items=wi, tier=tier)
    assert cutover.HwParams().reduce_bw == ref_cutover.HwParams().reduce_bw
