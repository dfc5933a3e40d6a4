"""The port's work counter and roofline (``repro_torch/roofline/{counter,
analysis}.py``): the reference's byte and wire formulas copied exactly; a
chain of matmuls counted as the reference's ``hlo_parser.analyze`` counts
the same chain jitted on the CPU; every kernel wrapper charging the same
work on its CPU (plain) and meta routes, with the plain version's own ops
left uncounted; and the roofline terms at the H100's peaks."""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.roofline import hlo_parser

from repro_torch.kernels import flash_attn, ishmem_device, ops, reduce_tile, \
    ring_collectives, rma_copy
from repro_torch.roofline import analysis, counter
from _torch_threads import one_intra_op_thread  # noqa: F401


def test_dtype_table_equals_the_reference():
    assert counter._DTYPE_BYTES == hlo_parser._DTYPE_BYTES


@pytest.mark.parametrize("type_str", [
    "f32[64,128]{1,0}", "bf16[2,3,4]", "(s32[], f32[2,3]{1,0}, pred[7])",
    "f8e4m3fn[16]", "token[]", "c128[3,3]", "u4[10]"])
def test_shape_bytes_equals_the_reference(type_str):
    assert counter.shape_bytes(type_str) == hlo_parser.shape_bytes(type_str)


@pytest.mark.parametrize("opcode", [
    "all-reduce", "all-reduce-start", "all-gather", "all-gather-start",
    "reduce-scatter", "all-to-all", "ragged-all-to-all",
    "collective-permute", "collective-broadcast", "broadcast", "barrier"])
def test_wire_bytes_equals_the_reference(opcode):
    for size in (0, 1, 4096, 1 << 30):
        for n in (1, 2, 4, 8, 256):
            assert counter._wire_bytes(opcode, size, n) == \
                hlo_parser._wire_bytes(opcode, size, n)


CHAINS = {
    "matmuls": ([(64, 128), (128, 256), (256, 32), (32, 16)],
                lambda m, x, a, b, c: m.tanh(((x @ a) @ b) @ c)),
    "batched": ([(4, 32, 64), (4, 64, 48), (48, 8)],
                lambda m, x, a, b: m.exp((x @ a) @ b)),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_matmul_chain_counts_as_the_hlo_parser(name):
    """FLOPs (2·M·N·K per product), the bytes of the unfused products and
    the transcendentals equal what the reference's static analyzer reads
    from the same chain's optimized HLO on the CPU."""
    shapes, fn = CHAINS[name]
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    hlo = jax.jit(lambda *a: fn(jnp, *a)).lower(
        *[jnp.asarray(x) for x in xs]).compile().as_text()
    want = hlo_parser.analyze(hlo)
    ts = [torch.from_numpy(x) for x in xs]
    with counter.count() as c:
        fn(torch, *ts)
    got = c.summary()
    for key in ("flops", "bytes", "transcendental", "collective_bytes"):
        assert got[key] == want[key], key


def test_views_cost_nothing_and_inplace_ops_read_and_write():
    x = torch.zeros(8, 16)
    with counter.count() as c:
        y = x.t().reshape(-1)            # a copy: 512 B read, 512 written
        x[2:4].unsqueeze(0)              # views
        x.mul_(2.0)                      # in place: read and written
    assert y.numel() == 128
    assert c.summary()["bytes"] == 512 + 512 + 512 + 512
    assert c.summary()["flops"] == 0


def test_charge_with_no_counter_does_nothing():
    def work():
        raise AssertionError("the work formula ran with no counter open")
    with counter.charge("flash_attention", work):
        pass


def _paged_inputs(dev):
    """K11's kernel wrapper: a pool of 6 blocks of 8 tokens holding two
    paged leaves, a host table (as the serving path passes it) and q."""
    g = torch.Generator().manual_seed(5)
    leaf, T = types.SimpleNamespace(reps=2, width=20, nkv=2, hd=64), 8
    words = 2 * leaf.reps * T * leaf.nkv * leaf.hd
    data = torch.randn(6, words, generator=g)
    table = torch.tensor([[0, 2, 6], [1, 3, 4]], dtype=torch.int32)
    q = torch.randn(2, leaf.width, 4, leaf.hd, generator=g)
    kw = dict(k_off=0, v_off=words // 2, leaf=leaf, layer=1, block_tokens=T)
    return (data.to(dev), table, q.to(dev)), kw


def _rand(*shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.randn(shape, generator=g).to(dtype)


def _on(dev, *tensors):
    return tuple(t.to(dev) for t in tensors)


def _table(dev, rows):
    return torch.tensor(rows, dtype=torch.int32).to(dev)


# name -> (kernel charged, the wrapper, its arguments on one device)
WRAPPERS = {
    "copy_into": ("copy_into", rma_copy.copy_into, lambda d: (
        (torch.zeros(300, device=d), _rand(7, 9).to(d), 11), {})),
    "flash_attention": ("flash_attention", flash_attn.flash_attention,
                        lambda d: (_on(d, _rand(2, 33, 4, 64),
                                       _rand(2, 33, 2, 64),
                                       _rand(2, 33, 2, 64)), {})),
    "flash_attention_bf16": ("flash_attention", flash_attn.flash_attention,
                             lambda d: (_on(d, *(_rand(
                                 1, 17, 8, 128, dtype=torch.bfloat16),) * 3),
                                 {})),
    "paged_gather": ("paged_gather", ishmem_device.paged_gather, lambda d: (
        (_rand(5, 256).to(d), _table(d, [[0, 4, 5], [2, 1, 3]])), {})),
    "paged_flash_attention": ("fused_paged_attn",
                              ishmem_device.paged_flash_attention,
                              _paged_inputs),
    "remote_put": ("remote_put", rma_copy.remote_put, lambda d: (
        (_rand(4, 3, 128).to(d),), {"target_offset": 3})),
    "ring_allgather": ("ring_allgather", ring_collectives.ring_allgather,
                       lambda d: ((_rand(4, 640).to(d),), {})),
    "ring_reduce_scatter": ("ring_reduce_scatter",
                            ring_collectives.ring_reduce_scatter,
                            lambda d: ((_rand(8, 8, 384).to(d),), {})),
    "push_broadcast": ("push_broadcast", ring_collectives.push_broadcast,
                       lambda d: ((_rand(8, 1000).to(d), 3), {})),
    "barrier_push": ("barrier_push", ring_collectives.barrier_push,
                     lambda d: ((8,), {"device": d})),
    "reduce_tile": ("reduce_tile", reduce_tile.reduce_tile, lambda d: (
        (_rand(6, 256).to(d), "max"), {})),
    "flash_partial_split": ("flash_partial_split",
                            ishmem_device.flash_partial_split, lambda d: (
                                _on(d, *(_rand(1, 9, 2, 32),) * 3), {})),
    "flash_partial": ("flash_partial", ishmem_device.flash_partial,
                      lambda d: (_on(d, _rand(1, 24, 2, 64),
                                     _rand(1, 16, 2, 64),
                                     _rand(1, 16, 2, 64)),
                                 {"q_off": 40, "k_off": 30})),
}


def _outs(out):
    return [(tuple(t.shape), t.dtype) for t in
            (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_charges_the_same_on_its_cpu_and_meta_routes(name):
    """One charge under the kernel's name, the work of its formula and
    nothing else (the plain version's ops are not counted); the meta route
    returns outputs of the kernel's shapes and dtypes and launches
    nothing."""
    kernel, fn, make = WRAPPERS[name]
    before = dict(ops.LAUNCHES)
    got = {}
    for dev in ("cpu", "meta"):
        args, kwargs = make(dev)
        with counter.count() as c:
            out = fn(*args, **kwargs)
        got[dev] = (c.summary(), _outs(out))
        assert all(t.device.type == dev for t in
                   (out if isinstance(out, tuple) else (out,)))
    assert ops.LAUNCHES == before
    (cpu, cpu_outs), (meta, meta_outs) = got["cpu"], got["meta"]
    assert cpu_outs == meta_outs
    cpu.pop("peak_bytes"), meta.pop("peak_bytes")
    assert cpu == meta
    assert list(cpu["by_kernel"]) == [kernel]
    rec = cpu["by_kernel"][kernel]
    assert rec["calls"] == 1
    for key in ("flops", "bytes", "transcendental"):
        assert cpu[key] == rec[key]
    assert cpu["collective_bytes"] == rec["collective_bytes"]
    assert rec["bytes"] > 0


def test_collective_charges_follow_the_ring_formulas():
    """K4-K7 charge the reference's wire bytes of one PE's operand, summed
    over the PEs; K8 one site of no bytes."""
    P, n = 4, 640
    x = torch.zeros(P, n)
    rows = torch.zeros(P, P, n)
    with counter.count() as c:
        rma_copy.remote_put(x)
        ring_collectives.ring_allgather(x)
        ring_collectives.ring_reduce_scatter(rows)
        ring_collectives.push_broadcast(x, 0)
        ring_collectives.barrier_push(P, device="cpu")
    s = c.summary()
    row = n * 4
    assert s["collective_by_kind"] == {
        "collective-permute": P * row,
        "all-gather": P * (P * row) * (P - 1) / P,
        "reduce-scatter": P * (P * row) * (P - 1) / P,
        "broadcast": P * row, "barrier": 0.0}
    assert s["n_collective_sites"] == 5
    assert s["by_kernel"]["ring_reduce_scatter"]["flops"] == (P - 1) * P * n


def test_a_kernel_inside_a_kernel_is_charged_once():
    """On the card K10 runs its split pass inside its own launch path: the
    outer formula covers it, so only ``flash_partial`` is charged (as on
    the CPU, where no split runs)."""
    q = torch.zeros(1, 16, 2, 32, device="meta")
    with counter.count() as c:
        ishmem_device.flash_partial(q, q, q, q_off=0, k_off=0)
        with counter.charge("flash_partial", lambda: {"bytes": 1}):
            ishmem_device.flash_partial_split(q, q, q)
    assert c.summary()["by_kernel"]["flash_partial"]["calls"] == 2
    assert "flash_partial_split" not in c.summary()["by_kernel"]


def test_flash_work_is_the_bound_formula():
    w = counter.flash_work(1, 4096, 32, 8, 128, 2)
    assert w["flops"] == 4 * 128 * 32 * 1 * 4096 * 4097 // 2
    assert w["bytes"] == 2 * (2 * 4096 * 32 * 128 + 2 * 4096 * 8 * 128)
    assert w["transcendental"] == 32 * 4096 * 4097 // 2
    assert counter.visible_pairs(4, 4, 0, 0) == 10
    assert counter.visible_pairs(4, 4, 4, 0) == 16
    assert counter.visible_pairs(4, 4, 0, 4) == 0


def _record(mesh, chips, args=0, outs=0, **counted):
    c = {"flops": 0, "bytes": 0, "transcendental": 0, "collective_bytes": 0}
    c.update(counted)
    return {"arch": "a", "shape": "s", "mesh": mesh, "status": "ok",
            "chips": chips, "dtype": "bfloat16", "counted": c,
            "counted_per_device": {k: v / chips for k, v in c.items()},
            "memory": {"argument_size_in_bytes": args,
                       "output_size_in_bytes": outs},
            "model_flops": 4.0e15}


def test_terms_use_the_h100_peaks():
    assert (analysis.PEAK_FLOPS, analysis.PEAK_FLOPS_TF32,
            analysis.HBM_BW) == (989e12, 495e12, 3.35e12)
    rec = _record("card", 1, args=5.025e12, outs=1.675e12, flops=9.89e15,
                  bytes=6.7e13, collective_bytes=3.35e11)
    t = analysis.terms(rec)
    assert t["compute_s"] == pytest.approx(10.0)
    # the memory term is the floor (arguments read, outputs written once);
    # the counted bytes are the eager traffic, reported beside it
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["eager_memory_s"] == pytest.approx(20.0)
    assert t["collective_s"] == pytest.approx(0.1)
    assert t["dominant"] == "compute" and t["step_s"] == t["compute_s"]
    assert t["useful_ratio"] == pytest.approx(4.0e15 / 9.89e15)
    assert t["mfu_bound"] == pytest.approx(4.0e15 / 989e12 / 10.0)
    m = analysis.measured(rec, 20.0)
    assert m["bound_share"] == pytest.approx(0.5)
    assert m["mfu"] == pytest.approx(4.0e15 / 20.0 / 989e12)
    pod = analysis.terms(_record("pod1", 256, args=6.7e12, flops=256e12,
                                 bytes=256 * 1e12,
                                 collective_bytes=1e20))
    assert pod["collective_s"] is None and pod["dominant"] == "memory"
    assert pod["eager_memory_s"] == pytest.approx(1e12 / 3.35e12)
    f32 = dict(_record("card", 1, flops=495e12), dtype="float32")
    assert analysis.terms(f32)["compute_s"] == pytest.approx(1.0)
    assert "tensor-core" in analysis.what_would_help(rec)
    assert "fuse elementwise" in analysis.what_would_help(rec)
    heavy = f32 | {"memory": {"argument_size_in_bytes": 3.35e15,
                              "output_size_in_bytes": 0}}
    assert "weights" in analysis.what_would_help(heavy)
    assert "fuse" not in analysis.what_would_help(heavy)


def test_table_reads_the_records(tmp_path, capsys, monkeypatch):
    rec = _record("card", 1, args=1e12, flops=1e12, bytes=1e12)
    (tmp_path / "a.s.card.json").write_text(json.dumps(rec))
    (tmp_path / "b.long_500k.card.json").write_text(json.dumps(
        {"arch": "b", "shape": "long_500k", "mesh": "card",
         "status": "skipped (full-attention arch at 500k context)"}))
    table = analysis.table(str(tmp_path), "card")
    lines = table.splitlines()
    assert len(lines) == 4 and "**memory**" in lines[2]
    assert "skipped" in lines[3]
    monkeypatch.setattr("sys.argv", ["analysis", str(tmp_path)])
    analysis.main()
    out = capsys.readouterr().out
    assert "989 TFLOP/s bf16" in out and "3.35 TB/s" in out
