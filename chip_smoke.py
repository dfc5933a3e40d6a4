#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device and build: print the card's name and power limit, build the
   port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per source,
   in parallel), TF32 off;
2. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at edge shapes (K1, K3 and K4-K8 bitwise, K2 to 2e-5
   in f32 and 2e-2 in bf16, the reference's tolerances), each timed with
   CUDA events beside its plain version and one PyTorch call computing the
   same function (timed only; the port never calls it).  The ring kernels
   K4-K8 run at 2, 4 and 8 PEs, chunk lengths 1, 127, 5157 and the main
   shapes, every dtype each takes, roots 0, 3 and 7 and offsets 1 and 3,
   each check 20 times over to catch ordering races, with every new
   output, landing and flag block poisoned (NaN or the integer maximum)
   so that a stale read cannot find an earlier run's equal value.  The
   bounds count each input read once and each output written once.  For
   the short
   kernels (K1, K4 at a small chunk, K8) the event time is the host's
   launch cost, so their rows also carry ``device_ms``, the device-only
   duration from ``torch.profiler``, measured after phase 4 so that the
   profiler's hooks cannot slow the timed phases;
3. the serving path: ``repro_torch.launch.serve --disagg --full``, qwen3-4b at
   its published widths and depth, 2 prefill + 2 decode PEs, 8 requests of
   512 tokens, 16 new tokens each, 3 slots per decode PE, 256 KV blocks of
   16 tokens.  Launch counts are zeroed just before and read just after;
   every kernel must have launched.  Every request's greedy tokens must
   equal, bitwise, the port's own single-PE baseline at the same shapes
   (``Engine.generate_in_slot``), and the scheduler's counters must balance;
4. the collectives path: ``repro_torch.launch.shmem_collectives --full``
   on 8 PEs at qwen3-4b's published widths, in f32 (the example's four
   steps, the tensor-parallel MLP at prefill and decode shapes against the
   engine backend and the unsharded MLP, the logits reduce, the bf16 layer
   broadcast, the hidden ppermute, and the ``Ishmem`` facade on a heap
   holding one bf16 MLP weight).  Launch counts are zeroed just before and
   read just after; K4-K8 must each have launched.

The line before the last is the ``kernels`` JSON record; the last is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repository
beside this file, it exits nonzero before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no TF32
TOL = {"float32": 2e-5, "bfloat16": 2e-2}             # tests/test_kernels.py

MAIN_ARGV = ["--disagg", "--full", "--arch", "qwen3-4b", "--seed", "0",
             "--prefill-pes", "2", "--decode-pes", "2", "--requests", "8",
             "--prompt-len", "512", "--max-new", "16", "--slots", "3",
             "--kv-blocks", "256", "--block-tokens", "16"]
COLL_ARGV = ["--full", "--arch", "qwen3-4b", "--npes", "8", "--seed", "0",
             "--prefill-tokens", "512", "--decode-batch", "8"]
SERVE_KERNELS = ("copy_into", "flash_attention", "paged_gather")
RING_KERNELS = ("remote_put", "ring_allgather", "ring_reduce_scatter",
                "push_broadcast", "barrier_push")
REPEATS = 20                         # each ring check, to catch races


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(torch, fn, *, iters: int = 20, per_call: int = 1) -> float:
    """Mean device milliseconds of one call: CUDA events around ``iters``
    runs of ``fn`` (each making ``per_call`` calls), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * per_call)


@contextlib.contextmanager
def poisoned(torch, dev):
    """Within the block, every tensor that ``torch.empty`` hands out comes
    filled with NaN (floats) or the type's largest value (integers), by
    PyTorch's deterministic mode.  A ring kernel's output, landing slots and
    flags are such tensors, so a kernel that reads a word before its writer
    has stored it, or leaves a word unwritten, shows a wrong element instead
    of the equal value an earlier run left in the recycled block."""
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = True
    try:
        probe = torch.empty(5, device=dev), torch.empty(
            5, dtype=torch.int32, device=dev)
        if not (bool(probe[0].isnan().all()) and
                probe[1].tolist() == [2**31 - 1] * 5):
            fail("torch.empty does not poison new blocks in deterministic "
                 "mode: the repeated ring checks could not see stale reads")
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def device_ms(torch, fn, match: str, *, iters: int = 50):
    """Mean device-only milliseconds of the kernels whose name contains
    ``match``, from ``torch.profiler`` over ``iters`` calls of ``fn``; None
    when the profiler shows no device time for them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and match in evt.key:
            total_us += evt.self_device_time_total
            count += evt.count
    return total_us / 1e3 / count if count and total_us else None


def check_copy(torch, rma_copy, dev, deferred):
    """K1 at edge shapes (bitwise), then timed at the main path's block
    payload: 32 blocks of one request staged at distinct offsets, so the
    source and destination bytes exceed the 50 MB L2."""
    gen = torch.Generator(device=dev).manual_seed(1)
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        for n, off in ((1, 3), (127, 129), (1179648, 1000), (1179648, 256)):
            row = (torch.randn(2_500_000, generator=gen, device=dev) * 50).to(dt)
            src = (torch.randn(n, generator=gen, device=dev) * 50).to(dt)
            got = rma_copy.copy_into(row.clone(), src, off)
            want = rma_copy.copy_into_plain(row.clone(), src, off)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"K1 copy_into differs from its plain version: {dt} "
                     f"n={n} offset={off}")
    n, blocks = 1179648, 32
    row = torch.zeros(blocks * n + 128, dtype=torch.bfloat16, device=dev)
    srcs = [torch.randn(n, generator=gen, device=dev).bfloat16()
            for _ in range(blocks)]
    offs = [b * n + 64 * (b % 2) for b in range(blocks)]

    def kernel():
        for src, off in zip(srcs, offs):
            rma_copy.copy_into(row, src, off)

    def plain():
        for src, off in zip(srcs, offs):
            rma_copy.copy_into_plain(row, src, off)

    def library():
        for src, off in zip(srcs, offs):
            row[off:off + n].copy_(src)

    nbytes = 2 * n * 2
    out = {"name": "copy_into", "route": "cuda",
            "source": "src/repro_torch/csrc/rma_copy.cu",
            "replaces": "src/repro/kernels/rma_copy.py:46",
            "max_abs_err": 0.0,
            "ms": time_ms(torch, kernel, per_call=blocks),
            "plain_ms": time_ms(torch, plain, per_call=blocks),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(torch, library, per_call=blocks),
            "shape": f"{n} bf16 words (one KV block payload) x {blocks} "
                     "offsets"}
    deferred.append((out, "device_ms",
                     lambda: rma_copy.copy_into(row, srcs[0], 0),
                     "copy_kernel"))
    return out


def check_flash(torch, flash_attn, dev):
    """K2 at S in {1, 37, 512}, GQA 32/8, hd 128, bf16 and f32; timed at
    the main path's prefill shape (B=1, S=512, bf16)."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(2)
    main_err = None
    for dt in (torch.float32, torch.bfloat16):
        for S in (1, 37, 512):
            q = torch.randn(1, S, 32, 128, generator=gen, device=dev).to(dt)
            k = torch.randn(1, S, 8, 128, generator=gen, device=dev).to(dt)
            v = torch.randn(1, S, 8, 128, generator=gen, device=dev).to(dt)
            got = flash_attn.flash_attention(q, k, v)
            want = flash_attn.flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = TOL[str(dt).removeprefix("torch.")]
            bad = (~torch.isclose(got.float(), want.float(), rtol=tol,
                                  atol=tol)).sum().item()
            say(f"K2 {dt} S={S}: max|err| {err:.3e} (tol {tol})")
            if bad or not math.isfinite(err):
                fail(f"K2 flash_attention: {bad} elements outside {tol} "
                     f"({dt}, S={S})")
            if dt == torch.bfloat16 and S == 512:
                main_err = err
    B, S, H, Hkv, hd = 1, 512, 32, 8, 128
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).bfloat16()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flops = 4 * hd * H * B * S * (S + 1) // 2         # causal QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS["bfloat16"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn.py:62",
            "max_abs_err": main_err,
            "ms": time_ms(torch, lambda: flash_attn.flash_attention(q, k, v)),
            "plain_ms": time_ms(
                torch, lambda: flash_attn.flash_attention_plain(q, k, v)),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            "shape": f"q ({B},{S},{H},{hd}) k/v ({B},{S},{Hkv},{hd}) bf16"}


def check_gather(torch, ishmem_device, dev):
    """K3 at the main path's pool row (256 blocks of 1,179,648 bf16 words)
    and table (3 slots x 33 entries), with unmapped entries; bitwise."""
    gen = torch.Generator(device=dev).manual_seed(3)
    R, W, slots, nb = 256, 1179648, 3, 33
    data = torch.randn(R, W, generator=gen, device=dev).bfloat16()
    perm = torch.randperm(R, generator=gen, device=dev).to(torch.int32)
    table = torch.full((slots, nb), R, dtype=torch.int32, device=dev)
    table[0] = perm[:nb]
    table[1] = perm[nb:2 * nb]
    table[2, :10] = perm[2 * nb:2 * nb + 10]       # a partly mapped slot
    got = ishmem_device.paged_gather(data, table)
    want = ishmem_device.paged_gather_plain(data, table)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("K3 paged_gather differs from its plain version")
    small = torch.randn(10, 37, generator=gen, device=dev)
    stab = torch.tensor([[3, 10], [10, 0]], dtype=torch.int32, device=dev)
    if not torch.equal(ishmem_device.paged_gather(small, stab),
                       ishmem_device.paged_gather_plain(small, stab)):
        fail("K3 paged_gather differs from its plain version (odd width)")
    padded = torch.cat([data, data.new_zeros(1, W)])
    idx = table.reshape(-1).long()
    mapped = int((table < R).sum())
    nbytes = (mapped + table.numel()) * W * 2 + table.numel() * 4
    return {"name": "paged_gather", "route": "cuda",
            "source": "src/repro_torch/csrc/ishmem_device.cu",
            "replaces": "src/repro/kernels/ishmem_device.py:47",
            "max_abs_err": 0.0,
            "ms": time_ms(torch, lambda: ishmem_device.paged_gather(data, table)),
            "plain_ms": time_ms(
                torch, lambda: ishmem_device.paged_gather_plain(data, table)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(
                torch, lambda: torch.index_select(padded, 0, idx)),
            "shape": f"data ({R},{W}) bf16, table ({slots},{nb}), "
                     f"{mapped} mapped"}


def _ring_cases(rc, rma_copy, P, n, dt, dev, gen, torch):
    """(label, kernel call, plain result) for every ring check at one
    (P, chunk length, dtype)."""
    x = (torch.randn(P, n, generator=gen, device=dev) * 50).to(dt)
    cases = [("K5 ring_allgather", lambda: rc.ring_allgather(x),
              rc.ring_allgather_plain(x))]
    for root in (r for r in (0, 3, 7) if r < P):
        cases.append((f"K7 push_broadcast root={root}",
                      lambda root=root: rc.push_broadcast(x, root),
                      rc.push_broadcast_plain(x, root)))
    for off in (1, 3):
        cases.append((f"K4 remote_put offset={off}",
                      lambda off=off: rma_copy.remote_put(
                          x, target_offset=off, work_items=128),
                      rma_copy.remote_put_plain(x, off)))
    if dt != torch.int32:
        xa = torch.randn(P, P, n, generator=gen, device=dev).to(dt)
        cases.append(("K6 ring_reduce_scatter",
                      lambda: rc.ring_reduce_scatter(xa),
                      rc.ring_reduce_scatter_plain(xa)))
    return cases


def check_ring(torch, rc, rma_copy, _build, dev, deferred):
    """K4-K8 against their plain versions, bitwise, each check repeated
    REPEATS times on poisoned output, landing and flag memory; then timed at
    the collectives path's main shapes (P=8) beside the plain version, the
    yardstick and the bound."""
    gen = torch.Generator(device=dev).manual_seed(4)
    checks = 0
    with poisoned(torch, dev):
        for P in (2, 4, 8):
            for n in (1, 127, 128 * 40 + 37):
                for dt in (torch.float32, torch.bfloat16, torch.int32):
                    for label, kernel, want in _ring_cases(
                            rc, rma_copy, P, n, dt, dev, gen, torch):
                        for _ in range(REPEATS):
                            got = kernel()
                            torch.cuda.synchronize()
                            if not torch.equal(got, want):
                                fail(f"{label} differs from its plain "
                                     f"version: P={P} n={n} {dt}")
                            checks += 1
            for _ in range(REPEATS):
                got = rc.barrier_push(P, device=dev)
                torch.cuda.synchronize()
                if got.tolist() != [1] * P:
                    fail(f"K8 barrier_push returned {got.tolist()} at P={P}")
                checks += 1
    say(f"K4-K8 edge shapes: {checks} checks on poisoned memory, bitwise "
        "equal to the plain versions")

    P = 8
    hidden = torch.randn(P, 512 * 2560, generator=gen, device=dev)
    small = torch.randn(P, 2560, generator=gen, device=dev)
    shard = torch.randn(P, 163840, generator=gen, device=dev)
    rows = torch.randn(P, P, 163840, generator=gen, device=dev)
    leaf = torch.randn(P, 2560 * 9728, generator=gen,
                       device=dev).bfloat16()
    main = [
        ("remote_put", "K4", "src/repro/kernels/rma_copy.py:104",
         lambda: rma_copy.remote_put(hidden, target_offset=1,
                                     work_items=128),
         lambda: rma_copy.remote_put_plain(hidden, 1),
         lambda: torch.roll(hidden, 1, 0),
         2 * hidden.numel() * 4,
         "x (8, 1310720) f32: the prefill hidden (512, 2560) per PE"),
        ("ring_allgather", "K5", "src/repro/kernels/ring_collectives.py:67",
         lambda: rc.ring_allgather(shard), lambda: rc.ring_allgather_plain(shard),
         lambda: shard.unsqueeze(0).expand(P, *shard.shape).contiguous(),
         (P + P * P) * shard[0].numel() * 4,          # read x, write out
         "x (8, 163840) f32: the all-gather of the prefill RS+AG psum"),
        ("ring_reduce_scatter", "K6",
         "src/repro/kernels/ring_collectives.py:125",
         lambda: rc.ring_reduce_scatter(rows),
         lambda: rc.ring_reduce_scatter_plain(rows), lambda: rows.sum(0),
         (P * P + P) * rows[0, 0].numel() * 4,        # read x, write out
         "x (8, 8, 163840) f32: the reduce-scatter of the prefill psum"),
        ("push_broadcast", "K7", "src/repro/kernels/ring_collectives.py:186",
         lambda: rc.push_broadcast(leaf, 0),
         lambda: rc.push_broadcast_plain(leaf, 0),
         lambda: leaf[0].expand_as(leaf).contiguous(),
         (P + 1) * leaf[0].numel() * 2,
         "x (8, 24903680) bf16: one w_gate leaf, root 0"),
    ]
    rows_out = []
    for name, k, replaces, kernel, plain, library, nbytes, shape in main:
        want = plain()
        with poisoned(torch, dev):
            for _ in range(REPEATS):
                got = kernel()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"{k} {name} differs from its plain version at "
                         f"{shape}")
        del got, want
        rows_out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/ring_collectives.cu",
            "replaces": replaces, "max_abs_err": 0.0,
            "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(torch, library), "shape": shape})
    deferred.append((rows_out[0], "device_ms",
                     lambda: rma_copy.remote_put(small, target_offset=1,
                                                 work_items=8),
                     "remote_put_kernel"))
    rows_out[0]["device_shape"] = "x (8, 2560) f32, work_items 8: " \
        "psum_overlap's small branch at decode"
    lib = _build.lib()

    def noop():
        rc_ = lib.ishmem_coop_noop(dev.index or 0, P,
                                   torch.cuda.current_stream().cuda_stream)
        if rc_:
            fail(f"empty cooperative launch failed: CUDA error {rc_}")

    barrier = {
        "name": "barrier_push", "route": "cuda",
        "source": "src/repro_torch/csrc/ring_collectives.cu",
        "replaces": "src/repro/kernels/ring_collectives.py:219",
        "max_abs_err": 0.0,
        "ms": time_ms(torch, lambda: rc.barrier_push(P, device=dev)),
        "plain_ms": time_ms(torch, lambda: rc.barrier_push_plain(P, dev)),
        "bound_ms": time_ms(torch, noop), "bound_by": "operations",
        "library_ms": None,
        "shape": "8 PEs; bound = one empty cooperative launch of 8 CTAs"}
    deferred.append((barrier, "device_ms",
                     lambda: rc.barrier_push(P, device=dev),
                     "barrier_kernel"))
    deferred.append((barrier, "noop_device_ms", noop, "noop_kernel"))
    return rows_out + [barrier]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, flash_attn, ishmem_device, ops, \
        ring_collectives, rma_copy
    from repro_torch.launch import serve, shmem_collectives

    # ---- 1. device and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    say(f"torch {torch.__version__} (CUDA {torch.version.cuda}); kernels "
        f"built in {time.perf_counter() - t0:.1f} s -> {so.name}")

    # ---- 2. kernels against their plain versions ----------------------------
    deferred = []                    # device-only timings, taken last
    rows = [check_copy(torch, rma_copy, dev, deferred),
            check_flash(torch, flash_attn, dev),
            check_gather(torch, ishmem_device, dev)]
    torch.cuda.empty_cache()
    rows += check_ring(torch, ring_collectives, rma_copy, _build, dev,
                       deferred)
    for r in rows:
        lib_ms = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        say(f"{r['name']} [{r['shape']}]: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib_ms}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max|err| "
            f"{r['max_abs_err']}")
    torch.cuda.empty_cache()

    # ---- 3. the serving path ------------------------------------------------
    say("main path: serve " + " ".join(MAIN_ARGV) + " (depth 36, no cut)")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = serve.main(MAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    say(f"main path: {wall:.2f} s wall, {sched.stats.decode_steps} decode "
        f"steps, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
        f"launches {launches}")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"serving path never launched {missing}")
    st = sched.stats
    counts = (st.prefills, st.migrations, st.admissions, st.evictions)
    ratio = sched.ctx.pending.stats.coalescing_ratio()
    say(f"SchedStats prefills/migrations/admissions/evictions = {counts}; "
        f"coalescing ratio {ratio:.2f}")
    if counts != (8, 8, 8, 8) or not ratio > 1.0:
        fail("scheduler counters do not balance")

    eng, slots = sched.engine, len(sched.banks[sched.decode_pes[0]].active)
    t0 = time.perf_counter()
    for rid, req in sorted(sched.requests.items()):
        base = eng.generate_in_slot(req.batch, sched.scfg, num_slots=slots,
                                    slot=req.slot)
        if base != req.out:
            fail(f"request {rid}: disaggregated tokens {req.out} != "
                 f"single-PE baseline {base}")
    torch.cuda.synchronize()
    say(f"8/8 requests bitwise equal to the single-PE baseline "
        f"({time.perf_counter() - t0:.2f} s for the baseline)")
    _, logits, _ = eng.prefill_request(sched.requests[0].batch)
    if logits.shape != (1, sched.engine.cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"prefill logits not finite of shape (1, vocab): {logits.shape}")

    del sched, eng, logits
    torch.cuda.empty_cache()

    # ---- 4. the collectives path --------------------------------------------
    say("collectives path: shmem_collectives " + " ".join(COLL_ARGV))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = shmem_collectives.main(COLL_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    coll_launches = dict(ops.LAUNCHES)
    worst = max(report["max_abs_err"].items(), key=lambda kv: kv[1])
    say(f"collectives path: {wall:.2f} s wall, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; launches "
        f"{coll_launches}; {len(report['max_abs_err'])} checks, largest "
        f"|err| {worst[1]:.3e} ({worst[0]})")
    missing = [k for k in RING_KERNELS if coll_launches[k] == 0]
    if missing:
        fail(f"collectives path never launched {missing}")

    # ---- device-only times of the short kernels (torch.profiler) -----------
    for row, key, fn, match in deferred:
        row[key] = device_ms(torch, fn, match)
        say(f"{row['name']} {key}: " + ("not measured" if row[key] is None
                                        else f"{row[key]:.5f} ms"))

    for r in rows:
        r["launches"] = (launches if r["name"] in SERVE_KERNELS
                         else coll_launches)[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
