#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device and build: print the card's name and power limit, build the
   port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per source,
   in parallel), TF32 off;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes and at edge shapes (K1 and K3 bitwise, K2 to 2e-5 in f32
   and 2e-2 in bf16, the reference's tolerances), each timed with CUDA
   events beside its plain version and one PyTorch call computing the same
   function (timed only; the port never calls it);
3. the main path: ``repro_torch.launch.serve --disagg --full``, qwen3-4b at
   its published widths and depth, 2 prefill + 2 decode PEs, 8 requests of
   512 tokens, 16 new tokens each, 3 slots per decode PE, 256 KV blocks of
   16 tokens.  Launch counts are zeroed just before and read just after;
   every kernel must have launched.  Every request's greedy tokens must
   equal, bitwise, the port's own single-PE baseline at the same shapes
   (``Engine.generate_in_slot``), and the scheduler's counters must balance.

The line before the last is the ``kernels`` JSON record; the last is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repository
beside this file, it exits nonzero before printing any result.
"""
from __future__ import annotations

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


def check_copy(torch, rma_copy, dev):
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
    return {"name": "copy_into", "route": "cuda",
            "source": "src/repro_torch/csrc/rma_copy.cu",
            "replaces": "src/repro/kernels/rma_copy.py:46",
            "max_abs_err": 0.0,
            "ms": time_ms(torch, kernel, per_call=blocks),
            "plain_ms": time_ms(torch, plain, per_call=blocks),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": time_ms(torch, library, per_call=blocks),
            "shape": f"{n} bf16 words (one KV block payload) x {blocks} "
                     "offsets"}


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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, flash_attn, ishmem_device, ops, \
        rma_copy
    from repro_torch.launch import serve

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
    rows = [check_copy(torch, rma_copy, dev),
            check_flash(torch, flash_attn, dev),
            check_gather(torch, ishmem_device, dev)]
    for r in rows:
        say(f"{r['name']} [{r['shape']}]: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max|err| "
            f"{r['max_abs_err']}")
    torch.cuda.empty_cache()

    # ---- 3. the main path ---------------------------------------------------
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
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"main path never launched {missing}")
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

    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
