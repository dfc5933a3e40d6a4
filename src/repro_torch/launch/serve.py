"""Serving launcher: lockstep batched generation, and disaggregated
prefill/decode with SHMEM paged-KV migration and paged decode attention.

Counterpart of ``repro/launch/serve.py`` (its lockstep mode,
``_run_disagg`` with ``--fused-attn``, ``--stream-chunks``,
``--shared-prefix``, ``--dense-rehydrate`` and ``--trace``,
``--overlap-report`` and ``--seq-parallel``).  Runs on the current CUDA device unless ``--device``
says otherwise; ``--full`` serves the architecture at its published widths
instead of the reduced test variant.

  # lockstep batch
  PYTHONPATH=src python -m repro_torch.launch.serve --batch 4

  # disaggregated: 2 prefill PEs migrate paged KV to 2 decode PEs, decode
  # reads K/V straight from the pool
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg \\
      --prefill-pes 2 --decode-pes 2 --requests 8 --slots 3

  # full-width qwen3-4b on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg --full \\
      --prompt-len 512 --kv-blocks 256

  # any of the ten configurations (MoE, gelu, sliding window, whisper's
  # encoder-decoder with its audio embeddings, vision with image
  # embeddings), reduced on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg \\
      --arch whisper-medium --device cpu

  # fused protocol: per-block migration signals, first-block admission,
  # per-signal block consumption before each decode step
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg --fused-attn

  # chunked streaming: 4 blocks per installment mid-prefill, slot-less
  # until the close; write the span trace (load it in ui.perfetto.dev)
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg \
      --stream-chunks 4 --trace /tmp/serve_trace.json

  # every request a sample of one prompt: the prefix blocks are mapped,
  # not staged again, and copied on the first divergent write
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg --shared-prefix

  # the A/B control: admission rehydrates a dense slot cache
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg \
      --dense-rehydrate

  # sequence-parallel ring attention over 8 PEs at qwen3-4b's attention
  # widths (32 heads of 128) and a 32768-token context
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg --full \\
      --seq-parallel 8 --prompt-len 32768

  # modeled nbi-vs-blocking pricing of the decode allreduces at the
  # architecture's published widths (the cost model, not a measurement)
  PYTHONPATH=src python -m repro_torch.launch.serve --overlap-report
"""
from __future__ import annotations

import argparse

import torch


def make_batch(cfg, gen: torch.Generator, batch: int, prompt_len: int,
               device) -> dict:
    """Random request batch drawn from ``gen``, with the frontend
    embeddings the family needs: whisper's ``audio_embeds`` (B,
    encoder_seq, d) and the vision model's ``image_embeds`` (B,
    image_tokens, d), standard normal in f32, as the reference's
    ``_make_batch`` draws them."""
    b = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                 generator=gen, device=gen.device)}
    frontend = {"audio": ("audio_embeds", cfg.encoder_seq),
                "vlm": ("image_embeds", cfg.image_tokens)}.get(cfg.family)
    if frontend is not None:
        key, n = frontend
        b[key] = torch.randn((batch, n, cfg.d_model), generator=gen,
                             device=gen.device)
    return {k: v.to(device) for k, v in b.items()}


def _overlap_report(args) -> None:
    """Modeled nbi-vs-blocking report for the decode collectives at the
    full architecture's shapes: the hidden (d_model) and logits (vocab)
    allreduces over a batch sweep, with the batch where the nbi schedule
    starts to win.  These are the cost model's numbers
    (``cutover.overlap_efficiency``), not measurements."""
    from repro_torch.comms import api as comms_api
    from repro_torch.configs import base as cfgbase

    full = cfgbase.get_config(args.arch)
    ops = comms_api.get_ops("shmem", npes=args.comms_npes)
    print(f"[serve] overlap report — production shapes for {full.name}: "
          f"d_model={full.d_model} vocab={full.vocab_size} "
          f"npes={args.comms_npes}")
    batches = [1, 2, 4, 8, 16, 32, 64, 128, 256]
    for name, per_tok in (("hidden", full.d_model * 4),
                          ("logits", full.vocab_size * 4)):
        crossover = None
        rows = []
        for B in batches:
            nbytes = B * per_tok
            eff = ops.modeled_overlap_efficiency(nbytes)
            rows.append((B, nbytes, eff))
            if crossover is None and eff > 1.0:
                crossover = B
        for B, nbytes, eff in rows:
            verdict = "nbi" if eff > 1.0 else "blocking"
            print(f"[serve]   {name:6s} B={B:<4d} {nbytes:>12d} B  "
                  f"overlap x{eff:.2f} -> {verdict}")
        if crossover is None:
            print(f"[serve]   {name}: alpha-bound at every swept batch "
                  f"-> stay blocking")
        else:
            print(f"[serve]   {name}: nbi wins from batch {crossover} "
                  f"({crossover * per_tok} B per decode step)")


def seq_parallel_report(npes: int, *, prompt_len: int, full: bool = False,
                        arch: str = "qwen3-4b", seed: int = 0,
                        scale: float = 0.1, device=None) -> dict:
    """Sequence-parallel ring attention: the context is sharded over
    ``npes`` PEs, each ring step's K/V rotation is issued device-side (a
    work-group ``put_signal_nbi`` to the right neighbour, then a device
    ``signal_wait_until`` before the next K10 partial reads the landed
    shard), the partials merge per PE, and the result is checked against
    single-PE flash attention (K2).  Ends with the modeled blocking-vs-
    overlapped step pricing (``cutover.t_ring_attention``; the cost model,
    not a measurement).

    Widths: the reference's ``B=1, H=4, hd=32``, or with ``full`` the
    architecture's attention widths (qwen3-4b: 32 heads of 128); B=1, f32,
    S from ``prompt_len`` rounded up to a multiple of ``npes``.  q, k and v
    are standard normal times ``scale``: the reference's 0.1 makes the
    softmax nearly flat, so far along the sequence one key more or less
    moves an output by less than the check's 5e-5; 1.0 keeps a mask error
    at a shard border visible.  Returns the report as a dict."""
    from repro_torch import _devices
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import context, device as device_mod
    from repro_torch.core.cutover import ring_attention_overlap, \
        t_ring_attention
    from repro_torch.core.heap import ALIGN
    from repro_torch.core.signal import SIGNAL_ADD
    from repro_torch.kernels import flash_attn, ishmem_device

    device = _devices.resolve(device)
    full_cfg = cfgbase.get_config(arch)
    B, H, hd = (1, full_cfg.num_heads, full_cfg.hd) if full else (1, 4, 32)
    S = ((max(prompt_len, 8 * npes) + npes - 1) // npes) * npes
    Sh = S // npes
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((B, S, H, hd), generator=gen, device=device)
               * scale for _ in range(3))
    shard_words = 2 * B * Sh * H * hd               # k + v, one shard
    ctx, heap = context.init(
        npes=npes, node_size=npes, device=device,
        heap_words=max(1 << 20, -(-shard_words // ALIGN) * ALIGN))
    buf = heap.malloc((shard_words,), torch.float32)
    sig = heap.malloc((1,), torch.int32)

    def pack(j):
        return torch.cat([k[:, j * Sh:(j + 1) * Sh].reshape(-1),
                          v[:, j * Sh:(j + 1) * Sh].reshape(-1)])

    def unpack(flat):
        kv = flat.reshape(2, B, Sh, H, hd)
        return kv[0], kv[1]

    for i in range(npes):                           # shard i starts at PE i
        heap = heap.write(buf, i, pack(i))
        heap = heap.write(sig, i, torch.zeros(1, dtype=torch.int32))
    parts = [[] for _ in range(npes)]
    for t in range(npes):
        for i in range(npes):
            j = (i - t) % npes                      # shard resident at PE i
            if j <= i:                              # causal: skip future kv
                kj, vj = unpack(heap.read(buf, i))
                parts[i].append(ishmem_device.flash_partial(
                    q[:, i * Sh:(i + 1) * Sh].contiguous(), kj, vj,
                    q_off=i * Sh, k_off=j * Sh))
        if t == npes - 1:
            break
        # device-side rotation: every PE's work-group pushes its current
        # shard to the RIGHT neighbour with a signal, then waits for the
        # shard arriving from the left before the next step reads it
        shards = [heap.read(buf, i) for i in range(npes)]
        for i in range(npes):
            wg = device_mod.work_group(ctx, pe=i)
            heap = device_mod.put_signal_nbi(
                wg, heap, buf, shards[i], sig, 1, SIGNAL_ADD,
                (i + 1) % npes)
        for i in range(npes):
            wg = device_mod.work_group(ctx, pe=i)
            heap, _, ok = device_mod.signal_wait_until(
                wg, heap, sig, i, "ge", t + 1)
            if not ok:
                raise RuntimeError("ring neighbour's shard never landed")
    out = torch.cat([ishmem_device.merge_partials(parts[i])
                     for i in range(npes)], dim=1)
    ref = flash_attn.flash_attention(q, k, v)
    err = float((out - ref.to(out.dtype)).abs().max())
    print(f"[serve] seq-parallel ring attention: npes={npes} S={S} "
          f"(shard {Sh}) max|err| vs single-PE flash = {err:.2e}")
    dev_ops = sorted({key[0] for key in ctx.telemetry.buckets
                      if key[0].startswith("device_")})
    print(f"[serve]   device ops on the wire: {', '.join(dev_ops)}")
    # modeled step pricing at the full architecture's shapes and a
    # production context length; per ring step each PE moves one K/V shard
    # and runs one partial over it, priced as the q + k + v + o bytes
    S_prod = max(prompt_len, 32768)
    kv_bytes = 2 * (S_prod // npes) * full_cfg.d_model * 4
    compute = 4 * (S_prod // npes) * full_cfg.d_model * 4
    tb = t_ring_attention(kv_bytes, compute, npes, overlap=False,
                          tuning=ctx.tuning)
    to = t_ring_attention(kv_bytes, compute, npes, overlap=True,
                          tuning=ctx.tuning)
    ratio = ring_attention_overlap(kv_bytes, compute, npes,
                                   tuning=ctx.tuning)
    print(f"[serve]   modeled ring step: blocking {tb * 1e6:.1f} us vs "
          f"overlapped {to * 1e6:.1f} us -> x{ratio:.2f} "
          f"({'overlap wins' if ratio > 1 else 'alpha-bound'})")
    return {"npes": npes, "S": S, "shard": Sh, "heads": H, "head_dim": hd,
            "partials": sum(len(p) for p in parts), "max_abs_err": err,
            "device_ops": dev_ops, "shape": tuple(out.shape),
            "finite": bool(torch.isfinite(out).all()),
            "t_blocking": tb, "t_overlap": to, "overlap_ratio": ratio}


def _build_disagg(args, cfg, params):
    """The disaggregated scheduler for ``args`` with its requests submitted
    and nothing run.  ``--trace`` puts a recording span tracer on the
    context."""
    from repro_torch.core import context, teams
    from repro_torch.obs.tracer import SpanTracer
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.kvpool import KVPool
    from repro_torch.serve.kvxfer import KVMigrator
    from repro_torch.serve.scheduler import DisaggScheduler

    device = params["embed"].device
    npes = args.prefill_pes + args.decode_pes
    ctx, heap = context.init(npes=npes, node_size=npes, device=device)
    if args.trace:
        ctx.tracer = SpanTracer()
    pre, dec = teams.disagg_partition(teams.world(npes), args.prefill_pes)
    max_len = args.prompt_len + args.max_new
    eng = Engine(cfg, params, max_len=max_len, device=device)
    pool = KVPool.create(heap, cfg, max_len, num_blocks=args.kv_blocks,
                         max_slots=args.slots, block_tokens=args.block_tokens)
    sched = DisaggScheduler(
        ctx, heap, eng, pool, KVMigrator(ctx, pool),
        prefill_pes=pre.pes(), decode_pes=dec.pes(), num_slots=args.slots,
        scfg=ServeConfig(max_new_tokens=args.max_new,
                         temperature=args.temperature, seed=args.seed),
        admit_delay_steps=args.admit_delay, paged=not args.dense_rehydrate,
        stream_chunks=args.stream_chunks, fused_attn=args.fused_attn,
        shared_prefix=args.shared_prefix)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    if args.shared_prefix:
        # many samples of one prompt: every request maps the same prefix
        base = make_batch(cfg, gen, 1, args.prompt_len, device)
        for _ in range(args.requests):
            sched.submit(dict(base), prefix_len=args.prompt_len)
    else:
        for _ in range(args.requests):
            sched.submit(make_batch(cfg, gen, 1, args.prompt_len, device))
    return sched


def build_disagg(argv=None):
    """Parse ``argv`` (with ``--disagg``), build the model and return
    ``(sched, args)``: the scheduler with its requests submitted, for a
    caller that steps it itself and then calls :func:`report_disagg`."""
    args = build_parser().parse_args(argv)
    if not args.disagg:
        raise ValueError("build_disagg needs --disagg")
    cfg, params = _model(args)
    return _build_disagg(args, cfg, params), args


def report_disagg(sched, args) -> None:
    """Print the reference's report lines for a finished run; with
    ``--trace``, write the Chrome trace and fail if it does not validate."""
    st, ctx, pool = sched.stats, sched.ctx, sched.pool
    outs = {rid: r.out for rid, r in sched.requests.items()}
    mode = "dense-rehydrate" if args.dense_rehydrate else "paged"
    print(f"[serve] disagg arch={sched.engine.cfg.name} "
          f"prefill={sched.prefill_pes} decode={sched.decode_pes} tier=ici "
          f"decode-cache={mode}")
    print(f"[serve]   {st.prefills} prefills, {st.migrations} migrations "
          f"({st.bytes_migrated} B), {st.admissions} admissions, "
          f"{st.evictions} evictions over {st.decode_steps} decode steps")
    if st.ttfd_steps:
        avg_steps = sum(st.ttfd_steps) / len(st.ttfd_steps)
        avg_t = sum(st.ttfd_model_s) / len(st.ttfd_model_s)
        print(f"[serve]   time-to-first-decode-token: {avg_steps:.1f} sched "
              f"steps / {avg_t * 1e6:.1f} us modeled comm window")
    if st.ttfd_first_block_steps:
        avg_fb = (sum(st.ttfd_first_block_steps)
                  / len(st.ttfd_first_block_steps))
        mode_tag = "fused admission gate" if args.fused_attn else "observed"
        print(f"[serve]   time-to-first-resident-block: {avg_fb:.1f} sched "
              f"steps ({mode_tag})")
    if args.stream_chunks:
        print(f"[serve]   streaming: {st.stream_chunks} wire installments "
              f"of {args.stream_chunks} block(s)")
    if args.shared_prefix:
        print(f"[serve]   shared prefix: {st.prefix_hits} hits, "
              f"{st.blocks_prefix_shared} blocks mapped, "
              f"{st.bytes_wire_saved} wire B saved, "
              f"{st.cow_copies} copy-on-writes")
    print(f"[serve]   stalls: pool={st.stalled_on_pool} "
          f"slots={st.stalled_on_slots}; coalescing ratio "
          f"{ctx.pending.stats.coalescing_ratio():.2f}")
    ps = pool.stats(sched.heap)
    print(f"[serve]   pool: {ps['blocks_in_use']}/{ps['blocks_total']} "
          f"blocks in use; heap: {ps['heap']['bytes_in_use']} B in use, "
          f"{ps['heap']['bytes_free']} B free")
    for rid in sorted(outs)[:4]:
        print(f"[serve]   req {rid}: {outs[rid]}")
    if args.trace:
        from repro_torch.obs.export import validate, write_chrome_trace
        doc = write_chrome_trace(ctx.tracer, args.trace)
        errors = validate(doc)
        if errors:
            raise RuntimeError(f"trace {args.trace} does not validate: "
                               f"{errors[:5]}")
        print(f"[serve]   trace: {len(doc['traceEvents'])} events -> "
              f"{args.trace} (load in ui.perfetto.dev)")


def _run_disagg(args, cfg, params):
    """Serve ``args.requests`` random prompts disaggregated; prints the
    reference's report lines and returns the finished scheduler."""
    sched = _build_disagg(args, cfg, params)
    sched.run()
    report_disagg(sched, args)
    return sched


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--full", action="store_true",
                    help="serve the architecture at its published widths "
                         "(default: the reduced test variant)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--overlap-report", action="store_true",
                    help="after the run, model the decode-step collectives "
                         "under the nbi schedule vs blocking at the full "
                         "architecture's shapes and print the crossover")
    ap.add_argument("--comms-npes", type=int, default=8)
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill/decode with SHMEM paged-KV "
                         "migration")
    ap.add_argument("--prefill-pes", type=int, default=2)
    ap.add_argument("--decode-pes", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=3,
                    help="decode slots per decode PE")
    ap.add_argument("--kv-blocks", type=int, default=64,
                    help="paged KV pool size in blocks")
    ap.add_argument("--block-tokens", type=int, default=16)
    ap.add_argument("--admit-delay", type=int, default=1,
                    help="modeled wire latency in scheduler steps before a "
                         "migration's signal is polled (streamed closes "
                         "scale it by the final installment's share)")
    ap.add_argument("--stream-chunks", type=int, default=0,
                    metavar="BLOCKS",
                    help="chunked prefill streaming: put BLOCKS filled "
                         "blocks on the wire per scheduler step mid-prefill "
                         "(0 = whole-prefill migration)")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="serve every request as a sample of one shared "
                         "prompt: prefix blocks are mapped (incref), not "
                         "re-staged, with copy-on-write on divergence")
    ap.add_argument("--dense-rehydrate", action="store_true",
                    help="dense-cache admission (gather + insert) instead "
                         "of paged decode attention: the A/B control")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record causal spans and write a Chrome trace "
                         "(fails if it does not validate)")
    ap.add_argument("--fused-attn", action="store_true",
                    help="device-initiated fused decode protocol: per-block "
                         "migration signals, first-block admission, and "
                         "per-signal block consumption before each decode "
                         "step (excludes --stream-chunks)")
    ap.add_argument("--seq-parallel", type=int, default=0, metavar="N",
                    help="sequence-parallel ring attention over N PEs: "
                         "device-side K/V rotation per ring step, checked "
                         "against single-PE flash, plus the modeled "
                         "blocking-vs-overlap step pricing (with --full at "
                         "the architecture's attention widths)")
    return ap


def _model(args):
    """(cfg, params) on the resolved device: the architecture at its
    published widths with ``--full``, else its reduced variant."""
    from repro_torch import _devices
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import model

    device = _devices.resolve(args.device)
    cfg = cfgbase.get_config(args.arch)
    if not args.full:
        cfg = cfgbase.reduced(cfg)
    return cfg, model.init_params(cfg, seed=args.seed, device=device)


def main(argv=None):
    """Run the launcher; returns the finished scheduler (``--disagg``) or
    the generated ids (lockstep)."""
    args = build_parser().parse_args(argv)
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg, params = _model(args)
    device = params["embed"].device
    if args.disagg:
        out = _run_disagg(args, cfg, params)
    else:
        eng = Engine(cfg, params, max_len=args.prompt_len + args.max_new,
                     device=device)
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        batch = make_batch(cfg, gen, args.batch, args.prompt_len, device)
        out = eng.generate(batch, ServeConfig(max_new_tokens=args.max_new,
                                              temperature=args.temperature,
                                              seed=args.seed))
        print(f"[serve] arch={cfg.name} generated {tuple(out.shape)}:")
        print(out.cpu().numpy())
    if args.overlap_report:
        _overlap_report(args)
    if args.seq_parallel:
        seq_parallel_report(args.seq_parallel, prompt_len=args.prompt_len,
                            full=args.full, arch=args.arch, seed=args.seed,
                            device=device)
    return out


if __name__ == "__main__":
    main()
