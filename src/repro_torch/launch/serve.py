"""Serving launcher: lockstep batched generation, disaggregated
prefill/decode with SHMEM paged-KV migration and paged decode attention,
and the cluster fleet.

Counterpart of ``repro/launch/serve.py`` (its lockstep mode,
``_run_disagg`` with ``--fused-attn``, ``--stream-chunks``,
``--shared-prefix``, ``--dense-rehydrate``, ``--cross-pod`` and
``--trace``, ``_run_fleet`` with ``--chaos``, ``--overlap-report`` and
``--seq-parallel``, and the observability flags ``--trace``,
``--metrics``, ``--refit``, ``--audit``, ``--recorder``, ``--alerts``,
``--profile`` and ``--calibration``, which build one
:class:`repro_torch.obs.Obs` bundle with the ``ISHMEM_OBS_*`` variables).
``--trace-clock wall`` is the port's own: the reference traces on the
step clock alone.
Runs on the current CUDA device unless ``--device`` says otherwise;
``--full`` serves the architecture at its published widths instead of the
reduced test variant.

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

  # where the decode step and staging spend their time: the trace on
  # the torch profiler's clock, with spans inside each step
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg --full \
      --prompt-len 512 --kv-blocks 256 --trace /tmp/t.json --trace-clock wall

  # every request a sample of one prompt: the prefix blocks are mapped,
  # not staged again, and copied on the first divergent write
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg --shared-prefix

  # measured: wall-clock scopes on prefill, decode, paged attention and
  # stream flushes, and the measured-vs-modeled calibration report
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg --profile \
      --calibration /tmp/calibration.json

  # the A/B control: admission rehydrates a dense slot cache
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg \
      --dense-rehydrate

  # sequence-parallel ring attention over 8 PEs at qwen3-4b's attention
  # widths (32 heads of 128) and a 32768-token context
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg --full \\
      --seq-parallel 8 --prompt-len 32768

  # decode PEs in a second pod: every migration crosses pods (dcn tier)
  # and drains through the host-proxy ring
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg --cross-pod

  # the fleet: open-loop traffic from three tenants over 2 pods, routed by
  # prefix affinity, admitted by deadline class (with preemption)
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet --pods 2 \
      --rate 1.2 --fleet-steps 16 --admission slo --router affinity

  # the same under a fault plan (or set ISHMEM_FAULT_PLAN and pass --chaos)
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet \
      --chaos 'kill_pe=2@4,partition=3@6,kill_pod=pod1@9'

  # the observability bundle on the fleet: metrics rows, auditors every
  # step, a flight recorder of 8 steps, burn-rate alerts, an online re-fit
  # of the cutover table every 4 steps from profiled samples
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet --metrics \
      /tmp/m.json --audit 1 --recorder 8 --alerts --refit 4 --profile \
      /tmp/p.json --calibration /tmp/c.json --trace /tmp/t.json

  # modeled nbi-vs-blocking pricing of the decode allreduces at the
  # architecture's published widths (the cost model, not a measurement)
  PYTHONPATH=src python -m repro_torch.launch.serve --overlap-report
"""
from __future__ import annotations

import argparse
import json

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
    single-PE flash attention (K2; the plain causal attention at a head dim
    K2 does not take, such as the demo's 32).  Ends with the modeled
    blocking-vs-overlapped step pricing (``cutover.t_ring_attention``; the
    cost model, not a measurement).

    Widths: the reference's ``B=1, H=4, hd=32``, or with ``full`` the
    architecture's attention widths (qwen3-4b: 32 heads of 128; zamba2-2.7b:
    32 of 80); B=1, f32,
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
    # the single-PE check: K2 where it takes the head dim, else (hd 32, the
    # reference's demo width) the plain causal attention
    if q.device.type == "cpu" or hd in flash_attn.HEAD_DIMS:
        ref, against = flash_attn.flash_attention(q, k, v), "single-PE flash"
    else:
        ref = flash_attn.flash_attention_plain(q, k, v)
        against = "plain causal attention"
    err = float((out - ref.to(out.dtype)).abs().max())
    print(f"[serve] seq-parallel ring attention: npes={npes} S={S} "
          f"(shard {Sh}) max|err| vs {against} = {err:.2e}")
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
            "against": against,
            "device_ops": dev_ops, "shape": tuple(out.shape),
            "finite": bool(torch.isfinite(out).all()),
            "t_blocking": tb, "t_overlap": to, "overlap_ratio": ratio}


def _build_disagg(args, cfg, params):
    """The disaggregated scheduler for ``args`` with its requests submitted
    and nothing run.  The observability flags attach one ``Obs`` bundle to
    the context (``args.obs_run`` keeps it and its output paths);
    ``--cross-pod`` makes the prefill PEs one pod and the decode PEs
    another, so every migration drains through a host proxy."""
    from repro_torch.core import context, teams
    from repro_torch.core.proxy import HostProxy
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.kvpool import KVPool
    from repro_torch.serve.kvxfer import KVMigrator
    from repro_torch.serve.scheduler import DisaggScheduler

    device = params["embed"].device
    npes = args.prefill_pes + args.decode_pes
    node_size = args.prefill_pes if args.cross_pod else npes
    ctx, heap = context.init(npes=npes, node_size=node_size, device=device)
    args.obs_run = make_obs(args)
    if args.obs_run[0] is not None:
        args.obs_run[0].attach(ctx)
    pre, dec = teams.disagg_partition(teams.world(npes), args.prefill_pes)
    max_len = args.prompt_len + args.max_new
    eng = Engine(cfg, params, max_len=max_len, device=device)
    pool = KVPool.create(heap, cfg, max_len, num_blocks=args.kv_blocks,
                         max_slots=args.slots, block_tokens=args.block_tokens)
    proxy = HostProxy(ctx) if args.cross_pod else None
    sched = DisaggScheduler(
        ctx, heap, eng, pool, KVMigrator(ctx, pool, proxy=proxy),
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
    args = parse_args(argv)
    if not args.disagg:
        raise ValueError("build_disagg needs --disagg")
    cfg, params = _model(args)
    return _build_disagg(args, cfg, params), args


def report_disagg(sched, args) -> None:
    """Print the reference's report lines for a finished run, then the
    observability bundle's (:func:`emit_obs`): with ``--trace`` the Chrome
    trace is written, and a trace that does not validate fails."""
    st, ctx, pool = sched.stats, sched.ctx, sched.pool
    outs = {rid: r.out for rid, r in sched.requests.items()}
    mode = "dense-rehydrate" if args.dense_rehydrate else "paged"
    tier = "dcn (host proxy)" if sched.migrator.proxy is not None else "ici"
    print(f"[serve] disagg arch={sched.engine.cfg.name} "
          f"prefill={sched.prefill_pes} decode={sched.decode_pes} "
          f"tier={tier} decode-cache={mode}")
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
    proxy = sched.migrator.proxy
    if proxy is not None:
        print(f"[serve]   cross-pod: {st.bytes_cross_pod} B over the proxy "
              f"ring, {len(proxy.ring.delivered)} messages, "
              f"{proxy.backpressure} backpressure drains")
    for rid in sorted(outs)[:4]:
        print(f"[serve]   req {rid}: {outs[rid]}")
    emit_obs(*args.obs_run)


def _run_disagg(args, cfg, params):
    """Serve ``args.requests`` random prompts disaggregated; prints the
    reference's report lines and returns the finished scheduler."""
    sched = _build_disagg(args, cfg, params)
    sched.run()
    report_disagg(sched, args)
    return sched


def make_obs(args):
    """The observability bundle from the ``ISHMEM_OBS_*`` variables merged
    with the flags (a flag wins).  Returns ``(obs or None, trace path,
    metrics path, profile path, calibration path)``."""
    from repro_torch import obs as obs_mod

    cfg = obs_mod.load_obs_env()
    trace = bool(args.trace) or cfg.trace
    metrics = bool(args.metrics) or cfg.metrics
    refit = args.refit if args.refit is not None else cfg.refit_period
    audit = args.audit if args.audit is not None else cfg.audit_period
    recorder = (args.recorder if args.recorder is not None
                else cfg.recorder_window)
    alerts = bool(args.alerts) or cfg.alerts
    # --profile and --calibration take "1" as the bare flag (the variables'
    # convention); anything else is an output path
    prof_cli_path = args.profile if args.profile not in (None, "1") else None
    cal_cli_path = (args.calibration
                    if args.calibration not in (None, "1") else None)
    calibration = bool(args.calibration) or cfg.calibration
    prof = bool(args.profile) or cfg.prof or calibration
    if not (trace or metrics or refit > 0 or audit > 0 or recorder > 0
            or alerts or prof):
        return None, None, None, None, None
    obs = obs_mod.Obs(
        trace=trace, metrics=metrics, refit_period=refit,
        refit_min_samples=(args.refit_min_samples
                           if args.refit_min_samples is not None
                           else cfg.refit_min_samples),
        trace_limit=cfg.trace_limit, audit_period=audit,
        recorder_window=recorder, recorder_path=cfg.recorder_path,
        alerts=alerts, alert_target=cfg.alert_target,
        alert_windows=cfg.alert_windows, prof=prof, calibration=calibration,
        trace_clock=args.trace_clock or cfg.trace_clock)
    return obs, (args.trace or cfg.trace_path), \
        (args.metrics or cfg.metrics_path), \
        (prof_cli_path or cfg.prof_path), \
        (cal_cli_path or cfg.calibration_path)


def emit_obs(obs, trace_path, metrics_path, prof_path=None,
             calibration_path=None) -> None:
    """Write the bundle's outputs and print the reference's summary lines.
    A written trace (with the profiler's measured track when it sampled)
    that does not validate raises."""
    if obs is None:
        return
    if trace_path:
        from repro_torch.obs.export import validate
        doc = obs.write_trace(trace_path,
                              measured=obs.prof is not None
                              and bool(obs.prof.samples))
        errors = validate(doc)
        if errors:
            raise RuntimeError(f"trace {trace_path} does not validate: "
                               f"{errors[:5]}")
        print(f"[serve]   trace: {len(doc['traceEvents'])} events -> "
              f"{trace_path} (load in ui.perfetto.dev)")
    if metrics_path:
        obs.write_metrics(metrics_path)
        print(f"[serve]   metrics: {len(obs.metrics.series)} step rows -> "
              f"{metrics_path}")
    if obs.refitter is not None and obs.refitter.history:
        n = obs.refitter.decisions_changed()
        print(f"[serve]   online re-fit: {len(obs.refitter.history)} "
              f"re-fit(s), {n} cutover decision(s) changed")
    if obs.auditor is not None:
        a = obs.auditor.summary()
        print(f"[serve]   audit: {a['checks']} sweep(s), "
              f"{a['violations']} violation(s), "
              f"{a['audit_seconds'] * 1e3:.1f} ms auditing")
    if obs.monitor is not None:
        m = obs.monitor.summary()
        print(f"[serve]   slo burn-rate: {m['observations']} checks, "
              f"{len(m['alerts'])} alert(s) "
              f"(target {m['target']}, windows {m['windows']})")
        for al in m["alerts"]:
            worst = al["offenders"][0] if al["offenders"] else None
            tail = (f"; worst rid {worst['rid']} ({worst['outcome']}, "
                    f"+{worst['overshoot_steps']} steps past deadline)"
                    if worst else "")
            print(f"[serve]     ALERT class={al['cls']} step={al['step']} "
                  f"burn={al['burn']}{tail}")
    if obs.recorder is not None:
        r = obs.recorder.summary()
        if r["dumps"]:
            print(f"[serve]   flight recorder: postmortem dump(s) -> "
                  f"{', '.join(r['dumps'])}")
        else:
            print(f"[serve]   flight recorder: armed, "
                  f"{r['buffered_events']} span(s) in the "
                  f"{r['window_steps']}-step window, no incident")
    if obs.prof is not None:
        ps = obs.prof.summary()
        print(f"[serve]   profiler: {ps['samples']} measured sample(s) "
              f"({ps['wall_s'] * 1e3:.1f} ms wall, "
              f"{ps['model_s'] * 1e3:.3f} ms modeled) over "
              f"ops {', '.join(ps['ops']) or 'none'}")
        if prof_path:
            obs.write_prof(prof_path)
            print(f"[serve]   profiler samples -> {prof_path} "
                  f"(analyze with --calibration)")
        if obs.calibration:
            from repro_torch.obs import calibrate as calibrate_mod
            report = obs.calibration_report()
            sink_rows = None
            if obs.prof.ctx is not None:
                sink_rows = calibrate_mod.sink_join(obs.prof.ctx.telemetry)
            for line in calibrate_mod.render(
                    report, sink_rows=sink_rows).splitlines():
                print(f"[serve]   {line}")
            if calibration_path:
                with open(calibration_path, "w") as f:
                    json.dump(report, f, indent=2, sort_keys=True)
                    f.write("\n")
                print(f"[serve]   calibration report -> {calibration_path}")


def _build_fleet(args, cfg, params):
    """``(fleet, specs)``: the fleet for ``args`` and its open-loop arrival
    schedule, nothing run; the observability flags give it an ``Obs``
    bundle (``args.obs_run`` keeps it and its output paths).  Three
    tenants, as the reference's launcher has them: chat (interactive,
    weight 2), api (standard, half its requests samples of one of 2
    shared prompts) and scan (batch, 3x the decode budget where the cache
    allows).  ``--chaos`` takes its plan from the
    flag or from ``ISHMEM_FAULT_PLAN``."""
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.fault import FaultPlan, load_fault_env
    from repro_torch.serve.frontend import Fleet, FleetConfig, TenantSpec, \
        TrafficEngine

    fault_plan = None
    if args.chaos is not None:
        fenv = load_fault_env()
        spec = args.chaos or fenv.plan          # the flag's plan wins
        if not spec:
            raise SystemExit(
                "--chaos needs a fault plan: pass one inline "
                "(--chaos 'kill_pod=pod1@10') or set ISHMEM_FAULT_PLAN")
        fault_plan = FaultPlan.parse(spec, seed=fenv.seed)
    fcfg = FleetConfig(
        arch=args.arch, n_pods=args.pods,
        prefill_per_pod=args.pod_prefill, decode_per_pod=args.pod_decode,
        num_slots=args.slots, kv_blocks=args.kv_blocks,
        block_tokens=args.block_tokens,
        max_len=args.prompt_len + args.max_new, max_new=args.max_new,
        temperature=args.temperature, stream_chunks=args.stream_chunks,
        fused_attn=args.fused_attn, shared_prefix=True,
        admit_delay=args.admit_delay, admission=args.admission,
        queue_bound=args.queue_bound, router=args.router, seed=args.seed)
    engine = Engine(cfg, params, max_len=fcfg.max_len,
                    device=params["embed"].device)
    args.obs_run = make_obs(args)
    fleet = Fleet(fcfg, engine=engine, obs=args.obs_run[0],
                  fault_plan=fault_plan)
    tenants = [
        TenantSpec("chat", weight=2.0, prompt_lens=(args.prompt_len,),
                   max_new=(args.max_new,), slo="interactive"),
        TenantSpec("api", weight=1.0, prompt_lens=(args.prompt_len,),
                   max_new=(args.max_new,), slo="standard",
                   shared_prefix_prob=0.5, prefix_groups=2),
        TenantSpec("scan", weight=1.0, prompt_lens=(args.prompt_len,),
                   max_new=(min(3 * args.max_new, fcfg.max_len
                                - args.prompt_len),), slo="batch"),
    ]
    traffic = TrafficEngine(tenants, rate=args.rate, vocab=cfg.vocab_size,
                            seed=args.seed, process=args.traffic)
    return fleet, traffic.schedule(args.fleet_steps)


def build_fleet(argv=None):
    """Parse ``argv`` (with ``--fleet``), build the model and return
    ``(fleet, specs, args)``: the fleet unrun and its arrival schedule, for
    a caller that drives ``fleet.run(specs)`` (or steps it) itself and then
    calls :func:`report_fleet`."""
    args = parse_args(argv)
    if not args.fleet:
        raise ValueError("build_fleet needs --fleet")
    cfg, params = _model(args)
    fleet, specs = _build_fleet(args, cfg, params)
    return fleet, specs, args


def report_fleet(fleet, specs, rep, args) -> None:
    """Print the reference's report lines for a finished fleet run (the
    ``*_model_s`` latencies are the modeled comm clock, not measured),
    then the observability bundle's (:func:`emit_obs`)."""
    from collections import Counter
    fcfg = fleet.fcfg
    by_slo = dict(Counter(s.slo for s in specs))
    print(f"[serve] fleet arch={fleet.cfg.name} pods={fcfg.n_pods} "
          f"({fcfg.prefill_per_pod}P+{fcfg.decode_per_pod}D x "
          f"{fcfg.num_slots} slots) router={fcfg.router} "
          f"admission={fcfg.admission}")
    print(f"[serve]   offered: {len(specs)} requests over "
          f"{args.fleet_steps} steps ({args.traffic}, rate {args.rate}) "
          f"by class {by_slo}")
    lat = rep["latency"]
    print(f"[serve]   {rep['completed']}/{rep['offered']} completed, "
          f"{rep['shed']} shed, {rep['preempts']} preempted "
          f"({rep['resumes']} resumed) in {fleet.elapsed_steps} steps")
    print(f"[serve]   TTFD p50/p99 {lat['ttfd_p50_steps']:.1f}/"
          f"{lat['ttfd_p99_steps']:.1f} steps "
          f"({lat['ttfd_p50_model_s'] * 1e6:.1f}/"
          f"{lat['ttfd_p99_model_s'] * 1e6:.1f} us modeled); e2e p99 "
          f"{lat['e2e_p99_steps']:.1f} steps; goodput "
          f"{rep['goodput']:.2f} ({rep.get('goodput_per_step', 0.0):.3f}"
          f"/step)")
    for name, b in sorted(rep["by_class"].items()):
        print(f"[serve]     {name:12s} {b['completed']}/{b['offered']} "
              f"done, p99 TTFD {b['ttfd_p99_steps']:.1f} steps, "
              f"goodput {b['goodput']:.2f}")
    wire = rep["wire"]
    print(f"[serve]   wire: {wire['bytes_migrated']} B migrated, "
          f"{wire['bytes_cross_pod']} B cross-pod, "
          f"{wire['bytes_wire_saved']} B saved by residency; router "
          f"{rep['router']}")
    if "proxy" in rep:
        print(f"[serve]   proxy ring: {rep['proxy']['delivered']} messages, "
              f"{rep['proxy']['backpressure']} backpressure drains")
    if fleet.injector is not None:
        flt = rep.get("fault", {})
        rec = rep["recovered"]
        fired = ", ".join(f"{e['kind']}={e['arg']}@{e['step']}"
                          for e in flt.get("events", ())) or "none fired"
        print(f"[serve]   chaos: plan [{fleet.injector.plan.spec()}] -> "
              f"{fired}")
        print(f"[serve]   chaos: dead PEs {flt.get('dead_pes', [])}, dead "
              f"pods {flt.get('dead_pods', [])}, "
              f"{flt.get('cancelled_ops', 0)} in-flight ops cancelled")
        print(f"[serve]   recovery: {rec['recovered_requests']} requests "
              f"re-admitted ({rec['remigrated']} re-migrated, "
              f"{rec['recomputed']} recomputed from prompt, "
              f"{rec['replayed_tokens']} tokens replayed)")
    emit_obs(*args.obs_run)


def _run_fleet(args, cfg, params):
    """Play the fleet's arrival schedule, drain, print the report; returns
    the finished fleet (its report under ``fleet.last_report``)."""
    fleet, specs = _build_fleet(args, cfg, params)
    rep = fleet.run(specs)
    fleet.last_report = rep
    report_fleet(fleet, specs, rep, args)
    return fleet


def build_parser() -> argparse.ArgumentParser:
    """The launcher's flags; the fleet's defaults come from the
    ``ISHMEM_FLEET_*`` variables.  A malformed one fails only a ``--fleet``
    run (:func:`parse_args`)."""
    from repro_torch.obs import env as obs_env
    from repro_torch.serve.frontend.env import FleetEnv, load_fleet_env
    try:
        fenv, fenv_err = load_fleet_env(), None
    except ValueError as e:
        fenv, fenv_err = FleetEnv(), e
    ap = argparse.ArgumentParser()
    ap.set_defaults(fleet_env_error=fenv_err, fleet_env=fenv)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--full", action="store_true",
                    help="serve the architecture at its published widths "
                         "(default: the reduced test variant)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--seed", type=int, default=None,
                    help="weights, prompts and the fleet's traffic and "
                         "router (default 0; ISHMEM_FLEET_SEED for --fleet)")
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
    ap.add_argument("--stream-chunks", type=int, default=None,
                    metavar="BLOCKS",
                    help="chunked prefill streaming: put BLOCKS filled "
                         "blocks on the wire per scheduler step mid-prefill "
                         "(0 = whole-prefill migration; --fleet defaults to "
                         "ISHMEM_FLEET_STREAM_CHUNKS)")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="serve every request as a sample of one shared "
                         "prompt: prefix blocks are mapped (incref), not "
                         "re-staged, with copy-on-write on divergence")
    ap.add_argument("--dense-rehydrate", action="store_true",
                    help="dense-cache admission (gather + insert) instead "
                         "of paged decode attention: the A/B control")
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
    ap.add_argument("--cross-pod", action="store_true",
                    help="decode PEs in a second pod: dcn tier, migrations "
                         "drain through the host proxy ring")
    ap.add_argument("--fleet", action="store_true",
                    help="cluster frontend: open-loop traffic over N pods "
                         "with SLO admission and routing; defaults come "
                         "from the ISHMEM_FLEET_* variables")
    ap.add_argument("--pods", type=int, default=fenv.pods)
    ap.add_argument("--pod-prefill", type=int, default=1,
                    help="prefill PEs per pod")
    ap.add_argument("--pod-decode", type=int, default=2,
                    help="decode PEs per pod")
    ap.add_argument("--fleet-steps", type=int, default=24,
                    help="open-loop arrival window in scheduler steps "
                         "(the run drains past it)")
    ap.add_argument("--rate", type=float, default=0.8,
                    help="offered load, requests per step fleet-wide")
    ap.add_argument("--traffic", choices=("poisson", "bursty"),
                    default="poisson", help="arrival process")
    ap.add_argument("--router", choices=("random", "round_robin",
                                         "least_loaded", "affinity"),
                    default=fenv.router)
    ap.add_argument("--admission", choices=("slo", "fcfs"),
                    default=fenv.admission,
                    help="SLO deadline-class policy vs the FCFS baseline")
    ap.add_argument("--queue-bound", type=int, default=fenv.queue_bound,
                    help="per-pod queue bound before the SLO policy sheds")
    ap.add_argument("--chaos", nargs="?", const="", default=None,
                    metavar="PLAN",
                    help="fault injection against the fleet: a "
                         "deterministic kind=arg@step plan (kill_pe, "
                         "kill_pod, partition, drain, join), e.g. "
                         "'kill_pod=pod1@10,partition=3@14'; with no "
                         "inline plan, ISHMEM_FAULT_PLAN is used")
    # observability (repro_torch.obs; defaults from ISHMEM_OBS_*)
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record causal spans and write a Chrome trace "
                         "(fails if it does not validate)")
    ap.add_argument("--trace-clock", choices=obs_env.TRACE_CLOCKS,
                    default=None,
                    help="the trace's clock: 'step' (the default: scheduler "
                         "steps, so traces diff across runs) or 'wall' "
                         "(Unix microseconds, the torch profiler's clock, "
                         "with the decode step's parts and staging as "
                         "spans of their own)")
    ap.add_argument("--metrics", metavar="OUT.json", default=None,
                    help="per-fleet-step metrics time series (heap "
                         "fragmentation, ring occupancy, pool residency, "
                         "per-class goodput)")
    ap.add_argument("--refit", type=int, default=None, metavar="STEPS",
                    help="online tuner re-fit period in fleet steps: re-run "
                         "the estimator over live telemetry and hot-swap "
                         "the cutover table mid-run (0 = off)")
    ap.add_argument("--refit-min-samples", type=int, default=None,
                    help="minimum retained telemetry samples before a due "
                         "re-fit runs")
    ap.add_argument("--audit", type=int, default=None, metavar="STEPS",
                    help="run the invariant auditors (heap extents, block "
                         "refcounts, signal ledger, prefix residency, slot "
                         "banks) every STEPS fleet steps; a violation "
                         "aborts the run with an AuditError (0 = off)")
    ap.add_argument("--recorder", type=int, default=None, metavar="STEPS",
                    help="arm the flight recorder: keep the last STEPS "
                         "steps of spans and dump a postmortem Chrome trace "
                         "on a crash, an audit violation, a fault or an "
                         "SLO alert (0 = off)")
    ap.add_argument("--alerts", action="store_true",
                    help="SLO burn-rate monitor: multi-window error-budget "
                         "burn per deadline class over the metrics series "
                         "(implies metrics sampling)")
    ap.add_argument("--profile", nargs="?", const="1", default=None,
                    metavar="OUT.json",
                    help="wall-clock profiler on the serving hot paths "
                         "(decode steps, paged attention, prefill, stream "
                         "flushes); an argument also writes the measured "
                         "samples for 'python -m repro_torch.obs.analyze "
                         "--calibration'.  Deterministic outputs stay "
                         "bitwise")
    ap.add_argument("--calibration", nargs="?", const="1", default=None,
                    metavar="OUT.json",
                    help="measured-vs-modeled report at shutdown (ratio "
                         "percentiles per (op, tier, size, work-items) "
                         "bucket, worst buckets, unmodeled coverage); "
                         "implies --profile; an argument also writes the "
                         "report")
    return ap


def parse_args(argv=None):
    """Parse ``argv`` as the reference's launcher does: ``--seed`` defaults
    to ``ISHMEM_FLEET_SEED`` for a fleet, and ``--stream-chunks`` to
    ``ISHMEM_FLEET_STREAM_CHUNKS`` for a fleet without ``--fused-attn``
    (the two exclude each other), else 0."""
    args = build_parser().parse_args(argv)
    if args.fleet and args.fleet_env_error is not None:
        raise args.fleet_env_error
    if args.seed is None:
        args.seed = args.fleet_env.seed if args.fleet else 0
    if args.stream_chunks is None:
        args.stream_chunks = (args.fleet_env.stream_chunks
                              if args.fleet and not args.fused_attn else 0)
    return args


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
    """Run the launcher; returns the finished fleet (``--fleet``), the
    finished scheduler (``--disagg``) or the generated ids (lockstep)."""
    args = parse_args(argv)
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg, params = _model(args)
    device = params["embed"].device
    if args.fleet:
        out = _run_fleet(args, cfg, params)
    elif args.disagg:
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
