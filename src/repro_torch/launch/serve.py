"""Serving launcher: lockstep batched generation, and disaggregated
prefill/decode with SHMEM paged-KV migration and paged decode attention.

Counterpart of ``repro/launch/serve.py`` (its lockstep mode,
``_run_disagg`` and ``--overlap-report``).  Runs on the current CUDA device
unless ``--device`` says otherwise; ``--full`` serves the architecture at
its published widths instead of the reduced test variant.

  # lockstep batch
  PYTHONPATH=src python -m repro_torch.launch.serve --batch 4

  # disaggregated: 2 prefill PEs migrate paged KV to 2 decode PEs, decode
  # reads K/V straight from the pool
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg \\
      --prefill-pes 2 --decode-pes 2 --requests 8 --slots 3

  # full-width qwen3-4b on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg --full \\
      --prompt-len 512 --kv-blocks 256

  # modeled nbi-vs-blocking pricing of the decode allreduces at the
  # architecture's published widths (the cost model, not a measurement)
  PYTHONPATH=src python -m repro_torch.launch.serve --overlap-report
"""
from __future__ import annotations

import argparse

import torch


def make_batch(cfg, gen: torch.Generator, batch: int, prompt_len: int,
               device) -> dict:
    """Random request batch drawn from ``gen`` (token models only)."""
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=gen.device)
    return {"tokens": tokens.to(device)}


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


def _run_disagg(args, cfg, params):
    """Serve ``args.requests`` random prompts disaggregated; prints the
    reference's report lines and returns the finished scheduler."""
    from repro_torch.core import context, teams
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.kvpool import KVPool
    from repro_torch.serve.kvxfer import KVMigrator
    from repro_torch.serve.scheduler import DisaggScheduler

    device = params["embed"].device
    npes = args.prefill_pes + args.decode_pes
    ctx, heap = context.init(npes=npes, node_size=npes, device=device)
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
        admit_delay_steps=args.admit_delay)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    for _ in range(args.requests):
        sched.submit(make_batch(cfg, gen, 1, args.prompt_len, device))
    outs = sched.run()
    st = sched.stats
    print(f"[serve] disagg arch={cfg.name} prefill={pre.pes()} "
          f"decode={dec.pes()} tier=ici decode-cache=paged")
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
        print(f"[serve]   time-to-first-resident-block: {avg_fb:.1f} sched "
              f"steps (observed)")
    print(f"[serve]   stalls: pool={st.stalled_on_pool} "
          f"slots={st.stalled_on_slots}; coalescing ratio "
          f"{ctx.pending.stats.coalescing_ratio():.2f}")
    ps = pool.stats(sched.heap)
    print(f"[serve]   pool: {ps['blocks_in_use']}/{ps['blocks_total']} "
          f"blocks in use; heap: {ps['heap']['bytes_in_use']} B in use, "
          f"{ps['heap']['bytes_free']} B free")
    for rid in sorted(outs)[:4]:
        print(f"[serve]   req {rid}: {outs[rid].tolist()}")
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
                         "migration's signal is polled")
    return ap


def main(argv=None):
    """Run the launcher; returns the finished scheduler (``--disagg``) or
    the generated ids (lockstep)."""
    args = build_parser().parse_args(argv)
    from repro_torch import _devices
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import model
    from repro_torch.serve.engine import Engine, ServeConfig

    device = _devices.resolve(args.device)
    cfg = cfgbase.get_config(args.arch)
    if not args.full:
        cfg = cfgbase.reduced(cfg)
    params = model.init_params(cfg, seed=args.seed, device=device)
    if args.disagg:
        sched = _run_disagg(args, cfg, params)
        if args.overlap_report:
            _overlap_report(args)
        return sched
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
    return out


if __name__ == "__main__":
    main()
