"""Training launcher (counterpart of ``repro/launch/train.py``).

Runs the training loop on a reduced config by default, or on the
published one with ``--full-size`` (cut to ``--layers`` layers, as
``launch/serve.py`` cuts a model that does not fit).  It runs on the card
unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2 \\
      --comms-backend shmem
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None, *, log_fn=print):
    """Returns (params, opt_state, history)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full-size", action="store_true",
                    help="use the published architecture; default reduced")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--comms-backend", default="none",
                    choices=["none", "shmem"],
                    help="shmem: data-parallel over --comms-npes simulated "
                         "PEs, gradients reduced by the ring kernels")
    ap.add_argument("--comms-npes", type=int, default=8)
    ap.add_argument("--no-overlap-reduce", action="store_true",
                    help="disable the reduce/update pipeline "
                         "(PerfPolicy.overlap_grad_reduce=False)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the current CUDA device")
    args = ap.parse_args(argv)
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import policy as policy_mod
    from repro_torch.train import trainer

    cfg = cfgbase.get_config(args.arch)
    if not args.full_size:
        cfg = cfgbase.reduced(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    tcfg = trainer.TrainConfig(
        steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, grad_accum=args.grad_accum,
        lr=args.lr, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        comms_backend=args.comms_backend,
        comms_npes=args.comms_npes, device=args.device)
    pol = dataclasses.replace(policy_mod.get(),
                              overlap_grad_reduce=not args.no_overlap_reduce)
    with policy_mod.use(pol):
        return trainer.train(cfg, tcfg, resume=args.resume, log_fn=log_fn)


if __name__ == "__main__":
    main()
