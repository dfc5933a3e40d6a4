"""Training loop (counterpart of ``repro/train/trainer.py``): data -> step
-> metrics/checkpoints, resumable.

``comms_backend="shmem"`` prices and logs the modeled gradient-reduce
schedule as the reference does, and trains through
``train_step.make_dp_step``: the global batch splits over ``comms_npes``
simulated PEs whose gradients reduce through the port's ``ShmemOps`` (the
ring kernels K4-K6 on the card).  ``device`` defaults to the card.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch import _devices
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import optimizer as opt_mod, train_step as ts_mod


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0            # 0 = disabled
    ckpt_dir: str = "checkpoints"
    seq_len: int = 128
    global_batch: int = 8
    grad_accum: int = 1
    seed: int = 0
    lr: float = 3e-4
    comms_backend: str = "none"    # "shmem": data-parallel over comms_npes
                                   # simulated PEs, gradients reduced by the
                                   # ring kernels; logs the modeled schedule
    comms_npes: int = 8
    device: str | None = None      # None: the current CUDA device


def train(cfg_arch, tcfg: TrainConfig, *, resume: bool = False,
          log_fn=print, state=None):
    """Single-host training loop.  ``state`` = (params, opt_state) to
    start from (e.g. the reference's, through ``_bridge``); by default
    ``init_state`` with ``tcfg.seed``.  Returns (params, opt_state,
    history)."""
    dev = _devices.resolve(tcfg.device)
    opt_cfg = opt_mod.OptConfig(name=cfg_arch.optimizer, lr=tcfg.lr,
                                warmup_steps=max(1, tcfg.steps // 20),
                                total_steps=tcfg.steps)
    if state is None:
        state = ts_mod.init_state(cfg_arch, seed=tcfg.seed, device=dev)
    params, opt_state = state
    stream = TokenStream(DataConfig(cfg_arch.vocab_size, tcfg.seq_len,
                                    tcfg.global_batch, seed=tcfg.seed),
                         device=dev)
    overlap = None
    if tcfg.comms_backend == "shmem":
        # completion-engine view of the step tail: per-leaf grad reduce
        # (nbi ring steps) pipelined under optimizer updates.  The schedule
        # depends only on leaf shapes, so it is priced once up front.
        from repro_torch.comms import api as comms_api
        ops = comms_api.get_ops("shmem", npes=tcfg.comms_npes)
        t_block, t_nbi, nleaves = ts_mod.grad_reduce_schedule(params, ops)
        overlap = {"t_reduce_blocking_s": t_block, "t_reduce_nbi_s": t_nbi,
                   "overlap_eff": t_block / t_nbi if t_nbi else 1.0,
                   "leaves": nleaves}
        log_fn(f"grad-reduce overlap: {nleaves} leaves, modeled "
               f"{t_block * 1e6:.1f}us blocking -> {t_nbi * 1e6:.1f}us nbi "
               f"(x{overlap['overlap_eff']:.2f})")
        step_fn = ts_mod.make_dp_step(cfg_arch, opt_cfg, ops,
                                      grad_accum=tcfg.grad_accum)
    elif tcfg.comms_backend == "none":
        step_fn = ts_mod.make_train_step(cfg_arch, opt_cfg,
                                         grad_accum=tcfg.grad_accum)
    else:
        raise ValueError(f"unknown comms backend {tcfg.comms_backend!r}")

    start = 0
    if resume:
        last = ckpt_mod.latest_step(tcfg.ckpt_dir)
        if last is not None:
            (params, opt_state), meta = ckpt_mod.restore(
                tcfg.ckpt_dir, last, (params, opt_state))
            start = meta["step"]
            log_fn(f"resumed from step {start}")

    history = []
    t0 = time.time()
    for step in range(start, tcfg.steps):
        batch = stream.batch(step)
        batch.update(stream.frontend(step, cfg_arch, tcfg.global_batch))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = round(time.time() - t0, 2)
            if overlap is not None:
                m["overlap_eff"] = round(overlap["overlap_eff"], 3)
            history.append(m)
            log_fn(f"step {step:5d} loss {m['loss']:.4f} "
                   f"lr {m['lr']:.2e} gnorm {m['grad_norm']:.2f}")
        if tcfg.ckpt_every and (step + 1) % tcfg.ckpt_every == 0:
            ckpt_mod.save(tcfg.ckpt_dir, step + 1, (params, opt_state))
    return params, opt_state, history
