"""End-to-end training on the PyTorch port: the dense LM of
``examples/train_lm.py`` (data pipeline -> model -> AdamW ->
checkpointing), resumable, with the JAX script's ``make_cfg`` and flags.

The default invocation is small; pass --d-model 640 --layers 10
--vocab 50304 --steps 300 for the ~100M-parameter run.  Checkpoints are
written only with --ckpt-every, under checkpoints/train_lm.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 40
      [--device cpu]
(the current CUDA device unless ``--device`` says otherwise)
"""
import argparse
import dataclasses

from repro_torch.configs import base as cfgbase
from repro_torch.train import trainer


def make_cfg(d_model, layers, vocab):
    base = cfgbase.get_config("qwen3-4b")     # dense GQA family
    heads = max(4, d_model // 128)
    return dataclasses.replace(
        base, num_layers=layers, d_model=d_model, num_heads=heads,
        num_kv_heads=max(1, heads // 4), head_dim=d_model // heads,
        d_ff=4 * d_model, vocab_size=vocab, qk_norm=True,
        dtype="float32", param_dtype="float32", remat=False)


def main(argv=None, *, state=None, log_fn=print) -> dict:
    """Trains; returns what it printed and the loss history.  ``state`` =
    (params, opt_state) to start from, as ``trainer.train`` takes it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default the current CUDA device")
    args = ap.parse_args(argv)

    cfg = make_cfg(args.d_model, args.layers, args.vocab)
    n = cfg.param_count()
    print(f"[train_lm] {cfg.name}-derived dense LM: {n/1e6:.1f}M params, "
          f"{args.steps} steps @ seq {args.seq_len} batch {args.batch}")
    tcfg = trainer.TrainConfig(
        steps=args.steps, seq_len=args.seq_len, global_batch=args.batch,
        log_every=max(1, args.steps // 20), ckpt_every=args.ckpt_every,
        ckpt_dir="checkpoints/train_lm", device=args.device)
    _, _, history = trainer.train(cfg, tcfg, resume=args.resume,
                                  log_fn=log_fn, state=state)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"[train_lm] loss {first:.4f} -> {last:.4f} "
          f"({'DECREASED' if last < first else 'did not decrease'})")
    return {"params": n, "history": history, "first": first, "last": last,
            "decreased": last < first}


if __name__ == "__main__":
    main()
