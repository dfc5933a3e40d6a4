"""End-to-end serving on the PyTorch port, in the three acts of
``examples/serve_batch.py``:

1. lockstep batched generation across architecture families (prefill +
   decode with KV/recurrent caches) for reduced qwen3-4b, zamba2-2.7b
   and whisper-medium;
2. continuous batching on the slot engine: 7 requests through 2 decode
   slots of a ``DisaggScheduler``, decode reading K/V straight from the
   symmetric-heap block pool (paged attention);
3. streaming admission (one block a step on the wire mid-prefill) with
   shared-prefix block reuse across 6 samples of one prompt
   (copy-on-write on divergence).

The sizes, block tokens, slots and temperatures are the JAX script's.
Weights and prompts are drawn from seeded ``torch.Generator``s on the CPU
and moved to the device, so a CPU run and a card run serve the same
numbers (the JAX script draws from ``jax.random``; sampled tokens differ
across packages, ``serve/engine.py``).  ``--temperature`` overrides the
three acts' temperatures (0 serves greedy).

Run:  PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
(the current CUDA device unless ``--device`` says otherwise: every heap
store is a K1 launch, prefill attention K2, the paged gather K3)
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import _devices
from repro_torch.configs import base as cfgbase
from repro_torch.core import context, teams
from repro_torch.models import model
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.kvxfer import KVMigrator
from repro_torch.serve.scheduler import DisaggScheduler
from repro_torch.train import tree

ACT1_ARCHS = ("qwen3-4b", "zamba2-2.7b", "whisper-medium")
S1, NEW1, B1 = 24, 12, 4
S, NEW, NPES = 16, 8, 4


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _params(cfg, dev):
    """The weights of ``init_params(seed=0)`` drawn on the CPU, on ``dev``."""
    return tree.map_leaves(lambda t: t.to(dev),
                           model.init_params(cfg, seed=0, device="cpu"))


def _tokens(gen, shape, vocab):
    return torch.randint(0, vocab, shape, generator=gen, dtype=torch.int32)


def _stats(sched):
    return dataclasses.asdict(sched.stats)


def main(argv=None) -> dict:
    """Runs the three acts; returns what they printed, by act, with the
    prompts they served."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the current CUDA device")
    ap.add_argument("--temperature", type=float, default=None,
                    help="override every act's temperature (0: greedy)")
    args = ap.parse_args(argv)
    dev = _devices.resolve(args.device)
    temp = {act: t if args.temperature is None else args.temperature
            for act, t in (("act1", 0.8), ("act2", 0.0), ("act3", 0.8))}
    out = {"temperature": temp}

    # --- act 1: lockstep batches across families
    out["act1"] = {}
    for arch in ACT1_ARCHS:
        cfg = cfgbase.reduced(cfgbase.get_config(arch))
        eng = Engine(cfg, _params(cfg, dev), max_len=S1 + NEW1, device=dev)
        batch = {"tokens": _tokens(_gen(1), (B1, S1), cfg.vocab_size)}
        if cfg.family == "audio":
            batch["audio_embeds"] = 0.1 * torch.randn(
                (B1, cfg.encoder_seq, cfg.d_model), generator=_gen(2))
        t0 = time.time()
        toks = eng.generate({k: v.to(dev) for k, v in batch.items()},
                            ServeConfig(max_new_tokens=NEW1,
                                        temperature=temp["act1"]))
        toks = toks.cpu().numpy()
        dt = time.time() - t0
        print(f"[serve] {arch:16s} batch={B1} prompt={S1} new={NEW1} "
              f"({dt:.2f}s, {B1 * NEW1 / dt:.1f} tok/s)  sample: "
              f"{toks[0][:8]}")
        out["act1"][arch] = {"generated": toks, "wall_s": dt, "batch": {
            k: v.numpy() for k, v in batch.items()}}

    # --- act 2: continuous batching with slot rotation
    # 7 requests through 2 decode slots: the scheduler prefills, migrates
    # the paged KV over the symmetric heap, admits on the block signal, and
    # rotates finished requests out mid-flight.
    cfg = cfgbase.reduced(cfgbase.get_config("qwen3-4b"))
    params = _params(cfg, dev)
    ctx, heap = context.init(npes=NPES, node_size=NPES, device=dev)
    pre, dec = teams.disagg_partition(teams.world(NPES), 2)
    eng = Engine(cfg, params, max_len=S + NEW, device=dev)
    pool = KVPool.create(heap, cfg, S + NEW, num_blocks=24, max_slots=2,
                         block_tokens=8)
    sched = DisaggScheduler(
        ctx, heap, eng, pool, KVMigrator(ctx, pool),
        prefill_pes=pre.pes(), decode_pes=dec.pes(), num_slots=2,
        scfg=ServeConfig(max_new_tokens=NEW, temperature=temp["act2"]),
        admit_delay_steps=1)
    prompts = [_tokens(_gen(3 * 1000 + i), (1, S), cfg.vocab_size)
               for i in range(7)]
    for p in prompts:
        sched.submit({"tokens": p.to(dev)})
    t0 = time.time()
    outs = sched.run()
    dt = time.time() - t0
    st = sched.stats
    print(f"[serve] continuous batching: {len(outs)} reqs through "
          f"{len(dec.pes())}x2 slots in {st.decode_steps} decode steps "
          f"({dt:.2f}s); {st.migrations} migrations "
          f"{st.bytes_migrated // 1024} KiB, coalescing "
          f"{ctx.pending.stats.coalescing_ratio():.2f}, "
          f"ttfd {sum(st.ttfd_steps) / len(st.ttfd_steps):.1f} steps")
    for rid in sorted(outs)[:3]:
        print(f"[serve]   req {rid}: {outs[rid].tolist()}")
    out["act2"] = {"outs": {rid: np.asarray(o) for rid, o in outs.items()},
                   "stats": _stats(sched), "wall_s": dt,
                   "coalescing": ctx.pending.stats.coalescing_ratio(),
                   "prompts": [p.numpy() for p in prompts]}

    # --- act 3: streaming admission + shared prefixes
    # 6 samples of ONE prompt: prefix blocks are mapped, not restaged (one
    # wire copy per decode PE), prefill streams 1 block per step
    # mid-prefill, and the first divergent decode write copy-on-writes the
    # shared boundary block.
    ctx, heap = context.init(npes=NPES, node_size=NPES, device=dev)
    pool = KVPool.create(heap, cfg, S + NEW, num_blocks=24, max_slots=2,
                         block_tokens=4)
    sched = DisaggScheduler(
        ctx, heap, eng, pool, KVMigrator(ctx, pool),
        prefill_pes=pre.pes(), decode_pes=dec.pes(), num_slots=2,
        scfg=ServeConfig(max_new_tokens=NEW, temperature=temp["act3"],
                         seed=4),
        admit_delay_steps=1, stream_chunks=1, shared_prefix=True)
    prompt = _tokens(_gen(5), (1, S - 2), cfg.vocab_size)
    for _ in range(6):
        sched.submit({"tokens": prompt.to(dev)}, prefix_len=S - 2)
    outs = sched.run()
    st = sched.stats
    print(f"[serve] streaming admission: {st.stream_chunks} wire "
          f"installments, window "
          f"{sum(st.ttfd_model_s) / len(st.ttfd_model_s) * 1e6:.1f} us; "
          f"shared prefix: {st.prefix_hits} hits / "
          f"{st.blocks_prefix_shared} blocks mapped / "
          f"{st.bytes_wire_saved // 1024} KiB wire saved / "
          f"{st.cow_copies} copy-on-writes")
    for rid in sorted(outs)[:3]:
        print(f"[serve]   sample {rid}: {outs[rid].tolist()}")
    out["act3"] = {"outs": {rid: np.asarray(o) for rid, o in outs.items()},
                   "stats": _stats(sched), "prompt": prompt.numpy()}
    return out


if __name__ == "__main__":
    main()
