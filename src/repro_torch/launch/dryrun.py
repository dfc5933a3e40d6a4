"""Dry run: every (architecture x input shape x mesh) step run on ``meta``
tensors, with no allocation, its work counted and each device's share of
its memory sized (counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each step for a 256- or 512-chip mesh
and parses the HLO.  The port runs the same step function on meta
stand-ins under ``roofline.counter.count()`` (each kernel wrapper takes
its meta route and charges its formula), inside the sharding rules'
``shardctx`` and the policy.  Per record:

- ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes`` per
  device from the shard shapes (``launch/sharding.py``), and
  ``temp_size_in_bytes``, the counter's peak of live bytes, on the card
  mesh only (null on the production meshes: the port has no per-device
  program to size there);
- ``counted``: the global counts (``roofline/counter.py``), and
  ``counted_per_device``, an even split of them over the mesh's chips,
  labelled so; their ``bytes`` are the eager implementation's traffic
  (``counted_bytes_are`` says so), not the step's floor, which
  ``roofline/analysis.py`` takes from ``memory``;
- ``model_flops``, ``params_total``, ``params_active``, and ``fits``
  (argument + temp within one H100's 80 GB, card mesh only).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multipod both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k --mesh card

Records go to ``experiments/dryrun_torch`` unless ``--out`` says
otherwise, one ``{arch}.{shape}.{mesh}{tag}.json`` each.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import _devices
from repro_torch.configs import base as cfgbase
from repro_torch.launch import mesh as mesh_mod, policy as policy_mod, \
    sharding, shardctx
from repro_torch.models import kvcache, model
from repro_torch.roofline import counter
from repro_torch.train import optimizer as opt_mod, train_step as ts_mod, \
    tree as tree_mod

CARD_BYTES = 80 * 10**9              # one H100's HBM, as the fit test reads
MESHES = {"card": mesh_mod.card_mesh,
          "pod1": lambda: mesh_mod.make_production_mesh(multi_pod=False),
          "pod2": lambda: mesh_mod.make_production_mesh(multi_pod=True)}
DEFAULT_OUT = "experiments/dryrun_torch"


def _inputs(cfg, shape, device, seed):
    """The step's inputs on ``device``: meta stand-ins, or real tensors
    (tokens drawn from ``seed``, frontend embeddings normal, caches zero)."""
    if device.type == "meta":
        return cfgbase.input_specs(cfg, shape)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, spec in cfgbase.input_specs(cfg, shape).items():
        if name == "cache":
            out[name] = kvcache.init_cache(cfg, shape.global_batch,
                                           shape.seq_len, device)
        elif name == "pos":
            out[name] = torch.full(spec.shape, shape.seq_len - 1,
                                   dtype=spec.dtype, device=device)
        elif spec.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=gen, device=device,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(spec.shape, generator=gen,
                                    device=device).to(spec.dtype)
    return out


def build_step(cfg, shape, mesh=None, *, device=None, comms_npes: int = 1,
               seed: int = 0):
    """``(fn, args)``: the step of ``shape.kind`` and its arguments on
    ``device`` (the current CUDA device unless given; ``"meta"`` gives the
    dry-run's stand-ins, elsewhere the tensors are real, the weights from
    ``init_params(seed=seed)``).  Train is the reference's step, or with
    ``comms_npes`` > 1 the data-parallel step whose gradients reduce
    through ``ShmemOps`` over that many simulated PEs.  ``mesh`` is taken
    for the reference's signature; the port partitions nothing."""
    del mesh
    dev = _devices.resolve(device)
    params = model.init_params(cfg, seed=seed, device=dev)
    inputs = _inputs(cfg, shape, dev, seed)
    if shape.kind == "train":
        opt_cfg = opt_mod.OptConfig(name=cfg.optimizer)
        if comms_npes > 1:
            from repro_torch.comms import api
            step = ts_mod.make_dp_step(cfg, opt_cfg,
                                       api.get_ops("shmem", npes=comms_npes))
        else:
            step = ts_mod.make_train_step(cfg, opt_cfg)
        return step, (params, opt_mod.init(cfg.optimizer, params), inputs)
    if shape.kind == "prefill":
        cache = cfgbase.cache_specs(cfg, shape.global_batch, shape.seq_len) \
            if dev.type == "meta" else \
            kvcache.init_cache(cfg, shape.global_batch, shape.seq_len, dev)

        def prefill(params, batch, cache):
            return model.prefill(params, cfg, batch, cache)
        return prefill, (params, inputs, cache)

    def decode(params, token, pos, cache):
        return model.decode_step(params, cfg, token, pos, cache)
    return decode, (params, inputs["token"], inputs["pos"], inputs["cache"])


def arg_shardings(cfg, shape, mesh, args) -> tuple:
    """The specs of ``build_step``'s arguments, tree for tree."""
    p_sh = sharding.param_shardings(cfg, mesh, args[0])
    if shape.kind == "train":
        return (p_sh, sharding.opt_shardings(cfg, mesh, args[1]),
                sharding.batch_shardings(cfg, mesh, args[2]))
    if shape.kind == "prefill":
        return (p_sh, sharding.batch_shardings(cfg, mesh, args[1]),
                sharding.cache_shardings(cfg, mesh, args[2]))
    return (p_sh, sharding.batch_shardings(cfg, mesh, args[1]),
            sharding.batch_shardings(cfg, mesh, args[2]),
            sharding.cache_shardings(cfg, mesh, args[3]))


def _replicated(tree):
    return tree_mod.map_leaves(lambda l: sharding.P(*([None] * l.dim())),
                               tree)


def out_shardings(cfg, shape, mesh, out, arg_specs) -> tuple:
    """The reference's ``out_shardings``: train gives (params, opt state)
    their argument layouts and the metrics none; prefill and decode the
    cache its layout and the logits none (replicated here)."""
    if shape.kind == "train":
        return (arg_specs[0], arg_specs[1], _replicated(out[2]))
    return (_replicated(out[0]), sharding.cache_shardings(cfg, mesh, out[1]))


def model_flops(cfg, shape):
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch   # decode: 1 token per seq


def count_step(fn, args):
    """(outputs, the counter's summary) of ``fn(*args)`` under
    ``counter.count()``, with no autograd graph beyond what the step makes
    itself."""
    with torch.no_grad(), counter.count() as counts:
        out = fn(*args)
    return out, counts.summary()


def _write(rec, out_dir, tag):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{rec['arch']}.{rec['shape']}.{rec['mesh']}{tag}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=2, default=str)


def run_one(arch: str, shape, mesh: str = "card", out_dir: str = None,
            policy: "policy_mod.PerfPolicy" = None, tag: str = "", *,
            cfg=None, comms_npes: int = 1, memo: dict = None) -> dict:
    """One record.  ``shape`` is a name in ``SHAPES`` or a ``ShapeSpec``;
    ``cfg`` overrides the registered configuration of ``arch`` (a depth
    cut).  ``memo`` keeps each step's outputs and counts for the next mesh
    (they do not depend on the mesh: the port partitions nothing)."""
    cfg = cfg or cfgbase.get_config(arch)
    shape = cfgbase.SHAPES[shape] if isinstance(shape, str) else shape
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh}
    if not cfgbase.shape_applicable(cfg, shape):
        rec["status"] = "skipped (full-attention arch at 500k context)"
        _write(rec, out_dir, tag)
        return rec
    m = MESHES[mesh]()
    chips = m.size
    pol = policy or policy_mod.PerfPolicy()
    rec["policy"] = dataclasses.asdict(pol)
    t0 = time.time()
    try:
        with shardctx.rules(sharding.activation_rules(cfg, m)) as seen, \
                policy_mod.use(pol):
            fn, args = build_step(cfg, shape, m, device="meta",
                                  comms_npes=comms_npes)
            a_sh = arg_shardings(cfg, shape, m, args)
            key = (arch, shape, cfg, comms_npes, pol)
            if memo is not None and key in memo:
                out, summary = memo[key]
            else:
                out, summary = count_step(fn, args)
                if memo is not None:
                    memo[key] = out, summary
            o_sh = out_shardings(cfg, shape, m, out, a_sh)
        summary = dict(summary)
        peak = summary.pop("peak_bytes")
        if mesh != "card":
            peak = None
        arg_b = sum(sharding.per_device_bytes(a, s, m)
                    for a, s in zip(args, a_sh))
        out_b = sum(sharding.per_device_bytes(o, s, m)
                    for o, s in zip(out, o_sh))
        split = {k: summary[k] / chips for k in
                 ("flops", "bytes", "transcendental", "collective_bytes")}
        split["split"] = (f"the global counts divided evenly over {chips} "
                          "chips (the port partitions nothing)")
        rec.update({
            "status": "ok",
            "chips": chips,
            "dtype": cfg.dtype,
            "comms_npes": comms_npes,
            "t_run_s": round(time.time() - t0, 2),
            "memory": {"argument_size_in_bytes": arg_b,
                       "output_size_in_bytes": out_b,
                       "temp_size_in_bytes": peak},
            "counted": summary,
            "counted_per_device": split,
            "counted_bytes_are": "the eager implementation's traffic: "
            "every aten op's operands read and outputs written, each "
            "kernel charged its formula; it falls when ops fuse",
            "constraints": seen,
            "model_flops": model_flops(cfg, shape),
            "params_total": cfg.param_count(),
            "params_active": cfg.param_count(active_only=True),
            "fits": (arg_b + peak <= CARD_BYTES) if peak is not None
            else None,
        })
        print(f"[dryrun] {arch} x {shape.name} x {mesh}: OK "
              f"({rec['t_run_s']:.1f}s, args {arg_b / 2**30:.2f} GiB/device"
              + (f", temp {peak / 2**30:.2f} GiB" if peak is not None
                 else "") + ")", flush=True)
    except Exception as e:
        rec["status"] = f"error: {type(e).__name__}: {str(e)[:2000]}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch} x {shape.name} x {mesh}: FAILED "
              f"{type(e).__name__}: {str(e)[:200]}", flush=True)
    _write(rec, out_dir, tag)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=None, choices=["card"],
                    help="the one-H100 mesh (instead of --multipod)")
    ap.add_argument("--multipod", default="no", choices=["no", "yes", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--policy", action="append", default=None,
                    help="PerfPolicy override k=v (repeatable)")
    ap.add_argument("--tag", default="",
                    help="artifact suffix for policy experiments")
    args = ap.parse_args(argv)
    pol = policy_mod.parse_overrides(args.policy) if args.policy else None

    meshes = ["card"] if args.mesh == "card" else \
        {"no": ["pod1"], "yes": ["pod2"], "both": ["pod1", "pod2"]}[
            args.multipod]
    archs = cfgbase.ARCH_NAMES if args.all or not args.arch else [args.arch]
    shapes = (list(cfgbase.SHAPES) if args.all or not args.shape
              else [args.shape])
    results = []
    for arch in archs:
        for shape in shapes:
            memo = {}
            for mesh in meshes:
                results.append(run_one(arch, shape, mesh, args.out,
                                       policy=pol, tag=args.tag, memo=memo))
    ok = sum(1 for r in results if r.get("status") == "ok")
    skipped = sum(1 for r in results
                  if str(r.get("status", "")).startswith("skipped"))
    print(f"[dryrun] done: {ok} ok, {skipped} skipped, "
          f"{len(results) - ok - skipped} failed / {len(results)} total")
    return results


if __name__ == "__main__":
    main()
