"""Device-initiated collectives: the paper's technique as the port's kernels.

Counterpart of ``examples/shmem_collectives.py``, on PE-stacked tensors.
Its first steps are the example's own: ring fcollect (K5), push broadcast
from root 2 (K7), the push barrier (K8), and a tensor-parallel psum on the
``shmem`` backend against the ``xla`` (engine) one.  Then the model phase,
at the architecture's widths (``--full``: its published widths, else the
reduced test variant):

- a tensor-parallel SwiGLU MLP, d_ff split over the PEs, each PE's partial
  summed by ``ShmemOps.psum`` at prefill (``--prefill-tokens`` rows: RS+AG,
  K6 then K5), decode (1 row: fcollect plus a local sum, K5) and a decode
  batch (``--decode-batch`` rows), and by ``psum_overlap`` on both of its
  branches (the small one through K4).  Each result is held against
  ``EngineOps`` and against the unsharded MLP with the whole weights, to
  rtol = atol = 1e-4 (the sums run in another order);
- the logits reduce, ``(decode_batch, vocab)`` f32 per PE;
- ``broadcast`` of every bf16 leaf of one decoder layer from root 0 and
  ``ppermute`` of the prefill hidden around the ring, both bitwise;
- the ``Ishmem`` facade on a heap of npes PEs holding one bf16 MLP weight:
  put/get, ``fetch_add``, ``compare_swap``, ``team_sync``, ``barrier_all``,
  ``broadcast``, ``fcollect``, ``sum_reduce``, ``max_reduce`` and
  ``alltoall``, each against a torch oracle (bitwise).

Every check raises on failure.  Runs on the current CUDA device unless
``--device`` says otherwise:

  PYTHONPATH=src python -m repro_torch.launch.shmem_collectives --device cpu
  PYTHONPATH=src python -m repro_torch.launch.shmem_collectives --full
"""
from __future__ import annotations

import argparse

import torch

TOL = 1e-4            # tests/test_comms_equiv.py::test_tp_layer_end_to_end


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"shmem_collectives: {what}")


def _close(name: str, got, want, report: dict) -> None:
    err = float((got.float() - want.float()).abs().max())
    report["max_abs_err"][name] = err
    _require(got.shape == want.shape and torch.allclose(
        got.float(), want.float(), rtol=TOL, atol=TOL),
        f"{name}: max |err| {err:.3e} outside rtol = atol = {TOL}")


def _equal(name: str, got, want, report: dict) -> None:
    report["max_abs_err"][name] = 0.0
    _require(got.shape == want.shape and torch.equal(got, want),
             f"{name}: not bitwise equal to its oracle")


def example_steps(npes: int, device, gen, report: dict) -> None:
    """``examples/shmem_collectives.py``'s four steps."""
    from repro_torch.comms import api
    from repro_torch.kernels import ring_collectives as rc

    x = torch.randn(npes, 512, generator=gen, device=device)
    ag = rc.ring_allgather(x)
    _equal("fcollect", ag, x.unsqueeze(0).expand(npes, npes, 512), report)
    print(f"[collectives] fcollect ok     : {tuple(ag.shape)}")
    bc = rc.push_broadcast(x, 2)
    _equal("broadcast(root=2)", bc, x[2].expand_as(x), report)
    print("[collectives] broadcast ok    : root 2")
    bar = rc.barrier_push(npes, device=device)
    _require(bar.tolist() == [1] * npes, f"barrier returned {bar.tolist()}")
    print(f"[collectives] barrier         : {bar.tolist()}")
    xa = torch.randn(npes, 4, 256, generator=gen, device=device)
    shmem, engine = api.get_ops("shmem", npes=npes), api.get_ops("xla")
    a, b = shmem.psum(xa), engine.psum(xa)
    _close("psum(4x256)", a, b, report)
    print(f"[collectives] psum shmem==xla : max|diff| = "
          f"{report['max_abs_err']['psum(4x256)']:.2e}")


def tp_mlp_phase(cfg, npes: int, device, gen, args, report: dict):
    """The tensor-parallel MLP, the logits reduce, the layer broadcast and
    the hidden ppermute.  Returns the whole (unsharded) MLP weights."""
    from repro_torch.comms import api
    from repro_torch.models.layers import apply_mlp, dense_init, silu
    from repro_torch.tune import telemetry as telemetry_mod

    d, ff = cfg.d_model, cfg.d_ff
    _require(ff % npes == 0, f"d_ff {ff} does not split over {npes} PEs")
    shard = ff // npes
    w = {k: dense_init(gen, shape, device=device) for k, shape in
         (("w_gate", (d, ff)), ("w_up", (d, ff)), ("w_down", (ff, d)))}
    # PE p holds columns [p*shard, (p+1)*shard) of w_gate/w_up, rows of w_down
    wg = w["w_gate"].reshape(d, npes, shard).permute(1, 0, 2).contiguous()
    wu = w["w_up"].reshape(d, npes, shard).permute(1, 0, 2).contiguous()
    wd = w["w_down"].reshape(npes, shard, d)
    sink = telemetry_mod.TelemetrySink()
    shmem = api.get_ops("shmem", npes=npes, telemetry=sink)
    engine = api.get_ops("xla")

    def partials(x):                                # (npes, T, d)
        return (silu(x @ wg) * (x @ wu)) @ wd

    hidden = None
    cases = [("prefill", args.prefill_tokens, "psum"),
             ("decode", 1, "psum"), ("decode-batch", args.decode_batch, "psum"),
             ("decode", 1, "psum_overlap"),
             ("prefill", args.prefill_tokens, "psum_overlap")]
    print(f"[collectives] TP MLP d_model={d} d_ff={ff} ({shard} per PE), "
          f"npes={npes}, f32")
    for label, T, op in cases:
        x = torch.randn(T, d, generator=gen, device=device)
        part = partials(x)
        got = getattr(shmem, op)(part)
        rec = sink.trace[-1]
        name = f"tp_mlp {label} ({T},{d}) {op}"
        _close(name + " vs engine", got, engine.psum(part), report)
        whole = apply_mlp(w, x, "swiglu")
        _close(name + " vs unsharded", got, whole.expand_as(got), report)
        print(f"[collectives]   {name}: {rec.nbytes} B/PE, path {rec.path}; "
              f"max|err| vs unsharded "
              f"{report['max_abs_err'][name + ' vs unsharded']:.2e}")
        if label == "prefill" and op == "psum":
            hidden = got

    logits = torch.randn(npes, args.decode_batch, cfg.vocab_size,
                         generator=gen, device=device)
    _close(f"logits psum ({args.decode_batch},{cfg.vocab_size})",
           shmem.psum(logits), engine.psum(logits), report)
    print(f"[collectives]   logits reduce ({args.decode_batch}, "
          f"{cfg.vocab_size}) f32: {sink.trace[-1].nbytes} B/PE, path "
          f"{sink.trace[-1].path}")

    perm = [(i, (i + 1) % npes) for i in range(npes)]
    _equal("ppermute(hidden)", shmem.ppermute(hidden, perm),
           engine.ppermute(hidden, perm), report)
    print(f"[collectives]   ppermute of the hidden {tuple(hidden.shape)}: "
          "bitwise")

    from repro_torch.models.attention import init_attn
    from repro_torch.models.layers import init_mlp
    layer = dict(init_attn(gen, cfg, torch.bfloat16, reps=1, device=device))
    layer.update(init_mlp(gen, d, ff, cfg.mlp_type, torch.bfloat16, reps=1,
                          device=device))
    layer["norm1"] = torch.ones(1, d, dtype=torch.bfloat16, device=device)
    layer["norm2"] = torch.ones(1, d, dtype=torch.bfloat16, device=device)
    for key, leaf in sorted(layer.items()):
        x = torch.randn((npes,) + tuple(leaf.shape[1:]), generator=gen,
                        device=device).to(torch.bfloat16)
        x[0] = leaf[0]
        got = shmem.broadcast(x, root=0)
        _equal(f"broadcast {key}", got, engine.broadcast(x, 0), report)
        _equal(f"broadcast {key} == leaf", got[npes - 1], leaf[0], report)
    print(f"[collectives]   broadcast of {len(layer)} bf16 leaves of one "
          "layer from root 0: bitwise")
    report["records"] = [(r.op, r.nbytes, r.path) for r in sink.trace]
    return w


def facade_phase(npes: int, device, gen, weight, report: dict) -> None:
    """The ``Ishmem`` facade on a heap holding one bf16 MLP weight."""
    from repro_torch.core.api import Ishmem

    d, ff = weight.shape
    sh = Ishmem(npes=npes, device=device)
    W = sh.ishmem_malloc((d, ff), "bfloat16")
    wbf = weight.to(torch.bfloat16)
    sh.ishmem_put(W, wbf, pe=3)
    _equal("Ishmem put/get", sh.ishmem_get(W, pe=3), wbf, report)
    _require(not bool(sh.ishmem_get(W, pe=0).any()),
             "Ishmem put wrote a PE other than its target")
    ctr = sh.ishmem_malloc((), "int32")
    _require(int(sh.ishmem_atomic_fetch_add(ctr, 5, pe=2)) == 0
             and int(sh.ishmem_atomic_compare_swap(ctr, 5, 9, pe=2)) == 5
             and int(sh.ishmem_atomic_fetch(ctr, pe=2)) == 9
             and int(sh.ishmem_atomic_fetch(ctr, pe=1)) == 0,
             "Ishmem fetch_add / compare_swap")
    _require(bool(sh.ishmem_team_sync().all())
             and bool(sh.ishmem_barrier_all().all()),
             "Ishmem team_sync / barrier_all not satisfied")
    sh.ishmem_broadcast(W, root=3)
    _equal("Ishmem broadcast", sh.heap.read_all(W),
           wbf.unsqueeze(0).expand(npes, d, ff), report)

    rows = torch.randn(npes, d, ff, generator=gen,
                       device=device).to(torch.bfloat16)
    sh.heap = sh.heap.write_all(W, rows)
    sh.ishmem_sum_reduce(W, W)
    acc = rows[0]
    for i in range(1, npes):
        acc = acc + rows[i]
    _equal("Ishmem sum_reduce (bf16 weight)", sh.heap.read_all(W),
           acc.unsqueeze(0).expand(npes, d, ff), report)

    src = sh.ishmem_malloc((d,), "float32")
    dst = sh.ishmem_malloc((npes * d,), "float32")
    vecs = torch.randn(npes, d, generator=gen, device=device)
    sh.heap = sh.heap.write_all(src, vecs)
    sh.ishmem_fcollect(dst, src)
    _equal("Ishmem fcollect", sh.heap.read_all(dst),
           vecs.reshape(1, -1).expand(npes, npes * d), report)
    sh.ishmem_max_reduce(src, src)
    _equal("Ishmem max_reduce", sh.heap.read_all(src),
           vecs.amax(0).expand(npes, d), report)
    a2a = sh.ishmem_malloc((npes * d,), "float32")
    chunks = torch.randn(npes, npes, d, generator=gen, device=device)
    sh.heap = sh.heap.write_all(dst, chunks)
    sh.ishmem_alltoall(a2a, dst)
    _equal("Ishmem alltoall", sh.heap.read_all(a2a),
           chunks.transpose(0, 1).reshape(npes, npes * d), report)
    report["facade_records"] = len(sh.ctx.ledger)
    print(f"[collectives] Ishmem facade on a {npes}-PE heap holding a "
          f"({d}, {ff}) bf16 weight: put/get, AMOs, sync, barrier, "
          "broadcast, sum/max reduce, fcollect, alltoall ok "
          f"({len(sh.ctx.ledger)} ledger records)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--full", action="store_true",
                    help="the architecture's published widths (default: "
                         "the reduced test variant)")
    ap.add_argument("--npes", type=int, default=8)
    ap.add_argument("--prefill-tokens", type=int, default=512)
    ap.add_argument("--decode-batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    """Run every step; returns a report of each check's max |err| and the
    comms telemetry records.  Raises on the first failed check."""
    args = build_parser().parse_args(argv)
    from repro_torch import _devices
    from repro_torch.configs import base as cfgbase

    device = _devices.resolve(args.device)
    cfg = cfgbase.get_config(args.arch)
    if not args.full:
        cfg = cfgbase.reduced(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    report = {"max_abs_err": {}}
    example_steps(args.npes, device, gen, report)
    weights = tp_mlp_phase(cfg, args.npes, device, gen, args, report)
    facade_phase(args.npes, device, gen, weights["w_gate"], report)
    return report


if __name__ == "__main__":
    main()
