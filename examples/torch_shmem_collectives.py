"""Device-initiated collectives on the PyTorch port: the four steps of
``examples/shmem_collectives.py``.

Over 8 simulated PEs (the leading axis of a stacked ``(8, ...)`` tensor,
one CTA group a PE on the card): ring fcollect (K5), a push broadcast
from root 2 (K7), the push barrier (K8), and a tensor-parallel psum on
the ``shmem`` comms backend against the ``xla`` one (``EngineOps``, plain
torch over the PE axis).  The JAX script compares against ``jax.lax`` and
``kernels/ref.py``; the port holds no JAX, so each kernel is compared
with its plain version.  Inputs come from a numpy seed, so every device
sees the same numbers.

Run:  PYTHONPATH=src python examples/torch_shmem_collectives.py [--device cpu]
(the current CUDA device unless ``--device`` says otherwise)
"""
import argparse

import numpy as np
import torch

from repro_torch import _devices
from repro_torch.comms import api
from repro_torch.kernels import ring_collectives as rc

NPES = 8


def main(argv=None) -> dict:
    """Runs the four steps; returns what they printed, with their inputs
    and outputs as numpy arrays."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the current CUDA device")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = _devices.resolve(args.device)
    rng = np.random.default_rng(args.seed)
    x_np = rng.standard_normal((NPES, 512)).astype(np.float32)
    xa_np = rng.standard_normal((NPES, 4, 256)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    out = {"x": x_np, "xa": xa_np}

    # fcollect (ring all-gather), device-initiated
    ag = rc.ring_allgather(x)
    out["fcollect_ok"] = torch.equal(ag, rc.ring_allgather_plain(x))
    print("fcollect ok     :", out["fcollect_ok"])

    # push broadcast from root 2
    bc = rc.push_broadcast(x, 2)
    out["broadcast_ok"] = torch.equal(bc, rc.push_broadcast_plain(x, 2))
    print("broadcast ok    :", out["broadcast_ok"])

    # push-style barrier (the paper's atomic-increment sync)
    bar = rc.barrier_push(NPES, device=dev)
    out["barrier"] = bar.tolist()
    out["barrier_ok"] = out["barrier"] == \
        rc.barrier_push_plain(NPES, dev).tolist()
    print("barrier         :", out["barrier"])

    # tensor-parallel psum: shmem backend vs the engine's
    xa = torch.from_numpy(xa_np).to(dev)
    shmem = api.get_ops("shmem", npes=NPES)
    xla = api.get_ops("xla")
    ps_shmem, ps_xla = shmem.psum(xa), xla.psum(xa)
    out["psum_err"] = float((ps_shmem - ps_xla).abs().max())
    print(f"psum shmem==xla : max|diff| = {out['psum_err']:.2e}")

    out.update(fcollect=ag.cpu().numpy(), broadcast=bc.cpu().numpy(),
               psum_shmem=ps_shmem.cpu().numpy(),
               psum_xla=ps_xla.cpu().numpy())
    return out


if __name__ == "__main__":
    main()
