"""Quickstart on the PyTorch port: the Intel-SHMEM-style PGAS API.

The same ops, in the same order, as ``examples/quickstart.py``, on
``repro_torch.core``: 8 PEs (2 "pods" of 4), symmetric buffers, put/get,
the work-group put, atomics, signaling, non-blocking puts completed by
quiet, broadcast/reduce/sync on the shared-fabric team, and a
reverse-offloaded cross-pod put through the 64-byte ring.  Its data is
deterministic, so every printed line equals the JAX script's.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the current CUDA device unless ``--device`` says otherwise; on the card
every heap store is one launch of the copy kernel, K1)
"""
import argparse

import numpy as np
import torch

from repro_torch.core import amo, collectives, context, proxy, rma, signal


def _np(t):
    return np.asarray(t.detach().cpu())


def main(argv=None) -> dict:
    """Runs the quickstart; returns what it printed, by name."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the current CUDA device")
    args = ap.parse_args(argv)
    out = {}

    # ishmem_init: 8 PEs, 4 per shared-fabric node (pod)
    ctx, heap = context.init(npes=8, node_size=4, device=args.device)
    dev = heap.device

    # --- symmetric allocation (host-only API, identical layout at every PE)
    buf = heap.malloc((1024,), "float32")
    # the JAX script's signal word is uint32; the port's heap has pools for
    # float32, bfloat16 and int32 only (torch has no uint32 arithmetic),
    # so the word is int32, as every signal word of its KV pool is
    sig = heap.malloc((), "int32")
    ctr = heap.malloc((), "int32")

    # --- RMA: blocking put/get (paper Fig. 3)
    data = torch.arange(1024, dtype=torch.float32, device=dev)
    heap = rma.put(ctx, heap, buf, data, dst_pe=3, src_pe=0)      # intra-pod
    out["get3"] = _np(rma.get(ctx, heap, buf, 3)[:4])
    print("get(3)[:4]          =", out["get3"])

    # work-group collaborative put: 1024 work-items (paper Fig. 4a)
    heap = rma.put(ctx, heap, buf, data * 2, dst_pe=1, src_pe=0,
                   work_items=1024)
    out["wg_path"], out["wg_us"] = ctx.ledger[-1].path, \
        ctx.ledger[-1].t_sec * 1e6
    print("wg put path          =", out["wg_path"],
          f"({out['wg_us']:.2f} us)")

    # --- AMOs + signaling
    heap, old = amo.fetch_add(ctx, heap, ctr, 5, pe=2)
    heap = signal.put_signal(ctx, heap, buf, data, sig, 1,
                             signal.SIGNAL_ADD, dst_pe=2, src_pe=0)
    heap, cur, ok = signal.signal_wait_until(ctx, heap, sig, 2, "ge", 1)
    out["signal"], out["satisfied"] = int(cur), bool(ok)
    print("signal at PE2        =", out["signal"], "satisfied:",
          out["satisfied"])

    # --- non-blocking ops: deferred until quiet (completion engine)
    heap = rma.put_nbi(ctx, heap, buf, data * 3, dst_pe=2, src_pe=0)
    out["before_quiet"] = float(heap.read(buf, 2)[1])
    print("before quiet [1]     =", out["before_quiet"], "(old value)")
    heap = rma.quiet(ctx, heap)            # completes + coalesces the queue
    out["after_quiet"] = float(heap.read(buf, 2)[1])
    out["coalescing"] = ctx.pending.stats.coalescing_ratio()
    print("after  quiet [1]     =", out["after_quiet"],
          f"(coalescing ratio {out['coalescing']:.1f})")

    # --- collectives on the shared-fabric team (paper Figs. 6-7)
    team = ctx.team_shared(0)                                 # PEs 0..3
    heap = collectives.broadcast(ctx, heap, buf, root=0, team=team,
                                 work_items=128)
    heap = collectives.reduce(ctx, heap, buf, buf, "sum", team)
    out["reduce0"] = _np(heap.read(buf, 0)[:4])
    print("reduce[0][:4]        =", out["reduce0"])

    sync_ctr = heap.malloc((), "int32")
    heap, sat = collectives.sync(ctx, heap, sync_ctr, team)
    out["sync"] = sat.tolist()
    print("push-sync satisfied  =", out["sync"])

    # --- cross-pod put: reverse offload through the 64-byte ring
    px = proxy.HostProxy(ctx)
    px.put(buf, torch.full((1024,), 9.0, device=dev), pe=7)   # other pod
    heap = px.drain(heap)                                 # host proxy thread
    out["cross_pod"] = _np(heap.read(buf, 7)[:4])
    out["ring_msgs"] = len(px.ring.delivered)
    out["flow_control_overhead"] = px.ring.flow_control_overhead()
    print("cross-pod put        =", out["cross_pod"],
          f"(ring: {out['ring_msgs']} msgs, "
          f"flow-control overhead {out['flow_control_overhead']:.1%})")

    out["ledger_ops"] = len(ctx.ledger)
    out["modeled_total_us"] = ctx.total_time() * 1e6
    print("\nledger:", out["ledger_ops"], "ops,",
          f"modeled total {out['modeled_total_us']:.1f} us")
    return out


if __name__ == "__main__":
    main()
