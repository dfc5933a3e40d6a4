"""Training step (counterpart of ``repro/train/train_step.py``): loss,
gradients by ``torch.autograd`` and the optimizer update, with optional
microbatch accumulation; the data-parallel step whose gradients reduce
through the comms backend; and the modeled gradient-reduce schedule.

A step returns ``(params, opt_state, metrics)`` as the reference's does;
the parameters and the optimizer state are updated in place (see
``train/optimizer.py``).
"""
from __future__ import annotations

import torch

from repro_torch.models import model
from repro_torch.train import optimizer as opt_mod, tree as tree_mod


def value_and_grad(params, cfg, batch, grad_accum: int = 1):
    """(loss, metrics, grads as a list in JAX's leaf order).  With
    ``grad_accum`` > 1 the batch splits into that many microbatches whose
    f32 grads and losses are summed in order and divided, and aux is
    reported as 0, as the reference's ``lax.scan`` does."""
    leaves = tree_mod.leaves(params)
    probe = tree_mod.unflatten(params, [p.detach().requires_grad_(True)
                                        for p in leaves])
    inputs = tree_mod.leaves(probe)

    def one(b):
        with torch.enable_grad():
            loss, metrics = model.train_loss(probe, cfg, b)
            grads = torch.autograd.grad(loss, inputs)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            list(grads)

    if grad_accum == 1:
        return one(batch)
    acc, lsum = None, None
    for i in range(grad_accum):
        mb = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                           + tuple(v.shape[1:]))[i] for k, v in batch.items()}
        loss, _, grads = one(mb)
        if acc is None:
            acc = [g.float() for g in grads]          # 0 + g is g
            lsum = loss
        else:
            acc = [a + g for a, g in zip(acc, grads)]
            lsum = lsum + loss
        del grads
    loss = lsum / grad_accum
    return loss, {"ce": loss, "aux": torch.zeros_like(loss)}, \
        [g / grad_accum for g in acc]


def make_train_step(cfg, opt_cfg: opt_mod.OptConfig, *, grad_accum: int = 1):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics)."""

    def step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(params, cfg, batch, grad_accum)
        params, opt_state, om = opt_mod.update(
            cfg.optimizer, params, tree_mod.unflatten(params, grads),
            opt_state, opt_cfg)
        return params, opt_state, {**metrics, **om, "loss": loss}

    return step


def dp_grads(params, cfg, batch, ops, *, grad_accum: int = 1):
    """The data-parallel gradient over ``ops.npes`` simulated PEs: (metrics
    averaged over the PEs, mean grads as a list in JAX's leaf order).

    PE p runs the forward and backward pass on rows ``[p * B/npes,
    (p+1) * B/npes)`` of the global batch; each gradient leaf's PE copies
    are stacked ``(npes, ...)`` in the gradient's dtype and reduced through
    the backend (``ShmemOps``: K4 for small leaves, K6 then K5 for large
    ones, on the card), then divided by npes.  The mean equals the
    single-device gradient on the whole batch (``tests/test_system.py``'s
    law).  With ``policy.overlap_grad_reduce`` leaves reduce by
    ``psum_overlap`` in JAX's leaf order, leaf k+1's reduce issued before
    leaf k's mean is taken; without it, ``psum`` on every leaf first.
    """
    from repro_torch.launch import policy as policy_mod
    P = ops.npes
    B = next(iter(batch.values())).shape[0]
    if B % P:
        raise ValueError(f"global batch {B} does not split over {P} PEs")
    per = B // P
    stacked, sums = None, None
    for p in range(P):
        rows = {k: v[p * per:(p + 1) * per] for k, v in batch.items()}
        loss, metrics, grads = value_and_grad(params, cfg, rows, grad_accum)
        if stacked is None:
            stacked = [g.new_empty((P,) + tuple(g.shape)) for g in grads]
            sums = {"loss": loss, **metrics}
        else:
            sums = {k: sums[k] + v for k, v in
                    (("loss", loss), *metrics.items())}
        for buf, g in zip(stacked, grads):
            buf[p].copy_(g)
        del grads

    overlap = policy_mod.get().overlap_grad_reduce
    reduce = ops.psum_overlap if overlap else ops.psum
    mean = [None] * len(stacked)
    if overlap:
        inflight = reduce(stacked[0])
        for k in range(len(stacked)):
            stacked[k] = None
            nxt = reduce(stacked[k + 1]) if k + 1 < len(stacked) else None
            mean[k] = inflight[0] / P
            inflight = nxt
    else:
        reduced = []
        for k in range(len(stacked)):
            reduced.append(reduce(stacked[k]))
            stacked[k] = None
        for k in range(len(reduced)):
            mean[k] = reduced[k][0] / P
            reduced[k] = None
    return {k: v / P for k, v in sums.items()}, mean


def make_dp_step(cfg, opt_cfg: opt_mod.OptConfig, ops, *,
                 grad_accum: int = 1):
    """Data-parallel step over ``ops.npes`` simulated PEs: :func:`dp_grads`,
    then the reference's update of the one replica.  The update follows the
    last reduce, since the global-norm clip needs every reduced leaf (the
    modeled schedule of :func:`grad_reduce_schedule` overlaps the update
    itself).  Returns what :func:`make_train_step`'s step returns."""

    def step(params, opt_state, batch):
        metrics, mean = dp_grads(params, cfg, batch, ops,
                                 grad_accum=grad_accum)
        params, opt_state, om = opt_mod.update(
            cfg.optimizer, params, tree_mod.unflatten(params, mean),
            opt_state, opt_cfg)
        return params, opt_state, {**metrics, **om}

    return step


def init_state(cfg, *, seed: int = 0, device=None):
    params = model.init_params(cfg, seed=seed, device=device)
    return params, opt_mod.init(cfg.optimizer, params)


# ---------------------------------------------------------------------------
# Gradient-reduce <-> optimizer-update overlap (completion-engine schedule)
# ---------------------------------------------------------------------------

# optimizer bytes touched per gradient byte (read p/m/v + write p/m/v ~ adamw)
_OPT_TRAFFIC = 6.0


def grad_reduce_schedule(params, ops, *, policy=None):
    """Model the step's tail: per-leaf gradient reduction pipelined against
    optimizer updates, as the reference prices it.

    Leaves reduce in JAX's leaf order.  With ``policy.overlap_grad_reduce``
    the (k+1)-th leaf's ring allreduce flies while the k-th leaf's update
    computes.  Under the reference's default ZeRO rules matrix leaves are
    data-sharded, so each PE reduce-scatters only its 1/npes shard and the
    update is shard-local; ``param_tp_only`` turns that off and every leaf
    pays the full allreduce.

    Returns ``(t_blocking, t_overlapped, nleaves)`` in modeled seconds.
    """
    from repro_torch.launch import policy as policy_mod
    pol = policy or policy_mod.get()
    hw = ops.hw
    times = []                                 # (t_reduce, t_update) per leaf
    for leaf in tree_mod.leaves(params):
        nbytes = int(leaf.numel() * leaf.element_size())
        zero_sharded = leaf.dim() >= 2 and not pol.param_tp_only
        frac = 1.0 / ops.npes if zero_sharded else 1.0
        t_r = _ring_time(ops, int(nbytes * frac))
        t_u = nbytes * frac * _OPT_TRAFFIC / hw.reduce_bw
        times.append((t_r, t_u))
    t_blocking = sum(t_r + t_u for t_r, t_u in times)
    if not pol.overlap_grad_reduce or len(times) <= 1:
        return t_blocking, t_blocking, len(times)
    # software pipeline: reduce(k+1) in flight during update(k)
    t = times[0][0]
    for i in range(1, len(times)):
        t += max(times[i][0], times[i - 1][1])
    t += times[-1][1]
    return t_blocking, t, len(times)


def _ring_time(ops, nbytes):
    from repro_torch.core import cutover
    return cutover.t_ring_allreduce(nbytes, ops.npes,
                                    work_items=ops.tuning.work_group_size,
                                    tier="ici", hw=ops.hw, tuning=ops.tuning,
                                    overlap=True)
