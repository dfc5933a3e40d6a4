"""Adaptive transport selection — the paper's "cutover" engine (§III-B, §IV).

A copy of ``repro/core/cutover.py``'s point-to-point chooser, collective
cost models, and ring-allreduce and ring-attention overlap models.  Three transports: ``direct``
(kernel-initiated stores), ``engine`` (a copy engine started outside the
kernel) and ``proxy`` (the host-proxy scale-out path).  The cutover between
``direct`` and ``engine`` depends on the message size and the work-group
size, and for collectives also on the number of PEs.

The :class:`HwParams` defaults are the reference's MODELED constants, kept
equal so that path choices and the telemetry records match the JAX package
op for op.  They are not measurements of any card, and nothing in the port
states them as H100 figures.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HwParams:
    """Modeled transport constants (the reference's values, per PE)."""
    hbm_bw: float = 819e9            # B/s — local copies (same-PE tier)
    ici_bw: float = 50e9             # B/s per link — engine path peak
    dcn_bw: float = 25e9             # B/s — cross-pod NIC tier
    direct_bw_cap: float = 45e9      # B/s — kernel-issued stores saturate below peak
    direct_bw_per_item: float = 1.6e9  # B/s per concurrent work item
    alpha_direct: float = 1.2e-6     # s — in-kernel issue latency
    alpha_engine: float = 4.5e-6     # s — engine startup incl. reverse offload
    alpha_proxy: float = 8.0e-6      # s — ring-buffer RTT + NIC doorbell
    ring_msg_bytes: int = 64         # reverse-offload message size (§III-D)
    reduce_bw: float = 200e9         # B/s — tile compute priced by the
                                     # comm/compute overlap model


@dataclasses.dataclass(frozen=True)
class Tuning:
    """User-tunable cutover policy (the ``ISHMEM_*`` knobs, parsed by
    ``repro_torch.tune.env``)."""
    cutover_bytes: int | None = None   # None -> model-derived
    force_path: str | None = None      # "direct" | "engine" | "proxy"
    work_group_size: int = 128
    # a learned ``repro_torch.tune.table.TuningTable`` (duck-typed through
    # ``lookup``, so core does not import the tuner): where it covers a
    # tier, its measured cutovers override the analytic model
    table: object | None = None
    # write-combine queued nbi puts at flush (see core/pending.py)
    nbi_coalesce: bool = True


TIERS = ("local", "ici", "dcn")


def resolve_work_items(work_items, tuning: Tuning) -> int:
    """``None`` means the configured work-group size."""
    return tuning.work_group_size if work_items is None else work_items


def direct_bw(hw: HwParams, work_items: int) -> float:
    return min(hw.direct_bw_cap, max(1, work_items) * hw.direct_bw_per_item)


def t_direct(hw: HwParams, nbytes: int, work_items: int, tier: str) -> float:
    if tier == "dcn":
        return math.inf                      # no kernel-initiated NIC path
    bw = direct_bw(hw, work_items)
    if tier == "local":
        bw = min(hw.hbm_bw, max(bw, work_items * 4 * hw.direct_bw_per_item))
    return hw.alpha_direct + nbytes / bw


def t_engine(hw: HwParams, nbytes: int, tier: str) -> float:
    bw = {"local": hw.hbm_bw, "ici": hw.ici_bw, "dcn": hw.dcn_bw}[tier]
    return hw.alpha_engine + nbytes / bw


def t_proxy(hw: HwParams, nbytes: int, tier: str) -> float:
    bw = hw.dcn_bw if tier == "dcn" else hw.ici_bw
    return hw.alpha_proxy + nbytes / bw + hw.ring_msg_bytes / hw.dcn_bw


def choose_path(nbytes: int, *, work_items: int | None = None,
                tier: str = "ici", hw: HwParams = HwParams(),
                tuning: Tuning = Tuning()) -> str:
    """Pick the transport for one RMA op: FORCE_PATH > CUTOVER_BYTES >
    learned table > analytic model."""
    work_items = resolve_work_items(work_items, tuning)
    if tuning.force_path:
        return tuning.force_path
    if tier == "dcn":
        return "proxy"
    if tuning.cutover_bytes is not None:
        return "direct" if nbytes <= tuning.cutover_bytes else "engine"
    if tuning.table is not None:
        learned = tuning.table.lookup(tier, work_items)
        if learned is not None:
            return "direct" if nbytes <= learned else "engine"
    td = t_direct(hw, nbytes, work_items, tier)
    te = t_engine(hw, nbytes, tier)
    return "direct" if td <= te else "engine"


def op_time(nbytes: int, path: str, *, work_items: int = 128,
            tier: str = "ici", hw: HwParams = HwParams()) -> float:
    """Modeled seconds of one op on one path (the telemetry's comm clock)."""
    if path == "direct":
        return t_direct(hw, nbytes, work_items, tier)
    if path == "engine":
        return t_engine(hw, nbytes, tier)
    if path == "proxy":
        return t_proxy(hw, nbytes, tier)
    raise ValueError(path)


def choose_collective_path(kind: str, nbytes: int, npes: int, *,
                           work_items: int | None = None, tier: str = "ici",
                           hw: HwParams = HwParams(),
                           tuning: Tuning = Tuning()) -> str:
    """The chooser for collectives: FORCE_PATH > CUTOVER_BYTES or a learned
    table covering the tier (through :func:`choose_path`) > the collective
    cost models (Fig. 6 crossovers).  A table without coverage for the tier
    leaves the collective model alone."""
    work_items = resolve_work_items(work_items, tuning)
    if tuning.force_path:
        return tuning.force_path
    if tuning.cutover_bytes is not None or (
            tuning.table is not None
            and tuning.table.lookup(tier, work_items) is not None):
        return choose_path(nbytes, work_items=work_items, tier=tier, hw=hw,
                           tuning=tuning)
    td = t_collective(kind, nbytes, npes, work_items=work_items,
                      path="direct", hw=hw)
    te = t_collective(kind, nbytes, npes, path="engine", hw=hw)
    return "direct" if td <= te else "engine"


def cutover_bytes(*, work_items: int = 128, tier: str = "ici",
                  hw: HwParams = HwParams()) -> int:
    """Closed-form crossing point of t_direct and t_engine:
    n* = (alpha_e - alpha_d) / (1/bw_d - 1/bw_e), or "never" (2**62) when
    the direct path is at least as fast at every size."""
    bw_d = direct_bw(hw, work_items)
    bw_e = {"local": hw.hbm_bw, "ici": hw.ici_bw, "dcn": hw.dcn_bw}[tier]
    if tier == "local":
        bw_d = min(hw.hbm_bw, max(bw_d, work_items * 4 * hw.direct_bw_per_item))
    if bw_d >= bw_e:
        return 1 << 62
    n = (hw.alpha_engine - hw.alpha_direct) / (1.0 / bw_d - 1.0 / bw_e)
    return max(0, int(n))


# ---------------------------------------------------------------------------
# collective cost models (push-style, paper §III-G2)
# ---------------------------------------------------------------------------


def t_collective(kind: str, nbytes_per_pe: int, npes: int, *,
                 work_items: int = 128, path: str = "direct",
                 hw: HwParams = HwParams()) -> float:
    """Modeled seconds of one intra-node collective on an all-to-all tier."""
    if kind == "sync":
        # pipelined remote atomic increments, then a local wait
        return hw.alpha_direct + (npes - 1) * 64 / direct_bw(hw, work_items) \
            + hw.alpha_direct
    if kind in ("broadcast", "fcollect"):
        # push: every store spends the initiator's store bandwidth
        total = nbytes_per_pe * (npes - 1)
        if path == "direct":
            return hw.alpha_direct + total / direct_bw(hw, work_items)
        return hw.alpha_engine * (npes - 1) + total / hw.ici_bw
    if kind == "alltoall":
        # pairwise exchange: each PE sends npes-1 distinct chunks
        total = nbytes_per_pe * (npes - 1) / max(1, npes)
        if path == "direct":
            return hw.alpha_direct + total / direct_bw(hw, work_items)
        return hw.alpha_engine * (npes - 1) + total / hw.ici_bw
    if kind == "reduce":
        # address-split: each PE reads npes rows, computes, stores
        loads = nbytes_per_pe * npes
        if path == "direct":
            return hw.alpha_direct + loads / direct_bw(hw, work_items)
        return hw.alpha_engine * npes + loads / hw.ici_bw
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# comm/compute overlap model (paper §III-F): a ring allreduce whose
# neighbour transfer starts nbi and completes one step later
# ---------------------------------------------------------------------------


def t_ring_step(chunk_bytes: float, *, work_items: int | None = None,
                tier: str = "ici", hw: HwParams = HwParams(),
                tuning: Tuning = Tuning()) -> float:
    """One neighbour transfer of the ring (path picked per chunk size)."""
    work_items = resolve_work_items(work_items, tuning)
    path = choose_path(max(1, int(chunk_bytes)), work_items=work_items,
                       tier=tier, hw=hw, tuning=tuning)
    if path == "proxy":
        return t_proxy(hw, int(chunk_bytes), tier)
    return op_time(int(chunk_bytes), path, work_items=work_items, tier=tier,
                   hw=hw)


def t_ring_allreduce(nbytes: int, npes: int, *, work_items: int | None = None,
                     tier: str = "ici", hw: HwParams = HwParams(),
                     tuning: Tuning = Tuning(), overlap: bool = False,
                     step_compute_bytes: float = 0.0) -> float:
    """(npes-1) reduce-scatter steps (transfer + tile-add), then (npes-1)
    all-gather steps (transfer + consumer compute).  Blocking serialises
    each step's transfer and compute; the nbi schedule costs
    max(t_xfer, t_compute) per steady step, plus one fill, one drain and
    the quiet closing each phase."""
    if npes <= 1:
        return 0.0
    chunk = nbytes / npes
    t_x = t_ring_step(chunk, work_items=work_items, tier=tier, hw=hw,
                      tuning=tuning)
    t_rs_c = (chunk + step_compute_bytes) / hw.reduce_bw   # add + app tile
    t_ag_c = step_compute_bytes / hw.reduce_bw             # app tile only
    steps = npes - 1

    def phase(t_c):
        if not overlap:
            return steps * (t_x + t_c)
        return t_x + max(0, steps - 1) * max(t_x, t_c) + t_c

    quiet = 0.0 if not overlap else 2 * hw.alpha_direct
    return phase(t_rs_c) + phase(t_ag_c) + quiet


def overlap_efficiency(nbytes: int, npes: int, *, work_items: int | None = None,
                       tier: str = "ici", hw: HwParams = HwParams(),
                       tuning: Tuning = Tuning(),
                       step_compute_bytes: float = 0.0) -> float:
    """Modeled speedup of the nbi ring schedule over the blocking one."""
    kw = dict(work_items=work_items, tier=tier, hw=hw, tuning=tuning,
              step_compute_bytes=step_compute_bytes)
    tb = t_ring_allreduce(nbytes, npes, overlap=False, **kw)
    tn = t_ring_allreduce(nbytes, npes, overlap=True, **kw)
    return tb / tn if tn > 0 else 1.0


def t_ring_attention(kv_bytes_per_shard: int, compute_bytes_per_step: float,
                     npes: int, *, overlap: bool = True,
                     work_items: int | None = None, tier: str = "ici",
                     hw: HwParams = HwParams(),
                     tuning: Tuning = Tuning()) -> float:
    """Sequence-parallel ring attention over ``npes`` PEs: each PE computes
    a partial flash step against its resident K/V shard and rotates shards
    around the ring ``npes - 1`` times.  Blocking serialises each
    rotation and its compute; the device-initiated schedule issues step
    k+1's rotation (nbi put_signal) before consuming step k's shard, so a
    steady step costs ``max(t_xfer, t_compute)``, plus the two direct
    launch latencies of the closing quiet."""
    work_items = resolve_work_items(work_items, tuning)
    t_c = compute_bytes_per_step / hw.reduce_bw
    if npes <= 1:
        return t_c
    t_x = t_ring_step(kv_bytes_per_shard, work_items=work_items, tier=tier,
                      hw=hw, tuning=tuning)
    if not overlap:
        return t_c + (npes - 1) * (t_x + t_c)
    return t_c + (npes - 1) * max(t_x, t_c) + 2 * hw.alpha_direct


def ring_attention_overlap(kv_bytes_per_shard: int,
                           compute_bytes_per_step: float, npes: int, *,
                           work_items: int | None = None, tier: str = "ici",
                           hw: HwParams = HwParams(),
                           tuning: Tuning = Tuning()) -> float:
    """Modeled speedup of device-initiated ring attention over the
    blocking rotate-then-compute schedule."""
    kw = dict(work_items=work_items, tier=tier, hw=hw, tuning=tuning)
    tb = t_ring_attention(kv_bytes_per_shard, compute_bytes_per_step, npes,
                          overlap=False, **kw)
    tn = t_ring_attention(kv_bytes_per_shard, compute_bytes_per_step, npes,
                          overlap=True, **kw)
    return tb / tn if tn > 0 else 1.0


def collective_cutover_elems(kind: str, npes: int, elem_bytes: int, *,
                             work_items: int = 128,
                             hw: HwParams = HwParams()) -> int:
    """Smallest nelems where the engine path beats direct (Fig. 6)."""
    lo, hi = 1, 1 << 30

    def direct_wins(n):
        return (t_collective(kind, n * elem_bytes, npes,
                             work_items=work_items, path="direct", hw=hw)
                <= t_collective(kind, n * elem_bytes, npes,
                                work_items=work_items, path="engine", hw=hw))

    if not direct_wins(lo):
        return 0
    if direct_wins(hi):
        return 1 << 62
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if direct_wins(mid):
            lo = mid
        else:
            hi = mid
    return hi
