"""Adaptive transport selection — the paper's "cutover" engine (§III-B, §IV).

A copy of the point-to-point half of ``repro/core/cutover.py``.  Three
transports: ``direct`` (kernel-initiated stores), ``engine`` (a copy engine
started outside the kernel) and ``proxy`` (the host-proxy scale-out path).
The cutover between ``direct`` and ``engine`` depends on the message size
and the work-group size.

The :class:`HwParams` defaults are the reference's MODELED constants, kept
equal so that path choices and the telemetry records match the JAX package
op for op.  They are not measurements of any card, and nothing in the port
states them as H100 figures.  The collective and ring cost models come with
the collectives slice.
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


@dataclasses.dataclass(frozen=True)
class Tuning:
    """User-tunable cutover policy.  The port's ``context.init`` uses the
    defaults; the ``ISHMEM_*`` environment knobs and the learned tuning
    table come later (ROADMAP queue 1, item 5c)."""
    cutover_bytes: int | None = None   # None -> model-derived
    force_path: str | None = None      # "direct" | "engine" | "proxy"
    work_group_size: int = 128
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
    analytic model."""
    work_items = resolve_work_items(work_items, tuning)
    if tuning.force_path:
        return tuning.force_path
    if tier == "dcn":
        return "proxy"
    if tuning.cutover_bytes is not None:
        return "direct" if nbytes <= tuning.cutover_bytes else "engine"
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
