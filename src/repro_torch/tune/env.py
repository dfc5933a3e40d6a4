"""``ISHMEM_*`` environment-variable configuration surface.

Counterpart of ``repro/tune/env.py``.

Mirrors the knobs the real Intel SHMEM library reads at ``ishmem_init``:

========================  ====================================================
``ISHMEM_ENABLE_CUTOVER`` ``1``/``0`` — enable adaptive transport selection
                          (default on; off pins every intra-fabric op to the
                          direct load/store path)
``ISHMEM_CUTOVER_BYTES``  explicit direct->engine switch size, overriding both
                          the analytic model and any tuning table; accepts
                          ``4096``, ``16K``, ``2M``, ``1G`` suffixes
``ISHMEM_FORCE_PATH``     ``direct`` | ``engine`` | ``proxy`` — pin one path
``ISHMEM_WORK_GROUP_SIZE`` default work-group size for ``ishmemx_*_work_group``
                          — honored by ``core.device.work_group`` AND by every
                          host-side ``choose_path``/collective pricing site
                          that does not pass an explicit width
                          (``cutover.resolve_work_items``), so one variable
                          moves both the device ops and the host cost model
``ISHMEM_TUNING_FILE``    JSON :class:`TuningTable` from a profiling run
                          (``Context.fit_tuning_table``, then
                          ``TuningTable.save``) — arms measured cutovers
``ISHMEM_NBI_COALESCE``   ``1``/``0`` — write-combine queued nbi ops at
                          quiet/barrier flush (default on; off issues one
                          wire transfer per application call — see
                          ``core/pending.py``)
========================  ====================================================

``context.init`` calls :func:`tuning_from_env` when no explicit ``Tuning`` is
passed, so exporting these variables tunes a run with zero code changes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

from repro_torch.tune.table import INF_CUTOVER, TuningTable

PREFIX = "ISHMEM_"
PATHS = ("direct", "engine", "proxy")

_SUFFIX = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}


def parse_bytes(text: str) -> int:
    """``"4096"`` | ``"16K"`` | ``"2M"`` | ``"1G"`` -> bytes."""
    s = text.strip().upper()
    if s and s[-1] in _SUFFIX:
        return int(float(s[:-1]) * _SUFFIX[s[-1]])
    return int(s)


def _parse_bool(text: str, *, var: str) -> bool:
    s = text.strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"{var}: expected a boolean, got {text!r}")


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    enable_cutover: bool = True
    cutover_bytes: Optional[int] = None
    force_path: Optional[str] = None
    work_group_size: int = 128
    tuning_file: Optional[str] = None
    nbi_coalesce: bool = True


def load_env(environ: Optional[Mapping[str, str]] = None) -> EnvConfig:
    """Parse the ``ISHMEM_*`` variables (defaults match an empty environment)."""
    env = os.environ if environ is None else environ

    def get(name: str) -> Optional[str]:
        val = env.get(PREFIX + name)
        return val if val not in (None, "") else None

    enable = get("ENABLE_CUTOVER")
    force = get("FORCE_PATH")
    if force is not None:
        force = force.strip().lower()
        if force not in PATHS:
            raise ValueError(
                f"ISHMEM_FORCE_PATH must be one of {PATHS}, got {force!r}")
    cutover_bytes = get("CUTOVER_BYTES")
    if cutover_bytes is not None:
        try:
            cutover_bytes = parse_bytes(cutover_bytes)
        except ValueError:
            raise ValueError(
                f"ISHMEM_CUTOVER_BYTES: expected a size like 4096/16K/2M/1G, "
                f"got {env.get(PREFIX + 'CUTOVER_BYTES')!r}") from None
    wgs = get("WORK_GROUP_SIZE")
    if wgs is not None:
        try:
            wgs = int(wgs)
        except ValueError:
            raise ValueError(
                f"ISHMEM_WORK_GROUP_SIZE: expected an integer, "
                f"got {wgs!r}") from None
    coalesce = get("NBI_COALESCE")
    return EnvConfig(
        enable_cutover=(True if enable is None
                        else _parse_bool(enable, var="ISHMEM_ENABLE_CUTOVER")),
        cutover_bytes=cutover_bytes,
        force_path=force,
        work_group_size=128 if wgs is None else wgs,
        tuning_file=get("TUNING_FILE"),
        nbi_coalesce=(True if coalesce is None
                      else _parse_bool(coalesce, var="ISHMEM_NBI_COALESCE")),
    )


def tuning_from_env(environ: Optional[Mapping[str, str]] = None,
                    cfg: Optional[EnvConfig] = None):
    """Build the ``cutover.Tuning`` an ``ishmem_init`` would arm.

    Precedence (most to least specific): ``ISHMEM_FORCE_PATH`` >
    ``ISHMEM_CUTOVER_BYTES`` > ``ISHMEM_TUNING_FILE`` (learned table) >
    analytic model.  Disabling cutover pins the direct path (the engine is
    never offloaded to), unless a force path says otherwise.
    """
    from repro_torch.core import cutover

    cfg = cfg or load_env(environ)
    table = None
    if cfg.tuning_file is not None:
        table = TuningTable.load(cfg.tuning_file)   # missing file: loud error
    cutover_bytes = cfg.cutover_bytes
    if not cfg.enable_cutover and cfg.force_path is None:
        # "never switch to the engine" — expressed as an infinite cutover so
        # the dcn tier still routes to the proxy (force_path would hijack it
        # onto the nonexistent kernel-initiated NIC path)
        cutover_bytes = INF_CUTOVER
    return cutover.Tuning(cutover_bytes=cutover_bytes,
                          force_path=cfg.force_path,
                          work_group_size=cfg.work_group_size, table=table,
                          nbi_coalesce=cfg.nbi_coalesce)
