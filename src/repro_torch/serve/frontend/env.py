"""``ISHMEM_FLEET_*`` environment knobs for the cluster frontend.

A copy of ``repro/serve/frontend/env.py`` (pure Python): the port keeps its
own so that it imports nothing of the JAX package.

Mirrors the reference's ``ISHMEM_*`` convention: the launcher
(``repro_torch.launch.serve --fleet``) consults these as its argument
defaults, so a deployment can retune the frontend with zero code changes.

==============================  ============================================
``ISHMEM_FLEET_PODS``           number of pods (default 2)
``ISHMEM_FLEET_ROUTER``         ``random`` | ``round_robin`` |
                                ``least_loaded`` | ``affinity`` (default)
``ISHMEM_FLEET_ADMISSION``      ``slo`` (default) | ``fcfs`` (A/B baseline)
``ISHMEM_FLEET_QUEUE_BOUND``    per-pod queue bound before the SLO policy
                                sheds best-effort traffic (default 12;
                                2x is the hard bound for everything)
``ISHMEM_FLEET_STREAM_CHUNKS``  blocks per mid-prefill wire installment
                                (0 = whole-prefill migration; default 1)
``ISHMEM_FLEET_SEED``           traffic/router determinism seed (default 0)
==============================  ============================================
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

from repro_torch.serve.frontend.router import POLICIES

PREFIX = "ISHMEM_FLEET_"
ADMISSIONS = ("slo", "fcfs")


@dataclasses.dataclass(frozen=True)
class FleetEnv:
    pods: int = 2
    router: str = "affinity"
    admission: str = "slo"
    queue_bound: int = 12
    stream_chunks: int = 1
    seed: int = 0


def load_fleet_env(environ: Optional[Mapping[str, str]] = None) -> FleetEnv:
    """Parse the ``ISHMEM_FLEET_*`` variables (defaults on empty env)."""
    env = os.environ if environ is None else environ

    def get(name: str) -> Optional[str]:
        val = env.get(PREFIX + name)
        return val if val not in (None, "") else None

    def get_int(name: str, default: int, *, minimum: int) -> int:
        raw = get(name)
        if raw is None:
            return default
        try:
            val = int(raw)
        except ValueError:
            raise ValueError(
                f"{PREFIX}{name}: expected an integer, got {raw!r}") from None
        if val < minimum:
            raise ValueError(f"{PREFIX}{name}: must be >= {minimum}, "
                             f"got {val}")
        return val

    router = get("ROUTER")
    if router is not None:
        router = router.strip().lower()
        if router not in POLICIES:
            raise ValueError(
                f"{PREFIX}ROUTER must be one of {POLICIES}, got {router!r}")
    admission = get("ADMISSION")
    if admission is not None:
        admission = admission.strip().lower()
        if admission not in ADMISSIONS:
            raise ValueError(f"{PREFIX}ADMISSION must be one of "
                             f"{ADMISSIONS}, got {admission!r}")
    return FleetEnv(
        pods=get_int("PODS", 2, minimum=1),
        router=router or "affinity",
        admission=admission or "slo",
        queue_bound=get_int("QUEUE_BOUND", 12, minimum=1),
        stream_chunks=get_int("STREAM_CHUNKS", 1, minimum=0),
        seed=get_int("SEED", 0, minimum=0),
    )
