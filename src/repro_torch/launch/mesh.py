"""Meshes for the dry-run (counterpart of ``repro/launch/mesh.py``).

A mesh here is only its axes: :class:`AbstractMesh` holds their sizes and
names and no devices, since the port partitions nothing (the sharding rules
say how the reference lays a step out, and ``launch/dryrun.py`` sizes each
device's share from them).  Single pod: ``(data=16, model=16)``; multi-pod
adds a leading ``pod`` axis (2 pods = 512 chips).  :func:`card_mesh` is the
one H100 the port runs on.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape`` gives it."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_test_mesh(n: int, *, multi_pod: bool = False) -> AbstractMesh:
    """The reference's small mesh over ``n`` devices."""
    if multi_pod and n >= 8:
        return AbstractMesh((2, 2, n // 4), ("pod", "data", "model"))
    if n >= 4:
        return AbstractMesh((2, n // 2), ("data", "model"))
    return AbstractMesh((1, n), ("data", "model"))


def card_mesh() -> AbstractMesh:
    """One H100: both of the rules' axes of size 1, so every spec they
    give names an axis of the mesh and no dimension is split."""
    return AbstractMesh((1, 1), ("data", "model"))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh) -> str:
    return "model"
