"""OpenSHMEM 1.5 teams (a copy of ``repro/core/teams.py``).

A team is a (start, stride, size) slice of the world PE set, exactly the
``shmem_team_split_strided`` model.  ``shared`` is ``ISHMEM_TEAM_SHARED``:
the PEs that share one node's fabric.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Team:
    start: int
    stride: int
    size: int

    def pes(self) -> list:
        return [self.start + i * self.stride for i in range(self.size)]

    def translate(self, team_pe: int) -> int:
        """team-relative rank -> world PE."""
        if not 0 <= team_pe < self.size:
            raise ValueError(f"rank {team_pe} outside team of size {self.size}")
        return self.start + team_pe * self.stride

    def rank_of(self, world_pe: int) -> int:
        """world PE -> team rank, or -1 if not a member."""
        d = world_pe - self.start
        if d < 0 or d % self.stride or d // self.stride >= self.size:
            return -1
        return d // self.stride

    def split_strided(self, start: int, stride: int, size: int) -> "Team":
        """shmem_team_split_strided relative to this team."""
        if start < 0 or stride < 1 or size < 1:
            raise ValueError(
                f"invalid split (start={start}, stride={stride}, size={size})")
        if start + (size - 1) * stride >= self.size:
            raise ValueError("child team exceeds parent")
        return Team(self.translate(start), self.stride * stride, size)


def world(npes: int) -> Team:
    return Team(0, 1, npes)


def shared(npes: int, node_size: int, node_id: int) -> Team:
    """ISHMEM_TEAM_SHARED: the PEs of one shared-fabric node (pod)."""
    if node_size * (node_id + 1) > npes:
        raise ValueError("node beyond world")
    return Team(node_id * node_size, 1, node_size)


def pods_partition(team: Team, pod_sizes) -> list:
    """Split a team into contiguous pods of the given (possibly uneven)
    sizes; trailing PEs may stay unassigned."""
    sizes = list(pod_sizes)
    if not sizes or any(s < 1 for s in sizes):
        raise ValueError(f"pod sizes must be positive, got {sizes}")
    if sum(sizes) > team.size:
        raise ValueError(
            f"pods need {sum(sizes)} PEs but the team holds {team.size}")
    out, off = [], 0
    for s in sizes:
        out.append(team.split_strided(off, 1, s))
        off += s
    return out


def disagg_partition(team: Team, n_prefill: int) -> tuple:
    """Split a team into contiguous (prefill, decode) sub-teams for
    disaggregated serving — the prefill fleet owns the first ``n_prefill``
    ranks, the decode fleet the rest.  Built on ``split_strided`` so it works
    on ``world`` and on a ``shared()`` pod team alike (the intra-pod split
    the serve launcher uses when prefill and decode share one fabric)."""
    if not 0 < n_prefill < team.size:
        raise ValueError(
            f"need 0 < n_prefill < {team.size}, got {n_prefill}")
    return (team.split_strided(0, 1, n_prefill),
            team.split_strided(n_prefill, 1, team.size - n_prefill))
