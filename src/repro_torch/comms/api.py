"""Collective-ops facade (counterpart of ``repro/comms/api.py``).

The reference's backends run once per PE inside ``shard_map``.  On one
card the port takes PE-stacked tensors instead: every method takes an
``(npes, ...)`` tensor whose leading axis is the PE axis and returns the
stacked result, ``out[p]`` being what PE p's call returns in the
reference.  ``axis_name`` is dropped.  Two backends, named as in the
reference so that callers and telemetry records match:

- ``"xla"``: :class:`EngineOps`, plain torch over the PE axis (the
  counterpart of ``XlaOps``; the tests' oracle);
- ``"shmem"``: :class:`ShmemOps`, the paper's device-initiated path —
  the ring kernels K4-K7 — with the cutover engine's per-message choice.
  It never calls :class:`EngineOps`.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import cutover
from repro_torch.kernels import ops as kops, ring_collectives, rma_copy
from repro_torch.tune import telemetry as telemetry_mod


def get_ops(backend: str, *, npes: int = None,
            hw: cutover.HwParams = cutover.HwParams(),
            tuning: cutover.Tuning = cutover.Tuning(),
            telemetry: telemetry_mod.TelemetrySink | None = None):
    if backend == "xla":
        return EngineOps()
    if backend == "shmem":
        if npes is None:
            raise ValueError("shmem backend needs the axis size (npes)")
        return ShmemOps(npes=npes, hw=hw, tuning=tuning, telemetry=telemetry)
    raise ValueError(backend)


def _stacked(x: torch.Tensor, P: int) -> torch.Tensor:
    """``x`` repeated over a new leading PE axis of ``P``."""
    return x.unsqueeze(0).expand((P,) + tuple(x.shape)).contiguous()


class EngineOps:
    """Plain torch collectives over the PE axis (the engine path)."""

    name = "xla"

    def psum(self, x):
        return _stacked(x.sum(0), x.shape[0])

    def all_gather(self, x):
        return _stacked(x, x.shape[0])

    def reduce_scatter(self, x):
        # x: (npes, npes, chunk...) addend rows -> (npes, chunk...)
        return x.sum(0)

    def broadcast(self, x, root=0):
        return _stacked(x[root], x.shape[0])

    def ppermute(self, x, perm):
        """PE d receives PE s's buffer for each (s, d); PEs that receive
        nothing hold zeros (``lax.ppermute``)."""
        out = torch.zeros_like(x)
        for s, d in perm:
            out[d] = x[s]
        return out


@dataclasses.dataclass
class ShmemOps:
    """Device-initiated path with the paper's cutover policy."""

    npes: int
    hw: cutover.HwParams = cutover.HwParams()
    tuning: cutover.Tuning = cutover.Tuning()
    telemetry: telemetry_mod.TelemetrySink | None = None
    name: str = "shmem"

    # -- helpers -------------------------------------------------------------
    def _check(self, x, lead: int = 1):
        if x.dim() < lead or tuple(x.shape[:lead]) != (self.npes,) * lead:
            raise ValueError(f"ShmemOps({self.npes}): expected a leading PE "
                             f"axis of {self.npes}, got {tuple(x.shape)}")
        return x.contiguous()

    def _rows(self, x):
        """Flatten each PE's buffer to (npes, k) addend rows, padded to a
        multiple of npes * 128: returns (npes, npes, k), the per-PE shape
        and the pad."""
        P = self.npes
        flat = x.reshape(P, -1)
        pad = (-flat.shape[1]) % (P * 128)
        if pad:
            flat = F.pad(flat, (0, pad))
        return flat.reshape(P, P, -1).contiguous(), tuple(x.shape[1:]), pad

    def _unrows(self, full, shape, pad):
        flat = full.reshape(self.npes, -1)
        if pad:
            flat = flat[:, :-pad]
        return flat.reshape((self.npes,) + shape)

    @staticmethod
    def _nbytes(x) -> int:
        """Bytes of one PE's buffer (what the reference's per-PE call
        sees)."""
        return int(x[0].numel() * x.element_size())

    def _choose(self, nbytes):
        return cutover.choose_path(nbytes,
                                   work_items=self.tuning.work_group_size,
                                   tier="ici", hw=self.hw, tuning=self.tuning)

    def _note(self, op, x, path=None):
        if self.telemetry is None:
            return
        nbytes = self._nbytes(x)
        if path is None:                   # only price the decision when a
            path = self._choose(nbytes)    # sink is listening
        wi = self.tuning.work_group_size
        priced_path = path if path in ("direct", "engine") else "direct"
        if op == "ppermute":               # one neighbour put
            t = cutover.op_time(nbytes, priced_path, work_items=wi,
                                tier="ici", hw=self.hw)
        else:
            kind = "fcollect" if op in ("all_gather", "broadcast") else "reduce"
            t = cutover.t_collective(kind, nbytes, self.npes, work_items=wi,
                                     path=priced_path, hw=self.hw)
        self.telemetry.record(telemetry_mod.OpRecord(op, nbytes, path, "ici",
                                                     t, wi))

    def _note_overlap(self, op, x, *, overlap: bool):
        """Record the modeled cost of a ring allreduce under the nbi or the
        blocking schedule (``cutover.t_ring_allreduce``)."""
        if self.telemetry is None:
            return
        nbytes = self._nbytes(x)
        wi = self.tuning.work_group_size
        t = cutover.t_ring_allreduce(nbytes, self.npes, work_items=wi,
                                     tier="ici", hw=self.hw,
                                     tuning=self.tuning, overlap=overlap)
        self.telemetry.record(telemetry_mod.OpRecord(op, nbytes, "direct",
                                                     "ici", t, wi))

    def modeled_overlap_efficiency(self, nbytes: int, *,
                                   step_compute_bytes: float = None) -> float:
        """Blocking-over-nbi modeled time ratio for one ring allreduce of
        ``nbytes`` per PE (default consumer tile: four chunks)."""
        if step_compute_bytes is None:
            step_compute_bytes = 4 * nbytes / max(1, self.npes)
        return cutover.overlap_efficiency(
            nbytes, self.npes, work_items=self.tuning.work_group_size,
            tier="ici", hw=self.hw, tuning=self.tuning,
            step_compute_bytes=step_compute_bytes)

    # -- collectives ---------------------------------------------------------
    def _psum_rs_ag(self, x):
        """Chunked RS+AG allreduce (K6 then K5) over padded rows."""
        rows, shape, pad = self._rows(x)
        return self._unrows(kops.ring_allreduce(rows), shape, pad)

    def psum(self, x):
        x = self._check(x)
        nbytes = self._nbytes(x)
        path = self._choose(nbytes)
        self._note("psum", x, path)
        if path == "direct" and nbytes <= 1 << 16:
            # paper §III-G2 small reduce: fcollect + duplicated local sum
            return ring_collectives.ring_allgather(x).sum(1)
        return self._psum_rs_ag(x)

    def psum_overlap(self, x):
        """Allreduce through the nbi ring step (K4) for small messages,
        where the pass-around's npes * n wire bytes still pay; chunked RS+AG
        above the break-even."""
        x = self._check(x)
        self._note_overlap("psum_nbi", x, overlap=True)
        if self._nbytes(x) * self.npes <= 2 * (1 << 20):
            return kops.ring_allreduce_nbi(x)
        return self._psum_rs_ag(x)

    def all_gather(self, x):
        x = self._check(x)
        self._note("all_gather", x)
        return ring_collectives.ring_allgather(x)

    def reduce_scatter(self, x):
        x = self._check(x, lead=2)
        self._note("reduce_scatter", x)
        return ring_collectives.ring_reduce_scatter(x)

    def broadcast(self, x, root=0):
        x = self._check(x)
        self._note("broadcast", x)
        return ring_collectives.push_broadcast(x, root)

    def ppermute(self, x, perm):
        """A ring permutation is a neighbour put: the offset of PE 0's
        destination (1 when PE 0 sends nothing) applies to every PE."""
        x = self._check(x)
        offsets = {s: (d - s) % self.npes for s, d in perm}
        off = offsets.get(0, 1)
        self._note("ppermute", x)
        return rma_copy.remote_put(x, target_offset=off,
                                   work_items=self.tuning.work_group_size)

    def psum_hierarchical(self, x):
        """Two-level allreduce over ``x`` ``(n_dcn, npes, ...)``: ring
        reduce-scatter (K6) inside each ICI group, a plain torch sum of the
        1/npes shards over the DCN axis (the reference's ``lax.psum``), and
        one ring all-gather (K5) of the summed shards, which every DCN group
        then holds."""
        if x.dim() < 2 or x.shape[1] != self.npes:
            raise ValueError(f"psum_hierarchical: expected (n_dcn, "
                             f"{self.npes}, ...), got {tuple(x.shape)}")
        parts = [self._rows(x[d]) for d in range(x.shape[0])]
        shape, pad = parts[0][1], parts[0][2]
        mine = torch.stack([ring_collectives.ring_reduce_scatter(rows)
                            for rows, _, _ in parts]).sum(0)
        full = ring_collectives.ring_allgather(mine.contiguous())
        out = self._unrows(full, shape, pad)
        return _stacked(out, x.shape[0])
