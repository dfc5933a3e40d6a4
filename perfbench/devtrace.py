"""Reading a ``torch.profiler`` slice: device busy time as the union of
every kernel, memcpy and memset interval, device time by kernel name and
by group, the idle gaps between device operations attributed to the
host range (``perfbench.*`` ``record_function``) that covered them, and
the device time under one host range."""
from __future__ import annotations

from collections import defaultdict

# copied from launch/profile_serve.py::GROUPS (commit 3a70f0e), with the
# ring kernels of the training step added
GROUPS = (("K1 copy_into", ("::copy_kernel<",)),
          ("K2 flash_attention", ("flash_fwd_kernel", "flash_fwd_wgmma")),
          ("K3 paged_gather", ("paged_gather_kernel",)),
          ("K4-K6 ring collectives", ("ring_", "reduce_scatter",
                                      "all_gather", "allgather")),
          ("matmul", ("nvjet", "gemm", "xmma", "cutlass", "splitk")),
          ("memcpy/memset (pool clones)", ("memcpy", "memset")),
          ("torch copy/cat", ("direct_copy_kernel", "catarray")))


def group(name: str) -> str:
    low = name.lower()
    for g, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return g
    return "other"


def _is_annotation(evt) -> bool:
    return (evt.name.startswith(("perfbench.", "ProfilerStep"))
            or getattr(evt, "is_user_annotation", False))


class Slice:
    """What one profiled slice of the window holds."""

    def __init__(self, prof, wall_s: float):
        from torch.autograd import DeviceType
        self.wall_s = wall_s
        self.device_ops = []        # (start_us, end_us, name)
        self.host_ranges = []       # (start_us, end_us, name)
        self.range_device_us = defaultdict(float)
        self.gpu_range_us = defaultdict(float)
        for evt in prof.events():
            tr = evt.time_range
            if evt.device_type == DeviceType.CUDA:
                if _is_annotation(evt):
                    self.gpu_range_us[evt.name] += tr.end - tr.start
                else:
                    self.device_ops.append((tr.start, tr.end, evt.name))
            elif evt.name.startswith("perfbench."):
                self.host_ranges.append((tr.start, tr.end, evt.name))
                self.range_device_us[evt.name] += evt.device_time_total
        self.device_ops.sort()
        self._union = self._merge([(s, e) for s, e, _ in self.device_ops])

    @staticmethod
    def _merge(spans):
        out = []
        for s, e in sorted(spans):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._union) / 1e6

    def kernel_s(self, substr: str) -> float:
        """Device seconds of every operation whose name holds ``substr``."""
        return sum(e - s for s, e, n in self.device_ops if substr in n) / 1e6

    def range_device_s(self, name: str) -> float:
        """Device seconds of the operations launched under the host range
        ``name``; where the profiler links none to it, the device-side
        spans of that range."""
        us = self.range_device_us.get(name, 0.0) or \
            self.gpu_range_us.get(name, 0.0)
        return us / 1e6

    def groups(self) -> list:
        acc = defaultdict(float)
        for s, e, n in self.device_ops:
            acc[group(n)] += (e - s) / 1e6
        return sorted(([g, v] for g, v in acc.items()), key=lambda x: -x[1])

    def idle_gaps(self) -> list:
        """Idle device time inside the slice summed by the innermost host
        range that covered each gap's midpoint ("between steps" where none
        did)."""
        ranges = sorted(self.host_ranges)
        acc = defaultdict(float)
        active, i = [], 0
        for (_, a), (b, _) in zip(self._union, self._union[1:]):
            mid = (a + b) / 2               # the gaps come in time order
            while i < len(ranges) and ranges[i][0] <= mid:
                active.append(ranges[i])
                i += 1
            active = [r for r in active if r[1] >= mid]
            best = min(active, key=lambda r: r[1] - r[0], default=None)
            acc["between steps" if best is None
                else best[2].removeprefix("perfbench.")] += (b - a) / 1e6
        return sorted(([n, v] for n, v in acc.items()), key=lambda x: -x[1])
