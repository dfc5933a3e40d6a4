"""Scoped wall-clock profiler: measured time for the serving hot paths.

Counterpart of ``repro/obs/prof.py``.

Every other clock in this codebase is *deterministic*: the span tracer's
:class:`~repro_torch.obs.tracer.StepClock` ticks ``step*1000 + seq`` and the
telemetry comm clock is priced by the analytic cost model.  That determinism
is load-bearing (bitwise traces, replayable audits) — but it also means no
headline number is ever *measured*.  This module adds the missing instrument
without touching the deterministic side:

- :class:`ProfClock` is the ONE ``time.perf_counter`` wrapper in the stack.
  Its values never reach a trace ``ts`` field, a scheduler decision, or the
  modeled comm clock; they live only in :class:`ProfSample` records and in
  ``source="wallclock"`` telemetry buckets (``repro_torch.tune.telemetry`` keeps
  per-provenance bucket maps precisely so the two streams cannot mix).
- :class:`Profiler` hands out scopes that time the *actual execution* of a
  region — serve decode steps, paged-attention kernels, prefill chunks,
  migration flush slices.  The scope object is callable: ``ps(x)``
  synchronizes the CUDA device of every tensor in ``x`` (any nesting of
  tuples, lists and dicts), so a region is timed to the end of its kernels
  and not to their launch; on CPU tensors it is the identity, since CPU
  work has finished when the call returns.
- Each closed scope pairs the measured wall seconds with the analytic
  model's opinion of the same interval: the delta of the sink's model-stream
  time across the scope (exactly the ops the model priced inside it).  The
  pairs feed ``repro_torch.obs.calibrate`` — the measured-vs-modeled divergence
  report — and the wallclock telemetry records feed
  ``tune.estimator.build_table(sample_source="wallclock")`` so the online
  refitter can hot-swap a genuinely measured table mid-run.

Profiling off is the shared :data:`NULL_PROF` (or an unset ``ctx.prof``):
scopes are no-ops, ``ps(x)`` is identity, nothing is recorded, and every
deterministic output stays bitwise-identical.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional

import torch

from repro_torch.tune import telemetry as telemetry_mod


def _devices(x, out: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _devices(v, out)
    return out


def block_until_ready(x):
    """Synchronize every CUDA device holding a tensor of ``x`` and return
    ``x``: the counterpart of ``jax.block_until_ready``.  CPU tensors and
    other values need no wait."""
    for device in sorted(_devices(x, set()), key=str):
        torch.cuda.synchronize(device)
    return x


class ProfClock:
    """The stack's only wall-clock source (``time.perf_counter``).

    Kept as a class (rather than bare calls) so tests can substitute a fake
    and so the segregation rule is auditable: grep for ``perf_counter`` and
    this is the single non-benchmark site."""

    def now(self) -> float:
        return time.perf_counter()


@dataclasses.dataclass
class ProfSample:
    """One measured region: what ran, how big it was, what it cost.

    ``step`` is the deterministic fleet/scheduler step the sample was taken
    at (for joining against step-clocked traces); ``wall_s`` is measured
    wall time; ``model_s`` is what the analytic model priced *inside* the
    scope (0.0 = the model does not price this region at all — honest
    coverage signal, not an error)."""
    op: str
    nbytes: int
    path: str
    tier: str
    work_items: int
    step: int
    wall_s: float
    model_s: float

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "ProfSample":
        return cls(op=str(obj["op"]), nbytes=int(obj["nbytes"]),
                   path=str(obj["path"]), tier=str(obj["tier"]),
                   work_items=int(obj["work_items"]), step=int(obj["step"]),
                   wall_s=float(obj["wall_s"]), model_s=float(obj["model_s"]))


class _NullScope:
    """Scope used when profiling is off: enter/exit no-ops, identity call."""
    __slots__ = ()

    def __enter__(self) -> "_NullScope":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, x):
        return x


_NULL_SCOPE = _NullScope()


class _Scope:
    """One timed region.  ``with prof.scope(...) as ps: out = ps(fn())``."""
    __slots__ = ("prof", "op", "nbytes", "path", "tier", "work_items",
                 "_t0", "_m0")

    def __init__(self, prof: "Profiler", op: str, nbytes: int, path: str,
                 tier: str, work_items: int):
        self.prof = prof
        self.op = op
        self.nbytes = int(nbytes)
        self.path = path
        self.tier = tier
        self.work_items = int(work_items)

    def __enter__(self) -> "_Scope":
        self._m0 = self.prof._model_time()
        self._t0 = self.prof.clock.now()
        return self

    def __call__(self, x):
        """Wait for the CUDA work behind ``x`` (tensors in any nesting) so
        the timed region covers execution, not launch; returns ``x``
        unchanged."""
        return block_until_ready(x)

    def __exit__(self, exc_type, exc, tb) -> bool:
        wall = self.prof.clock.now() - self._t0
        if exc_type is None:
            self.prof._close(self, wall,
                             self.prof._model_time() - self._m0)
        return False


class Profiler:
    """Scoped wall-clock profiler a driver attaches to a context.

    Mirrors the tracer's lifecycle: ``attach(ctx)`` installs it as
    ``ctx.prof``; instrumented hot paths fetch it with ``getattr`` and guard
    on ``enabled``, so an unattached/disabled run pays one attribute check.
    ``set_step`` mirrors ``StepClock.set_step`` (monotonic max) so samples
    carry the deterministic step they were measured at."""

    enabled = True

    def __init__(self, *, clock: Optional[ProfClock] = None,
                 max_samples: int = 65536,
                 sink_records: bool = True):
        self.clock = clock or ProfClock()
        self.max_samples = max_samples
        self.sink_records = sink_records
        self.samples: List[ProfSample] = []
        self.dropped = 0
        self.step = 0
        self.ctx = None

    # ------------------------------------------------------------ lifecycle
    def attach(self, ctx) -> "Profiler":
        self.ctx = ctx
        ctx.prof = self
        return self

    def set_step(self, step: int) -> None:
        if step > self.step:
            self.step = int(step)

    # -------------------------------------------------------------- scoping
    def scope(self, op: str, *, nbytes: int, path: str = "engine",
              tier: str = "local", work_items: int = 1) -> _Scope:
        return _Scope(self, op, nbytes, path, tier, work_items)

    # ------------------------------------------------------------- plumbing
    def _model_time(self) -> float:
        """The model stream's accumulated seconds (for pairing a scope with
        the analytic pricing of the ops recorded inside it)."""
        ctx = self.ctx
        if ctx is None:
            return 0.0
        tel = getattr(ctx, "telemetry", None)
        if tel is None:
            return 0.0
        total = getattr(tel, "total_time", None)
        return float(total()) if total is not None else 0.0

    def _close(self, sc: _Scope, wall_s: float, model_s: float) -> None:
        self.samples.append(ProfSample(
            op=sc.op, nbytes=sc.nbytes, path=sc.path, tier=sc.tier,
            work_items=sc.work_items, step=self.step,
            wall_s=wall_s, model_s=max(0.0, model_s)))
        if len(self.samples) >= self.max_samples:
            # decimate, keep spread — same policy as StatBucket reservoirs
            self.dropped += len(self.samples) - len(self.samples[::2])
            self.samples = self.samples[::2]
        if self.sink_records and self.ctx is not None:
            self.ctx.telemetry.record(telemetry_mod.OpRecord(
                sc.op, sc.nbytes, sc.path, sc.tier, wall_s,
                sc.work_items, telemetry_mod.WALLCLOCK_SOURCE))

    # -------------------------------------------------------------- queries
    def total_wall(self) -> float:
        return sum(s.wall_s for s in self.samples)

    def summary(self) -> dict:
        return {
            "samples": len(self.samples),
            "dropped": self.dropped,
            "wall_s": self.total_wall(),
            "model_s": sum(s.model_s for s in self.samples),
            "ops": sorted({s.op for s in self.samples}),
        }

    # ------------------------------------------------------------- persist
    def save(self, path: str) -> dict:
        doc = {"schema_version": 1,
               "samples": [s.to_json() for s in self.samples]}
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        return doc


class _NullProf(Profiler):
    """Profiling off: scope() hands back the shared no-op scope."""

    enabled = False

    def __init__(self):
        super().__init__(sink_records=False)

    def attach(self, ctx) -> "Profiler":      # pragma: no cover — guard only
        raise RuntimeError("NULL_PROF must not be attached; leave ctx.prof "
                           "unset for profiling-off")

    def scope(self, op: str, *, nbytes: int, path: str = "engine",
              tier: str = "local", work_items: int = 1):
        return _NULL_SCOPE

    def set_step(self, step: int) -> None:
        pass


NULL_PROF = _NullProf()


def load_samples(path: str) -> List[ProfSample]:
    """Rehydrate a saved sample file (the calibration CLI input)."""
    with open(path) as f:
        doc = json.load(f)
    rows = doc["samples"] if isinstance(doc, dict) else doc
    return [ProfSample.from_json(r) for r in rows]
