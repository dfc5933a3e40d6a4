"""Open-loop traffic engine: reproducible multi-tenant arrival schedules.

A copy of ``repro/serve/frontend/traffic.py`` (numpy only): the port keeps
its own so that it imports nothing of the JAX package.  The same ``PCG64``
draws, so schedules match the reference's bit for bit.

A *closed-loop* client (submit, wait, submit) can never overload the
system, so it can never measure the thing a cluster frontend exists for —
behavior past saturation.  This engine is open-loop: requests arrive on
their own clock (virtual scheduler steps, no wall time anywhere), whether
or not the fleet has capacity, exactly the methodology serving papers use
to sweep offered load.

Two arrival processes, both driven by one seeded ``numpy`` generator so a
(seed, tenants, rate, steps) tuple always produces the identical schedule:

- **poisson** — i.i.d. per-step arrival counts ``Poisson(rate)``, the
  classic open-loop baseline;
- **bursty**  — a two-state modulated Poisson process: the engine flips
  between a *hot* state (``rate * burst_factor``) and a *cold* state
  (``rate * cold_factor``) with switching probability ``1 / burst_len``
  per step — the "everyone pastes the same stack trace at 9am" shape that
  stresses shed/preempt paths far harder than the same mean rate spread
  evenly.

Each arrival is assigned a tenant by weighted choice; the tenant spec
decides prompt length, decode budget, SLO class, and whether the request
re-uses one of the tenant's *prefix groups* (a fixed prompt submitted with
``prefix_len == S``, the many-samples-one-prompt workload that exercises
shared-prefix block mapping and the router's affinity policy).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's request mix (distributions are finite choice sets so
    the schedule stays readable and the model jit-caches per shape)."""
    name: str
    weight: float = 1.0
    prompt_lens: Tuple[int, ...] = (12,)
    max_new: Tuple[int, ...] = (4,)
    slo: str = "standard"               # deadline class name (slo.CLASSES)
    shared_prefix_prob: float = 0.0     # P(request re-uses a prefix group)
    prefix_groups: int = 1              # distinct shared prompts per tenant


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One scheduled arrival: everything the router/scheduler needs."""
    idx: int                            # schedule-order id
    step: int                           # arrival step (open-loop clock)
    tenant: str
    slo: str
    tokens: np.ndarray                  # (1, S) int32 prompt
    max_new: int
    prefix_len: int                     # 0 = private prompt

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[1])

    def prefix_key(self) -> Optional[tuple]:
        """The scheduler's token-tuple index key (None for private)."""
        if self.prefix_len <= 0:
            return None
        return tuple(int(t) for t in self.tokens[0, :self.prefix_len])


class TrafficEngine:
    """Deterministic open-loop arrival generator over a tenant mix."""

    def __init__(self, tenants: Sequence[TenantSpec], *, rate: float,
                 vocab: int, seed: int = 0, process: str = "poisson",
                 burst_len: int = 8, burst_factor: float = 4.0,
                 cold_factor: float = 0.25):
        if not tenants:
            raise ValueError("need at least one tenant")
        if rate <= 0:
            raise ValueError(f"offered rate must be positive, got {rate}")
        if process not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival process {process!r}")
        self.tenants = list(tenants)
        self.rate = rate
        self.vocab = vocab
        self.seed = seed
        self.process = process
        self.burst_len = max(1, burst_len)
        self.burst_factor = burst_factor
        self.cold_factor = cold_factor
        w = np.asarray([t.weight for t in self.tenants], np.float64)
        self._weights = w / w.sum()
        # prefix-group prompts are part of the schedule's identity: derive
        # them from the same seed, once, so every run (and the router's
        # affinity lookups) sees identical shared prompts
        rng = np.random.default_rng(np.random.PCG64(seed))
        self._group_prompts = {}
        for t in self.tenants:
            S = max(t.prompt_lens)
            for g in range(t.prefix_groups):
                self._group_prompts[(t.name, g)] = rng.integers(
                    0, vocab, (1, S), dtype=np.int64).astype(np.int32)

    def _tokens(self, rng, tenant: TenantSpec):
        """(tokens, prefix_len) for one arrival of this tenant."""
        if (tenant.shared_prefix_prob > 0
                and rng.random() < tenant.shared_prefix_prob):
            g = int(rng.integers(tenant.prefix_groups))
            tokens = self._group_prompts[(tenant.name, g)]
            return tokens, int(tokens.shape[1])     # whole-prompt prefix
        S = int(rng.choice(np.asarray(tenant.prompt_lens)))
        tokens = rng.integers(0, self.vocab, (1, S),
                              dtype=np.int64).astype(np.int32)
        return tokens, 0

    def schedule(self, n_steps: int) -> List[RequestSpec]:
        """The full arrival schedule for ``n_steps`` of open-loop traffic,
        sorted by arrival step.  Re-calling with the same arguments returns
        an identical schedule (fresh generator per call, no shared state)."""
        rng = np.random.default_rng(np.random.PCG64((self.seed, n_steps)))
        specs: List[RequestSpec] = []
        hot = False
        idx = 0
        for step in range(n_steps):
            if self.process == "bursty":
                if rng.random() < 1.0 / self.burst_len:
                    hot = not hot
                lam = self.rate * (self.burst_factor if hot
                                   else self.cold_factor)
            else:
                lam = self.rate
            for _ in range(int(rng.poisson(lam))):
                tenant = self.tenants[int(rng.choice(len(self.tenants),
                                                     p=self._weights))]
                tokens, prefix_len = self._tokens(rng, tenant)
                specs.append(RequestSpec(
                    idx=idx, step=step, tenant=tenant.name, slo=tenant.slo,
                    tokens=tokens,
                    max_new=int(rng.choice(np.asarray(tenant.max_new))),
                    prefix_len=prefix_len))
                idx += 1
        return specs

    def offered_load(self, specs: List[RequestSpec]) -> dict:
        """Summary of a schedule: totals per tenant/class, token volumes."""
        out = {"requests": len(specs), "by_tenant": {}, "by_slo": {},
               "prompt_tokens": sum(s.prompt_len for s in specs),
               "decode_tokens": sum(s.max_new for s in specs),
               "shared_prefix": sum(1 for s in specs if s.prefix_len > 0)}
        for s in specs:
            out["by_tenant"][s.tenant] = out["by_tenant"].get(s.tenant, 0) + 1
            out["by_slo"][s.slo] = out["by_slo"].get(s.slo, 0) + 1
        return out
