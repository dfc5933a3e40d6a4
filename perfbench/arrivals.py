"""The one traffic generator.  A mix is a JSON file of parameters under
``perfbench/traffic/``; this module turns it and a seed into requests.

Parameters a mix may set (lengths in tokens, times in seconds):

- ``arrivals``: ``"backlog"`` (a queue that never empties: the harness
  keeps ``backlog_per_slot`` x slots requests waiting) or ``"poisson"``
  (an open loop at ``rate`` requests a second, due times on the host clock
  from the window's open: the gaps between arrivals are the exponential
  distribution's quantiles in bit-reversed order, the same for every
  seed);
- ``prompt``: ``{"dist": "lognormal", "median", "sigma", "min", "max"}``;
- ``output``: ``{"dist": "uniform", "min", "max"}`` or ``{"dist":
  "fixed", "value"}``;
- ``trace_seconds``: how long before the close a traced run starts its
  profiler (8 unless set).

A backlog's set-up fills its slots with requests that keep a share of
their drawn output (:meth:`Traffic.residual`): the k-th of n slots filled
at once keeps (k + 0.5) / n of it, so the lengths still to decode are
spread as in a batch that has been serving for a while.

Sizes are the same for every seed, in the same order: ``POOL``
quantiles of each distribution, the outputs taken in
bit-reversed order and the prompts at a golden-ratio stride, so that
every stretch of requests holds an even spread of both.  A window of a
few tens of requests then holds the same work whatever the seed, which
changes the content: the prompt tokens (numpy's ``PCG64``, as
``serve/frontend/traffic.py`` draws them) and, in the runner, the
weights.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

POOL = 256          # sizes a mix cycles through (a power of two)


@dataclasses.dataclass(frozen=True)
class Arrival:
    idx: int
    tokens: np.ndarray      # (1, S) int32
    max_new: int

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[1])


def _bitrev(k: int, bits: int) -> int:
    return int(format(k, f"0{bits}b")[::-1], 2) if bits else 0


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def prompt_sizes(spec: dict, n: int) -> np.ndarray:
    """``n`` prompt lengths at the distribution's quantiles."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown prompt distribution {spec['dist']!r}")
    z = np.asarray([NormalDist().inv_cdf(q) for q in _quantiles(n)])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    lo, hi = spec.get("min", 1), spec.get("max", math.inf)
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def output_sizes(spec: dict, n: int) -> np.ndarray:
    if spec["dist"] == "uniform":
        x = spec["min"] + (spec["max"] - spec["min"]) * _quantiles(n)
        return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)
    if spec["dist"] == "fixed":
        return np.full(n, spec["value"], np.int64)
    raise ValueError(f"unknown output distribution {spec['dist']!r}")


def max_prompt(mix: dict) -> int:
    return int(mix["prompt"]["max"])


def max_output(mix: dict) -> int:
    o = mix["output"]
    return int(o["value"] if o["dist"] == "fixed" else o["max"])


class Traffic:
    """Request ``i`` of a (mix, seed, vocab) is always the same."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        n = POOL
        prompts = prompt_sizes(mix["prompt"], n)
        outs = output_sizes(mix["output"], n)
        bits = n.bit_length() - 1
        stride = int(round(n * 0.6180339887)) | 1      # odd: visits all
        self._sizes = []
        for k in range(n):
            rev = _bitrev(k, bits)
            self._sizes.append((int(prompts[(k * stride) % n]),
                                int(outs[rev])))
        self._due = None
        if mix["arrivals"] == "poisson":
            m = 1 << 12
            q = -np.log1p(-_quantiles(m)) / float(mix["rate"])
            gaps = q[[_bitrev(k, 12) for k in range(m)]]
            self._due = np.concatenate([[0.0], np.cumsum(gaps)])
        elif mix["arrivals"] != "backlog":
            raise ValueError(f"unknown arrivals {mix['arrivals']!r}")

    def sizes(self, i: int) -> tuple:
        """(prompt_len, max_new) of request ``i``."""
        return self._sizes[i % len(self._sizes)]

    def due(self, i: int) -> float:
        """Seconds after the window opens at which request ``i`` is due
        (0 for a backlog)."""
        return 0.0 if self._due is None else float(self._due[i])

    @staticmethod
    def residual(a: Arrival, k: int, n: int) -> Arrival:
        """Request ``a`` as the k-th of n slots filled at once."""
        return dataclasses.replace(
            a, max_new=max(1, round((k + 0.5) / n * a.max_new)))

    def get(self, i: int) -> Arrival:
        S, max_new = self.sizes(i)
        rng = np.random.default_rng(np.random.PCG64([self.seed, 1, i]))
        tokens = rng.integers(0, self.vocab, (1, S), dtype=np.int64)
        return Arrival(i, tokens.astype(np.int32), int(max_new))
