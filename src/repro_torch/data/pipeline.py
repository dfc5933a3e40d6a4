"""Synthetic deterministic LM data pipeline (counterpart of
``repro/data/pipeline.py``).

An endless stream of (tokens, labels) batches from a counter-seeded PRNG,
identical across hosts for a given (seed, step), sharded by slicing the
global batch, with a Zipf-ish marginal over the vocabulary so that the
loss curve is non-trivial.

The reference draws with ``jax.random`` (threefry2x32 keys, ``fold_in``,
``uniform``, ``normal``).  This module carries its own numpy threefry2x32
and reproduces those draws without importing jax: tokens and labels are
bitwise the reference's, and ``frontend``'s normals go through the same
float32 ``erfinv`` polynomial (they differ where ``log1p`` rounds
differently, by under 1e-6).
The bit layout is the one of ``jax_threefry_partitionable=True``, jax's
default since 0.5: element ``i`` of a draw hashes the counter pair
``(i >> 32, i & 0xffffffff)`` and keeps the XOR of the two output words.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import _devices

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as
    ``jax.random``'s ``threefry2x32_p``: ``key`` two uint32 words,
    ``x0``/``x1`` uint32 counter arrays; returns the two output arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s two words: the seed's high 32 bits (0
    for a 32-bit seed) and its low 32 bits."""
    seed = int(seed)
    hi = (seed >> 32) & 0xFFFFFFFF if seed >= 0 else 0
    return np.array([hi, seed & 0xFFFFFFFF], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: threefry of the counter pair (0, data)."""
    out = threefry2x32(k, np.zeros(1, np.uint32),
                       np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([out[0][0], out[1][0]], np.uint32)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits`` at 32 bits under partitionable threefry."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(k, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(k: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under an
    exponent of 1.0, minus 1, scaled, floored at ``minval``."""
    bits = random_bits(k, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


# Giles' single-precision erfinv, the polynomial XLA evaluates for f32
_ERFINV_W_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                          -4.39150654e-06, 0.00021858087, -0.00125372503,
                          -0.00417768164, 0.246640727, 1.50140941],
                         np.float32)
_ERFINV_W_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                          -0.00367342844, 0.00573950773, -0.0076224613,
                          0.00943887047, 1.00167406, 2.83297682], np.float32)


def erfinv32(x: np.ndarray) -> np.ndarray:
    """float32 erfinv by Giles' approximation, as XLA computes it.  Only
    ``log1p`` may round differently from XLA's: a few ulps at most."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3))
    p = np.where(lt, _ERFINV_W_LT5[0], _ERFINV_W_GE5[0])
    for i in range(1, len(_ERFINV_W_LT5)):
        p = np.where(lt, _ERFINV_W_LT5[i], _ERFINV_W_GE5[i]) + p * w
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, p * x)


def normal(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal`` in float32: sqrt(2) * erfinv(u) for u uniform
    on [nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = uniform(k, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv32(u)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def _zipf_cdf(cfg: DataConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    w = ranks ** (-cfg.zipf_a)
    return np.cumsum(w / w.sum())


class TokenStream:
    """Deterministic, restartable, shardable token stream.  Batches are
    int64 tensors on ``device`` (the current CUDA device unless given;
    ``torch`` indexes with int64); their values equal the reference's int32
    batches."""

    def __init__(self, cfg: DataConfig, *, device=None):
        self.cfg = cfg
        self.device = _devices.resolve(device)
        self._cdf = _zipf_cdf(cfg).astype(np.float32)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def batch(self, step: int, *, host_index: int = 0, num_hosts: int = 1):
        """Global batch for ``step``; slice [host_index] of num_hosts."""
        cfg = self.cfg
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        per = cfg.global_batch // num_hosts
        k = fold_in(fold_in(key(cfg.seed), step), host_index)
        u = uniform(k, (per, cfg.seq_len + 1))
        toks = np.searchsorted(self._cdf, u).astype(np.int64)
        toks = np.clip(toks, 0, cfg.vocab_size - 1)
        # order-2 structure: every even position repeats its left neighbor
        # with prob ~1/2 so next-token prediction is learnable
        idx = np.arange(cfg.seq_len + 1)
        toks = np.where((idx % 2 == 0) & (idx > 0), np.roll(toks, 1, axis=1),
                        toks)
        return {"tokens": self._put(toks[:, :-1]),
                "labels": self._put(toks[:, 1:])}

    def frontend(self, step: int, cfg_arch, batch_size: int):
        """Stubbed modality embeddings for audio/vlm archs (deterministic,
        f32)."""
        k = fold_in(key(self.cfg.seed + 7), step)
        out = {}
        if cfg_arch.family == "audio":
            out["audio_embeds"] = self._put(normal(
                k, (batch_size, cfg_arch.encoder_seq, cfg_arch.d_model))
                * np.float32(0.1))
        if cfg_arch.family == "vlm":
            out["image_embeds"] = self._put(normal(
                k, (batch_size, cfg_arch.image_tokens, cfg_arch.d_model))
                * np.float32(0.1))
        return out
