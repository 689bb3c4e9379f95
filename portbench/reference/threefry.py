"""Threefry-2x32 and the key, plan and noise streams derived from it, in
plain PyTorch: a frozen copy that the benchmark's reference owns.

Every uint32 word is held in int64 and masked to 32 bits after each add
and shift. The streams:

* keys: ``PRNGKey(s) = (0, s)``, ``fold_in(key, d) = threefry(key, (0,
  d))``, ``split(key, n)[i] = threefry(key, (0, i))``;
* ``bits(key, shape)[i] = x0 ^ x1`` of ``threefry(key, (0, i))``, and
  ``uniform`` its 23-bit mantissa transform (the binarization mask);
* ``permutation``: ``ceil(3 ln n / ln(2^32 - 1))`` rounds of a stable sort
  by fresh ``bits``, and the epoch batch plan built from it;
* the head's noise: one counter ``((row << 16) | col, salt)`` an element,
  Gumbel from ``x0`` and Box-Muller normals from ``(x0, x1)``, each word's
  top 24 bits as a uniform clamped off 0.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
SALT_GUMBEL = 0x47554D42
SALT_NORMAL = 0x4E4F524D
_ROTS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U24 = 1.0 / (1 << 24)

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """20 rounds over words held in int64 tensors or Python ints."""
    x0 = (c0 + k0) & MASK32
    x1 = (c1 + k1) & MASK32
    ks = (k1, k0 ^ k1 ^ 0x1BD11BDA, k0)
    for i in range(5):
        for r in _ROTS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[i % 3]) & MASK32
        x1 = (x1 + ks[(i + 1) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int) -> Key:
    return 0, seed & MASK32


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key[0], key[1], 0, data & MASK32)


def split(key: Key, n: int = 2) -> List[Key]:
    return [threefry2x32(key[0], key[1], 0, i) for i in range(n)]


def bits(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    c1 = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key[0], key[1], torch.zeros_like(c1), c1)
    return (x0 ^ x1).reshape(tuple(shape))


def uniform01(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    w = (bits(key, shape, device) >> 9) | 0x3F800000
    return w.to(torch.int32).view(torch.float32) - 1.0


def permutation(key: Key, n: int, device=None) -> torch.Tensor:
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK32))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.sort(bits(sub, (n,), device), stable=True).indices]
    return x


def batch_rows(key: Key, n_data: int, batch: int, steps: Sequence[int],
               device=None) -> torch.Tensor:
    """``[len(steps), batch]`` rows of the epoch plan: epoch ``e`` is the
    first ``(n_data // batch) * batch`` entries of ``permutation(fold_in(
    key, e), n_data)``, one batch a step in order."""
    per_epoch = max(1, n_data // batch)
    out, perms = [], {}
    for s in steps:
        e, j = divmod(int(s), per_epoch)
        if e not in perms:
            perms[e] = permutation(fold_in(key, e), n_data, device)
        out.append(perms[e][j * batch:(j + 1) * batch])
    return torch.stack(out)


def _uniform24(words: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min((words >> 8).to(torch.float32) * _U24, _U24)


def head_noise(key: Key, b: int, k: int, d: int, row0: int = 0,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gumbel ``[b, k]`` and standard normal ``[b, d]`` for rows
    ``row0 .. row0 + b - 1`` of a head call under ``key``."""
    def grid(n, salt):
        rows = torch.arange(b, dtype=torch.int64, device=device)[:, None]
        cols = torch.arange(n, dtype=torch.int64, device=device)[None, :]
        c0 = ((rows + row0) << 16) | cols
        return threefry2x32(key[0], key[1], c0, torch.full_like(c0, salt))
    x0, _ = grid(k, SALT_GUMBEL)
    g = -torch.log(-torch.log(_uniform24(x0)))
    x0, x1 = grid(d, SALT_NORMAL)
    eps = (torch.sqrt(-2.0 * torch.log(_uniform24(x0)))
           * torch.cos(2.0 * math.pi * _uniform24(x1)))
    return g, eps


def temperature(step: int, tau0: float, tau_min: float,
                rate: float) -> float:
    """``max(tau_min, tau0 * exp(-rate * step))`` rounded as float32."""
    t = np.float32(tau0) * np.exp(np.float32(-rate) * np.float32(step),
                                  dtype=np.float32)
    return float(max(np.float32(t), np.float32(tau_min)))
