"""Threefry-2x32 counter-based PRNG in plain torch (the host replay).

The port of ``gmvae_tpu/ops/kernels/threefry.py``: the generator
jax.random uses, with the same per-element counter layout, so a key and a
(row, col) grid give the same bits here, inside the CUDA head kernel
(``gmvae_tpu_torch/csrc/threefry.cuh``) and in the JAX package.

torch has no full unsigned 32-bit arithmetic, so every uint32 word is held
in int64 and masked back to 32 bits after each add and shift. The same
function takes Python ints (key derivation in ``prng.py``) or int64 tensors
(noise grids and binarization masks).

Counter layout: one (c0, c1) pair per element, ``c0 = (row << 16) | col``,
``c1 = salt``; unique for row, col < 2^16. Uniforms use x0, Box-Muller
normals use (x0, x1).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from gmvae_tpu_torch.ops.kernels import _build

MASK32 = 0xFFFFFFFF
_U24 = 1.0 / (1 << 24)
_TWO_PI = 2.0 * math.pi

SALT_GUMBEL = 0x47554D42   # 'GUMB'
SALT_NORMAL = 0x4E4F524D   # 'NORM'

_ROTS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """20-round threefry-2x32 over uint32 words held in int64 (or ints).

    Arguments broadcast; returns ``(x0, x1)`` in ``[0, 2^32)``.
    """
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


def bits_to_uniform_i32(i24: torch.Tensor) -> torch.Tensor:
    """Integers in [0, 2^24) -> float32 uniforms in (0, 1), clamped off 0."""
    u = i24.to(torch.float32) * _U24
    return torch.clamp_min(u, _U24)


def _element_counters(rows: torch.Tensor, cols: torch.Tensor, salt: int):
    c0 = (rows.to(torch.int64) << 16) | cols.to(torch.int64)
    return c0, torch.full_like(c0, salt)


def gumbel_from_grid(k0: int, k1: int, rows: torch.Tensor,
                     cols: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel(0,1) noise, one draw per (row, col) element."""
    x0, _ = threefry2x32(k0, k1, *_element_counters(rows, cols, SALT_GUMBEL))
    u = bits_to_uniform_i32(x0 >> 8)
    return -torch.log(-torch.log(u))


def normal_from_grid(k0: int, k1: int, rows: torch.Tensor,
                     cols: torch.Tensor) -> torch.Tensor:
    """Standard normal noise via Box-Muller from both words of a counter."""
    x0, x1 = threefry2x32(k0, k1,
                          *_element_counters(rows, cols, SALT_NORMAL))
    u1 = bits_to_uniform_i32(x0 >> 8)
    u2 = bits_to_uniform_i32(x1 >> 8)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)


def host_grid(b: int, n: int, row0: int = 0, device=None):
    """(rows, cols) index grids of shape [b, n], matching the kernel's
    numbering of rows within a call."""
    rows = torch.arange(b, dtype=torch.int64, device=device)[:, None] + row0
    cols = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    return rows.expand(b, n), cols.expand(b, n)


def replay_noise(key_u32: Sequence[int], b: int, k: int, d: int,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head kernels' threefry noise, regenerated in plain torch:
    Gumbel ``g [B,K]`` and normal ``eps [B,D]``. ``key_u32``: a ``(k0,
    k1)`` pair or its words in an int32 tensor."""
    k0, k1 = (int(w) & MASK32 for w in key_u32)
    g = gumbel_from_grid(k0, k1, *host_grid(b, k, device=device))
    eps = normal_from_grid(k0, k1, *host_grid(b, d, device=device))
    return g, eps


def threefry2x32_grid(k0: int, k1: int, c0: torch.Tensor,
                      c1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw words ``(x0, x1)`` for explicit counter arrays: the device
    generator of ``csrc/threefry.cuh`` for CUDA tensors (a check of it, not
    a model path), ``threefry2x32`` for CPU tensors. Counters are int64
    holding uint32 values; so are the results."""
    if c0.shape != c1.shape:
        raise ValueError(f'counter shapes differ: {c0.shape} vs {c1.shape}')
    if c0.device.type == 'cpu':
        return threefry2x32(k0, k1, c0.to(torch.int64), c1.to(torch.int64))
    if c0.device.type != 'cuda':
        raise ValueError(f'threefry2x32_grid: unsupported device {c0.device}')
    # uint32 bit patterns travel as int32 (same bytes)
    as_i32 = lambda t: t.to(torch.int64).to(torch.int32).contiguous()  # noqa: E731
    c0w, c1w = as_i32(c0 & MASK32), as_i32(c1 & MASK32)
    x0 = torch.empty_like(c0w)
    x1 = torch.empty_like(c0w)
    lib = _build.library()
    with torch.cuda.device(c0.device):
        rc = lib.gmvae_threefry_grid(
            k0 & MASK32, k1 & MASK32, c0w.data_ptr(), c1w.data_ptr(),
            x0.data_ptr(), x1.data_ptr(), c0w.numel(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, 'threefry_grid launch')
    _build.LAUNCHES['threefry_grid'] += 1
    return x0.to(torch.int64) & MASK32, x1.to(torch.int64) & MASK32
