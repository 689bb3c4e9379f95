"""Batch preprocessing and the batch plan: the port of
``gmvae_tpu/data/preprocess.py``'s normalize, dynamic binarization,
``epoch_keys``, ``epoch_batch_indices`` and the packed-row pair
``pack_rows``/``unpack_rows``.

The binarization mask comes from ``prng.uniform`` on the batch's device and
the plan's permutations from ``prng.permutation``, so a key gives the same
mask and the same batch order as the reference. Nothing on the training
path packs rows: ``tools/bench_gather.py`` measures gathers of packed rows
against gathers of the bytes themselves.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from gmvae_tpu_torch import prng


def packed_width(image_shape) -> int:
    """int32 words per packed row: ceil(prod(shape) / 4)."""
    return -(-math.prod(image_shape) // 4)


def pack_rows(x_uint8: np.ndarray) -> np.ndarray:
    """[N, *shape] uint8 -> [N, ceil(P/4)] int32 on the host: 4 bytes a
    word, little-endian, the tail zero-padded. ``unpack_rows`` restores
    the same bytes."""
    n = x_uint8.shape[0]
    flat = np.ascontiguousarray(x_uint8.reshape(n, -1))
    pad = (-flat.shape[1]) % 4
    if pad:
        flat = np.pad(flat, ((0, 0), (0, pad)))
    # explicit little-endian: unpack_rows shifts by 0, 8, 16, 24
    return flat.view('<i4')


def unpack_rows(w: torch.Tensor, image_shape) -> torch.Tensor:
    """int32 [..., W] packed rows -> uint8 [..., *shape], on ``w``'s
    device: the exact inverse of ``pack_rows``."""
    p = math.prod(image_shape)
    shifts = torch.arange(0, 32, 8, dtype=torch.int32, device=w.device)
    # the arithmetic shift's sign bits fall outside the 0xFF mask
    b = ((w[..., None] >> shifts) & 0xFF).to(torch.uint8)
    b = b.reshape(*w.shape[:-1], w.shape[-1] * 4)
    return b[..., :p].reshape(*w.shape[:-1], *image_shape)


def normalize_image(x_uint8: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1], into ``out`` where given."""
    return torch.mul(x_uint8.to(torch.float32), 1.0 / 255.0, out=out)


def dynamic_binarize(key: prng.Key, x01: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bernoulli-resample pixels with p = intensity, one fresh mask per
    key; into ``out`` where given (it may be ``x01``)."""
    u = prng.uniform(key, x01.shape, device=x01.device)
    if out is None:
        return (u < x01).to(x01.dtype)
    return out.copy_(u < x01)


def preprocess_batch(key: prng.Key, x_uint8: torch.Tensor, binarize: bool,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalize, then binarize when the config asks for it; into ``out``
    (float32, the batch's shape) where given."""
    x = normalize_image(x_uint8, out)
    if binarize:
        x = dynamic_binarize(key, x, out)
    return x


def epoch_keys(key: prng.Key, e0: int, n_ep: int) -> List[prng.Key]:
    """``split(key, e0 + n_ep)[e0:]``: element i of a split is
    ``threefry2x32(key, (0, i))`` whatever the split's length."""
    return [prng.fold_in(key, e) for e in range(e0, e0 + n_ep)]


def epoch_batch_indices(key: prng.Key, n_data: int, batch_size: int,
                        n_steps: int, start_step: int = 0,
                        device=None) -> torch.Tensor:
    """``[n_steps, batch_size]`` int64 batch indices for steps
    ``[start_step, start_step + n_steps)``: a fresh permutation per epoch
    (``n_data // batch_size`` steps), the remainder of each dropped. Epoch
    ``e``'s permutation depends on ``(key, e)`` alone, so any window of
    the plan equals the same rows of a longer one. The window materializes
    ``cdiv(n_steps, steps_per_epoch) + 1`` epochs, as the reference does."""
    if batch_size > n_data:
        raise ValueError(
            f'batch_size {batch_size} exceeds the dataset ({n_data} '
            f'examples): drop-last epoch batching cannot form one batch')
    steps_per_epoch = max(1, n_data // batch_size)
    e0 = start_step // steps_per_epoch
    n_ep = -(-n_steps // steps_per_epoch) + 1
    perms = [prng.permutation(k, n_data, device)[:steps_per_epoch * batch_size]
             for k in epoch_keys(key, e0, n_ep)]
    idx = torch.cat(perms).reshape(n_ep * steps_per_epoch, batch_size)
    off = start_step - e0 * steps_per_epoch
    return idx[off:off + n_steps]
