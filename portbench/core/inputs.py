"""Images from the seed, made on the device in a few large calls.

Each image is its own smooth random field (a grid 8x coarser than the
image, uniform, upsampled bilinearly) under its own contrast and offset,
plus fine uniform noise, rounded to uint8: images that differ from one
another as a data set's do, so per-image losses and cluster logits
spread. The work a step or request does does not depend on the values.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 8192     # images made per call


def images_u8(n: int, shape, seed: int, device) -> np.ndarray:
    """``[n, H, W, C]`` uint8 on the host, the same for the same seed."""
    h, w, c = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n, h, w, c), dtype=torch.uint8)
    for i in range(0, n, BLOCK):
        m = min(BLOCK, n - i)
        coarse = torch.rand(m, c, max(1, h // 8), max(1, w // 8),
                            generator=gen, device=device)
        field = F.interpolate(coarse, size=(h, w), mode='bilinear',
                              align_corners=False).permute(0, 2, 3, 1)
        contrast = 0.2 + 0.8 * torch.rand(m, 1, 1, 1, generator=gen,
                                          device=device)
        offset = (1.0 - contrast) * torch.rand(m, 1, 1, 1, generator=gen,
                                               device=device)
        noise = torch.rand(m, h, w, c, generator=gen, device=device) - 0.5
        x = offset + contrast * field + 0.1 * noise
        out[i:i + m].copy_(torch.round(x.clamp(0.0, 1.0) * 255.0).to(
            torch.uint8))
    return out.numpy()
