"""The head kernels' work from their shapes, and the least time an H100
could take for it: a frozen copy of the port's formulas, owned by the
benchmark so that a change to the program cannot change the yardstick.

Bytes: each input read once, each output written once. Operations: the
function's float32 work, exp and log counted as one, the integer threefry
not counted. Peaks: one H100 SXM at its 700 W limit, NVIDIA's data sheet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

PEAK_BYTES = 3.35e12        # device memory, bytes/s
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12    # dense bf16 on the tensor cores


class Work(NamedTuple):
    bytes: int
    flops: int


def head_fwd_work(b: int, k: int, d: int, streamed: bool) -> Work:
    """The head forward at (B, K, D): the head's inputs (and the noise,
    when streamed) read; z, y and the packed per-row scalars written."""
    floats = (b * k + 2 * b * k * d + k + 2 * k * d
              + b * d + b * k + 8 * b)
    if streamed:
        floats += b * k + b * d
    return Work(4 * floats, b * (22 * k * d + 14 * d + 25 * k))


def head_bwd_work(b: int, k: int, d: int, streamed: bool) -> Work:
    """The head backward at (B, K, D): the head's inputs and the three
    cotangents read, the six gradients written; the forward's
    recomputation, the VJP and the batch sum."""
    floats = (b * k + 2 * b * k * d + k + 2 * k * d
              + b * d + b * k + 8 * b
              + b * k + 2 * b * k * d + k + 2 * k * d)
    if streamed:
        floats += b * k + b * d
    flops = b * (52 * k * d + 40 * d + 55 * k) + b * (k + 2 * k * d)
    return Work(4 * floats, flops)


def bound_ms(work: Work) -> Tuple[float, str]:
    """(ms, 'bytes' or 'operations'): the larger of the bytes at the
    memory rate and the operations at the float32 peak."""
    t_bytes = work.bytes / PEAK_BYTES
    t_ops = work.flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            'bytes' if t_bytes >= t_ops else 'operations')
