"""Lower precisions for the control: the reference with every input and
weight of a conv or dense layer rounded to them, and the gradient that
flows back through each of them rounded alike, as a float8 training step
computes its backward; products and sums kept in float32 (as the card's
fp8 tensor cores accumulate)."""

from __future__ import annotations

import torch

FP8_MAX = 448.0   # float8 e4m3's largest finite value


def _round_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude to 448, the usual per-tensor scaling)."""
    amax = t.detach().abs().max()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _E4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round_e4m3(t)

    @staticmethod
    def backward(ctx, grad):
        return _round_e4m3(grad)


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 (``_round_e4m3``), and so is the
    gradient that flows back through it."""
    return _E4M3.apply(t)
