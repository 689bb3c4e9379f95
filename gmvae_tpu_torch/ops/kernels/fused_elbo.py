"""Fused mixture-ELBO head: a ``torch.autograd.Function`` over the CUDA
forward and backward kernels, and its plain version.

Replaces the TPU kernels ``gmvae_tpu/ops/kernels/fused_elbo.py:_kernel_flat``
(the flagship's flat [TB, K*D] layout) and ``:_kernel`` (the (TB, K, D)
layout the TPU takes at D >= 128), with the reference's ``custom_vjp``
around them. That split follows the TPU's 128-lane vector width; the CUDA
kernel (``gmvae_tpu_torch/csrc/fused_elbo_fwd.cu``) is one shape-generic
kernel, one block per batch row whose lanes stride over the row's K*D
(component, latent) pairs. The backward is the kernel of
``fused_elbo_bwd.py`` (``csrc/fused_elbo_bwd.cu``).

What bounds the forward on an H100: bytes, not operations. A row reads
2*K*D + K floats and writes D + K + 8 for about 22*K*D float32 operations,
and at the flagship shape (B=128, K=10, D=10) a call moves ~120 KB: in
practice a launch is latency-bound (the chain of dependent steps through a
row; times in PERF.md). The design (``csrc/head_row.cuh``): one block of 4
to 8 warps per row stages the row's q tiles and the prior in shared memory
by TMA bulk copies issued as it starts, overlapped with the threefry noise
it draws from the caller's key (no noise arrays cross device memory), so
each input crosses from L2 or device memory once per block; the K-vector
steps run on separate warps side by side; the intermediates stay in shared
memory and each output is written once.

Noise: with ``noise=None`` the kernel draws threefry noise over the
counters ``c0 = (row << 16) | col``, ``c1 = SALT_GUMBEL`` (cols < K) or
``SALT_NORMAL`` (cols < D), rows numbered 0..B-1 within the call: bit for
bit the noise of the JAX kernel in ``noise_mode='threefry'`` for the same
key. ``noise=(g, eps)`` streams explicit noise in instead, and
``noise_mode='xla'`` streams the unfused head's ``jax.random`` noise
(``elbo.head_noise``), as the reference's ``'xla'`` mode does.

The key and ``tau`` reach both kernels through device memory
(``_build.head_scalars``): as given, where they already are tensors on the
card (the training step's graphs pass views of their per-step slot, so a
replay draws that step's noise), else copied there once a call. The plain
versions take either form.

Autograd: the Function saves its inputs, the key, ``tau`` and ``hard``
(and the noise only when it was streamed), and returns the per-row scalars
as one ``[B, 8]`` tensor, so its backward receives the packed cotangent the
backward kernel takes. ``tau`` is not differentiable. On CPU tensors the
forward is the plain version and the backward ``fused_elbo_bwd.manual_bwd``
over the replayed noise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gmvae_tpu_torch.elbo import (HeadOutputs, MixturePrior, head_from_noise,
                                  head_noise)
from gmvae_tpu_torch.ops.kernels import _build, fused_elbo_bwd
from gmvae_tpu_torch.ops.kernels.threefry import replay_noise

_MAX_INDEX = 1 << 16   # threefry counter layout: row and col < 2^16


def _check_sizes(b: int, k: int, d: int) -> None:
    if b < 1 or k < 1 or d < 1:
        raise ValueError(f'empty head input: B={b}, K={k}, D={d}')
    if max(b, k, d) >= _MAX_INDEX:
        raise ValueError('threefry counter layout requires B, K, D < 2^16, '
                         f'got B={b}, K={k}, D={d}')


def fused_mixture_elbo_plain(key_u32, k_logits, q_means, q_logvars,
                             prior: MixturePrior, tau, hard: bool = False,
                             noise=None) -> HeadOutputs:
    """The kernel's plain PyTorch version: threefry host replay (or the
    streamed noise) fed to ``elbo.head_from_noise``. Runs on any device."""
    b, k = k_logits.shape
    d = q_means.shape[-1]
    _check_sizes(b, k, d)
    if noise is None:
        g, eps = replay_noise(key_u32, b, k, d, device=k_logits.device)
    else:
        g, eps = noise
    return head_from_noise(g, eps, k_logits, q_means, q_logvars, prior, tau,
                           hard=hard)


def _packed(out: HeadOutputs) -> torch.Tensor:
    """The five per-row scalars packed as the kernel's ``[B, 8]``."""
    zero = torch.zeros_like(out.kl_cat)
    return torch.stack([out.log_prior_mix, out.log_q_mix, out.log_p_cond,
                        out.log_q_cond, out.kl_cat, zero, zero, zero], -1)


def dense_cotangent(c: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    """A cotangent as the backward kernel takes it: dense float32. Unused
    outputs (y, in the structured ELBO) arrive as None, and reductions (a
    ``.mean()`` grad is an expanded scalar) with zero strides."""
    if c is None:
        return torch.zeros(shape, device=device)
    return c.to(torch.float32).contiguous()


class FusedHead(torch.autograd.Function):
    """``(z, y, scal [B,8])`` from the head's inputs: the CUDA kernels on
    the card, the plain forward and ``manual_bwd`` on the CPU."""

    @staticmethod
    def forward(ctx, k_logits, q_means, q_logvars, pi_logits, p_means,
                p_logvars, g, eps, key_u32, tau, hard):
        noise = None if g is None else (g, eps)
        prior = MixturePrior(pi_logits, p_means, p_logvars)
        if k_logits.device.type == 'cuda':
            # on the card once, for both kernels
            key_u32, tau = _build.head_scalars(key_u32, tau, k_logits.device)
            z, y, scal = _launch(key_u32, k_logits, q_means, q_logvars,
                                 prior, tau, hard, noise)
        else:
            tau = float(tau)
            out = fused_mixture_elbo_plain(key_u32, k_logits, q_means,
                                           q_logvars, prior, tau, hard, noise)
            z, y, scal = out.z, out.y, _packed(out)
        ctx.save_for_backward(k_logits, q_means, q_logvars, pi_logits,
                              p_means, p_logvars, g, eps)
        ctx.key_u32, ctx.tau, ctx.hard = key_u32, tau, hard
        return z, y, scal

    @staticmethod
    def backward(ctx, cz, cy, cs):
        (k_logits, q_means, q_logvars, pi_logits, p_means, p_logvars, g,
         eps) = ctx.saved_tensors
        b, k = k_logits.shape
        dev = k_logits.device
        cz = dense_cotangent(cz, (b, q_means.shape[-1]), dev)
        cy = dense_cotangent(cy, (b, k), dev)
        cs = dense_cotangent(cs, (b, 8), dev)
        noise = None if g is None else (g, eps)
        grads = fused_elbo_bwd.fused_elbo_bwd(
            ctx.key_u32, k_logits, q_means, q_logvars, pi_logits, p_means,
            p_logvars, ctx.tau, ctx.hard, cs, cz, cy, noise)
        return (*grads, None, None, None, None, None)


def fused_mixture_elbo(key_u32, k_logits: torch.Tensor,
                       q_means: torch.Tensor, q_logvars: torch.Tensor,
                       prior: MixturePrior, tau, hard: bool = False,
                       noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                       noise_mode: str = 'threefry') -> HeadOutputs:
    """The head: the CUDA kernels for CUDA tensors, the plain versions for
    CPU tensors (``FusedHead``). ``key_u32`` is a ``(k0, k1)`` threefry key
    or its words as an int32 ``[2]`` tensor; ``k_logits [B,K]``,
    ``q_means``/``q_logvars [B,K,D]``; ``tau`` a scalar temperature, a
    number or a float32 0-dim tensor. ``noise_mode='xla'`` streams
    ``elbo.head_noise(key)`` unless ``noise`` is given."""
    device = k_logits.device
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'fused_mixture_elbo: unsupported device {device}')
    if noise_mode not in ('threefry', 'xla'):
        raise ValueError(f'noise_mode must be threefry|xla, got {noise_mode!r}')
    b, k = k_logits.shape
    d = q_means.shape[-1]
    _check_sizes(b, k, d)
    if noise is None and noise_mode == 'xla':
        noise = head_noise(key_u32, b, k, d, device)
    g, eps = noise if noise is not None else (None, None)
    z, y, scal = FusedHead.apply(k_logits, q_means, q_logvars,
                                 prior.pi_logits, prior.means, prior.logvars,
                                 g, eps, key_u32, tau, hard)
    return HeadOutputs(z=z, y=y, log_prior_mix=scal[:, 0],
                       log_q_mix=scal[:, 1], log_p_cond=scal[:, 2],
                       log_q_cond=scal[:, 3], kl_cat=scal[:, 4])


def _launch(key_u32, k_logits, q_means, q_logvars, prior, tau, hard, noise):
    args, out = launch_args(key_u32, k_logits, q_means, q_logvars, prior, tau,
                            hard, noise)
    with torch.cuda.device(k_logits.device):
        rc = _build.library().gmvae_fused_elbo_fwd(*args)
    _build.check(rc, 'fused_elbo_fwd launch')
    _build.LAUNCHES['fused_elbo_fwd'] += 1
    return out


def launch_args(key_u32, k_logits, q_means, q_logvars, prior, tau, hard,
                noise):
    """Check the inputs and allocate the outputs of one kernel launch:
    ``(args, (z, y, scal))``, where ``args`` are the C function's arguments
    on the current stream (holding the key and tau on the card,
    ``_build.head_scalars``). ``chip_smoke.py`` reuses them to time the
    bare kernel."""
    b, k = k_logits.shape
    d = q_means.shape[-1]
    _check_sizes(b, k, d)
    g_in, eps_in = noise if noise is not None else (None, None)
    _build.check_inputs({'k_logits': (k_logits, (b, k)),
                         'q_means': (q_means, (b, k, d)),
                         'q_logvars': (q_logvars, (b, k, d)),
                         'pi_logits': (prior.pi_logits, (k,)),
                         'prior_means': (prior.means, (k, d)),
                         'prior_logvars': (prior.logvars, (k, d)),
                         'g': (g_in, (b, k)), 'eps': (eps_in, (b, d))},
                        k_logits.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    dev = k_logits.device
    key_t, tau_t = _build.head_scalars(key_u32, tau, dev)
    z = torch.empty((b, d), dtype=torch.float32, device=dev)
    y = torch.empty((b, k), dtype=torch.float32, device=dev)
    scal = torch.empty((b, 8), dtype=torch.float32, device=dev)
    args = (ptr(k_logits), ptr(q_means), ptr(q_logvars),
            ptr(prior.pi_logits), ptr(prior.means), ptr(prior.logvars),
            ptr(g_in), ptr(eps_in), ptr(z), ptr(y), ptr(scal),
            b, k, d, ptr(key_t), ptr(tau_t), int(bool(hard)),
            torch.cuda.current_stream(dev).cuda_stream)
    return _build.Args(args, (key_t, tau_t)), (z, y, scal)
