"""Wide-boundary head: the three posterior-head matmuls fused into the head
forward, a ``torch.autograd.Function`` over a CUDA forward kernel, and its
plain version.

Replaces the TPU kernel ``tools/bench_head_boundary.py:_wide_kernel`` and
the ``custom_vjp`` around it (``wide_head``), the reference's ablation of
the kernel boundary. The narrow head takes ``k_logits [B,K]``, ``q_means``
and ``q_logvars [B,K*D]`` from three matmuls through device memory; the
wide head takes the encoder's ``feats [B,H]`` and the three heads' weights,
so those tensors never cross device memory on the forward. Its backward,
as the reference's ``_wide_bwd``, rematerializes them with three
``torch.matmul`` calls, runs the narrow head's backward kernel
(``fused_elbo_bwd``) on them with the same threefry key, adds the direct
cotangent of the ``k_logits`` output, and chains the matmuls' VJPs.

The CUDA kernel (``gmvae_tpu_torch/csrc/wide_head_fwd.cu``) runs a tile of
16 rows as a thread-block cluster whose blocks split the projections'
columns; it computes them float32-exact on the tensor cores (3xTF32
``mma.sync``), keeps them in shared memory, gathers each row's through
distributed shared memory into one block, and runs the head there with
``csrc/head_row.cuh``'s row functions, one row a block; what bounds it and
its design are in its source note. Soft y and in-kernel threefry noise
only, as the TPU kernel: the noise of rows 0..B-1 over the narrow kernel's
counters, so both boundaries draw the same noise for the same key.

Weights keep the reference's ``[H, out]`` layout and the prior means and
logvars its flat ``[K*D]`` one. The key is the ``(k0, k1)`` uint32 pair
``fused_mixture_elbo`` takes (the reference passes it bitcast to float32).
"""

from __future__ import annotations

from typing import Tuple

import torch

from gmvae_tpu_torch.elbo import MixturePrior
from gmvae_tpu_torch.ops.kernels import _build, fused_elbo_bwd
from gmvae_tpu_torch.ops.kernels.fused_elbo import (_check_sizes, _packed,
                                                    dense_cotangent,
                                                    fused_mixture_elbo_plain)

SMEM_LIMIT = 232_448   # bytes of shared memory a block can take on an H100


def project(feats, wk, bk, wm, bm, wlv, blv, k: int, d: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The boundary tensors: ``k_logits [B,K]``, ``q_means`` and
    ``q_logvars [B,K,D]`` by float32 ``torch.matmul``."""
    b = feats.shape[0]
    return (feats @ wk + bk, (feats @ wm + bm).reshape(b, k, d),
            (feats @ wlv + blv).reshape(b, k, d))


def wide_head_plain(key_u32, tau, feats, wk, bk, wm, bm, wlv, blv,
                    pi_logits, p_means, p_logvars, k: int, d: int):
    """The kernel's plain PyTorch version: the three projections, then the
    narrow head's plain version on the replayed threefry noise, soft y.
    Returns ``(z [B,D], y [B,K], scal [B,8], k_logits [B,K])``."""
    k_logits, q_means, q_logvars = project(feats, wk, bk, wm, bm, wlv, blv,
                                           k, d)
    prior = MixturePrior(pi_logits, p_means.reshape(k, d),
                         p_logvars.reshape(k, d))
    out = fused_mixture_elbo_plain(key_u32, k_logits, q_means, q_logvars,
                                   prior, tau)
    return out.z, out.y, _packed(out), k_logits


class WideHead(torch.autograd.Function):
    """``(z, y, scal [B,8], k_logits)`` from feats and the heads' weights:
    the CUDA kernel (forward) and the narrow backward kernel on the card,
    the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, feats, wk, bk, wm, bm, wlv, blv, pi_logits, p_means,
                p_logvars, key_u32, tau, k, d):
        args = (feats, wk, bk, wm, bm, wlv, blv, pi_logits, p_means,
                p_logvars)
        if feats.device.type == 'cuda':
            out = _launch(key_u32, tau, *args, k, d)
        else:
            out = wide_head_plain(key_u32, tau, *args, k, d)
        ctx.save_for_backward(*args)
        ctx.key_u32, ctx.tau, ctx.k, ctx.d = key_u32, float(tau), k, d
        return out

    @staticmethod
    def backward(ctx, cz, cy, cs, ckl):
        (feats, wk, bk, wm, bm, wlv, blv, pi_logits, p_means,
         p_logvars) = ctx.saved_tensors
        k, d = ctx.k, ctx.d
        b, dev = feats.shape[0], feats.device
        # rematerialize the boundary tensors: three matmuls instead of
        # residuals kept in device memory
        k_logits, q_means, q_logvars = project(feats, wk, bk, wm, bm, wlv,
                                               blv, k, d)
        g = fused_elbo_bwd.fused_elbo_bwd(
            ctx.key_u32, k_logits, q_means, q_logvars, pi_logits,
            p_means.reshape(k, d), p_logvars.reshape(k, d), ctx.tau, False,
            dense_cotangent(cs, (b, 8), dev), dense_cotangent(cz, (b, d), dev),
            dense_cotangent(cy, (b, k), dev))
        d_kl = g.d_k_logits if ckl is None else g.d_k_logits + ckl
        d_qm = g.d_q_means.reshape(b, k * d)
        d_qlv = g.d_q_logvars.reshape(b, k * d)
        # the matmuls' VJPs
        d_feats = d_kl @ wk.T + d_qm @ wm.T + d_qlv @ wlv.T
        return (d_feats, feats.T @ d_kl, d_kl.sum(0), feats.T @ d_qm,
                d_qm.sum(0), feats.T @ d_qlv, d_qlv.sum(0), g.d_pi,
                g.d_p_means.reshape(-1), g.d_p_logvars.reshape(-1), None,
                None, None, None)


def wide_head(key_u32, tau, feats, wk, bk, wm, bm, wlv, blv, pi_logits,
              p_means, p_logvars, k: int, d: int):
    """The wide head, differentiable in every tensor: the CUDA kernels for
    CUDA tensors, the plain versions for CPU tensors (``WideHead``).
    ``feats [B,H]``, ``wk [H,K]``, ``wm``/``wlv [H,K*D]``, biases and the
    prior means/logvars flat; ``tau`` a scalar temperature. Returns ``(z,
    y, scal [B,8], k_logits)``."""
    if feats.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'wide_head: unsupported device {feats.device}')
    _check_sizes(feats.shape[0], k, d)
    return WideHead.apply(feats, wk, bk, wm, bm, wlv, blv, pi_logits,
                          p_means, p_logvars, key_u32, tau, k, d)


def _launch(key_u32, tau, *tensors_kd):
    args, out = launch_args(key_u32, tau, *tensors_kd)
    with torch.cuda.device(out[0].device):
        rc = _build.library().gmvae_wide_head_fwd(*args)
    _build.check(rc, 'wide_head_fwd launch')
    _build.LAUNCHES['wide_head_fwd'] += 1
    return out


def launch_args(key_u32, tau, feats, wk, bk, wm, bm, wlv, blv, pi_logits,
                p_means, p_logvars, k: int, d: int):
    """Check the inputs and allocate the outputs of one kernel launch:
    ``(args, (z, y, scal, k_logits))``, ``args`` the C function's
    arguments on the current stream (holding the key and tau on the card,
    ``_build.head_scalars``). ``chip_smoke.py`` reuses them to time the
    bare kernel."""
    b, h = feats.shape
    n = k * d
    _check_sizes(b, k, d)
    dev = feats.device
    _build.check_inputs({'feats': (feats, (b, h)), 'wk': (wk, (h, k)),
                         'bk': (bk, (k,)), 'wm': (wm, (h, n)),
                         'bm': (bm, (n,)), 'wlv': (wlv, (h, n)),
                         'blv': (blv, (n,)), 'pi_logits': (pi_logits, (k,)),
                         'prior_means': (p_means, (n,)),
                         'prior_logvars': (p_logvars, (n,))}, dev)
    smem = _build.library().gmvae_wide_head_smem(b, h, k, d)
    if smem > SMEM_LIMIT:
        raise ValueError(f'wide_head: H={h}, K={k}, D={d} needs {smem} bytes '
                         f'of shared memory a block, over {SMEM_LIMIT}')
    key_t, tau_t = _build.head_scalars(key_u32, tau, dev)
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    out = (empty(b, d), empty(b, k), empty(b, 8), empty(b, k))
    args = (*(t.data_ptr() for t in (feats, wk, bk, wm, bm, wlv, blv,
                                     pi_logits, p_means, p_logvars, *out)),
            b, h, k, d, key_t.data_ptr(), tau_t.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return _build.Args(args, (key_t, tau_t)), out
