"""Fused mixture-ELBO head backward: CUDA kernel wrapper and plain version.

Replaces the TPU kernels ``gmvae_tpu/ops/kernels/fused_elbo_bwd.py:
_bwd_kernel_flat`` and ``:_bwd_kernel`` (flat and (TB, K, D) layouts of the
same hand-derived VJP). The CUDA kernel
(``gmvae_tpu_torch/csrc/fused_elbo_bwd.cu``) is one shape-generic kernel
with the forward's layout, a block working a batch row at a time; it
regenerates the forward's noise, y and z from the threefry key (no noise
residuals) through the forward's own device functions
(``csrc/head_row.cuh``), so in hard mode it picks the forward's argmax.

What bounds it on an H100: bytes, not operations. A row reads 2*K*D + 2K
+ D + 8 floats and writes 2*K*D + K, for about 50*K*D float operations;
at the flagship shape the function moves ~230 KB, so a launch is
latency-bound in practice (the chain of dependent phases through a row).
One call is one launch, a cooperative one of min(B, P) blocks, P the
blocks the card holds at once at (K, D) (``resident_blocks``): block i
takes rows i, i + P, ... in order (one row where B <= P, every 128-row
config's and a pod rank's call; eight at celeba_dp16's 1,024 rows, P =
132) and adds each row's prior-gradient partial into its own scratch row.
After a grid barrier every block sums its stripe of the columns over the
blocks' rows in a fixed order, so the batch sum spreads over the whole
card, without float atomics, and two runs give bit-identical gradients.
``LAUNCHES['fused_elbo_bwd_persistent']`` counts the calls whose blocks
took more than one row (B > P: the persistent grid), as the launch
reports. The barrier's two tickets are device counters per device,
allocated and zeroed once, which every call leaves at 0; calls on one
device must not overlap (one stream at a time).

``manual_bwd`` is the plain version: the analytic VJP, step for step the
reference's ``manual_bwd`` (sections A-N), in plain torch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from gmvae_tpu_torch import dists
from gmvae_tpu_torch.ops.kernels import _build
from gmvae_tpu_torch.ops.kernels.threefry import replay_noise


class BwdGrads(NamedTuple):
    d_k_logits: torch.Tensor   # [B, K]
    d_q_means: torch.Tensor    # [B, K, D]
    d_q_logvars: torch.Tensor  # [B, K, D]
    d_pi: torch.Tensor         # [K]
    d_p_means: torch.Tensor    # [K, D]
    d_p_logvars: torch.Tensor  # [K, D]


def manual_bwd(g, eps, k_logits, q_means, q_logvars, pi_logits, p_means,
               p_logvars, tau, cs: torch.Tensor, cz: torch.Tensor,
               cy: torch.Tensor, hard: bool = False) -> BwdGrads:
    """Analytic VJP of ``elbo.head_from_noise``.

    ``g``/``eps``: the noise the forward used. Cotangents: ``cz [B,D]``,
    ``cy [B,K]`` and the packed per-row scalars ``cs [B,8]`` = (log_prior_mix,
    log_q_mix, log_p_cond, log_q_cond, kl_cat, 0, 0, 0). Prior gradients are
    summed over the batch; logvar gradients are zero outside the inclusive
    clamp band.
    """
    c_lpm, c_lqm, c_lpc, c_lqc, c_klc = (cs[:, i:i + 1] for i in range(5))
    lo, hi = dists.LOGVAR_MIN, dists.LOGVAR_MAX

    # ---- recompute the forward intermediates -----------------------------
    qlv = torch.clamp(q_logvars, lo, hi)                          # [B,K,D]
    plv = torch.clamp(p_logvars, lo, hi)                          # [K,D]
    qlv_mask = ((q_logvars >= lo) & (q_logvars <= hi)).to(q_logvars.dtype)
    plv_mask = ((p_logvars >= lo) & (p_logvars <= hi)).to(p_logvars.dtype)

    ysoft = torch.softmax((k_logits + g) / tau, dim=-1)          # [B,K]
    if hard:
        y = torch.nn.functional.one_hot(
            torch.argmax(ysoft, dim=-1), k_logits.shape[-1]).to(ysoft.dtype)
    else:
        y = ysoft
    y3 = y[:, :, None]
    mean = torch.sum(y3 * q_means, dim=1)                         # [B,D]
    lv = torch.sum(y3 * qlv, dim=1)
    z = mean + torch.exp(0.5 * lv) * eps
    pmean = torch.sum(y3 * p_means[None], dim=1)
    pl = torch.sum(y3 * plv[None], dim=1)

    eq = torch.exp(-qlv)
    ep = torch.exp(-plv)[None]
    dq = z[:, None, :] - q_means                                  # [B,K,D]
    dp = z[:, None, :] - p_means[None]
    comp_q = -0.5 * torch.sum(dq * dq * eq + qlv + dists.LOG2PI, dim=-1)
    comp_p = -0.5 * torch.sum(dp * dp * ep + plv[None] + dists.LOG2PI,
                              dim=-1)

    log_pi = torch.log_softmax(pi_logits, dim=-1)                 # [K]
    pi_sm = torch.exp(log_pi)
    log_qk = torch.log_softmax(k_logits, dim=-1)                  # [B,K]
    qk = torch.exp(log_qk)
    w_p = torch.softmax(log_pi[None] + comp_p, dim=-1)
    w_q = torch.softmax(log_qk + comp_q, dim=-1)

    # A. klc = sum_k qk (log_qk - log_pi)
    klc_val = torch.sum(qk * (log_qk - log_pi[None]), dim=-1, keepdim=True)
    d_kl = c_klc * qk * ((log_qk - log_pi[None]) - klc_val)
    d_pi = torch.sum(c_klc * (pi_sm[None] - qk), dim=0)

    # B. lqc = logN(z; mean, lv)
    r_q = (z - mean) * torch.exp(-lv)
    d_z = cz - c_lqc * r_q
    d_mean = c_lqc * r_q
    d_lv = c_lqc * 0.5 * ((z - mean) * r_q - 1.0)

    # C. lpc = logN(z; pmean, pl)
    r_p = (z - pmean) * torch.exp(-pl)
    d_z = d_z - c_lpc * r_p
    d_pmean = c_lpc * r_p
    d_pl = c_lpc * 0.5 * ((z - pmean) * r_p - 1.0)
    d_pm_b = y3 * d_pmean[:, None, :]
    d_plv_b = y3 * d_pl[:, None, :]
    d_y = (cy + torch.sum(p_means[None] * d_pmean[:, None, :], dim=-1)
           + torch.sum(plv[None] * d_pl[:, None, :], dim=-1))

    # D/E. the two LSEs
    a_q = c_lqm * w_q
    a_p = c_lpm * w_p
    d_pi = d_pi + torch.sum(c_lpm * (w_p - pi_sm[None]), dim=0)

    # F. comp_q backward
    dqe = dq * eq
    d_z = d_z - torch.sum(a_q[:, :, None] * dqe, dim=1)
    d_qm = a_q[:, :, None] * dqe
    d_qlv = a_q[:, :, None] * 0.5 * (dq * dqe - 1.0)

    # G. comp_p backward
    dpe = dp * ep
    d_z = d_z - torch.sum(a_p[:, :, None] * dpe, dim=1)
    d_pm_b = d_pm_b + a_p[:, :, None] * dpe
    d_plv_b = d_plv_b + a_p[:, :, None] * 0.5 * (dp * dpe - 1.0)

    # H. z = mean + e^{lv/2} eps
    d_mean = d_mean + d_z
    d_lv = d_lv + d_z * 0.5 * torch.exp(0.5 * lv) * eps

    # I. mean/lv mixing
    d_qm = d_qm + y3 * d_mean[:, None, :]
    d_qlv = d_qlv + y3 * d_lv[:, None, :]
    d_y = (d_y + torch.sum(q_means * d_mean[:, None, :], dim=-1)
           + torch.sum(qlv * d_lv[:, None, :], dim=-1))

    # J. softmax; straight-through passes d_y to ysoft unchanged
    d_s = (d_y - torch.sum(d_y * ysoft, dim=-1, keepdim=True)) * ysoft
    d_kl = d_kl + d_s / tau

    # K. log_qk = log_softmax(k_logits), cotangent a_q
    d_kl = d_kl + a_q - qk * torch.sum(a_q, dim=-1, keepdim=True)

    # M/N. clamp masks, batch sums of the prior gradients
    return BwdGrads(d_kl, d_qm, d_qlv * qlv_mask, d_pi,
                    torch.sum(d_pm_b, dim=0),
                    torch.sum(d_plv_b, dim=0) * plv_mask)


_TICKETS: Dict[int, torch.Tensor] = {}
TICKETS = 2   # the grid barrier's: blocks arrived, blocks done


def _ticket(dev: torch.device) -> torch.Tensor:
    """The backward kernel's grid-barrier tickets on ``dev``: zeroed int32,
    allocated once; every launch leaves them at 0."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _TICKETS:
        _TICKETS[index] = torch.zeros(TICKETS, dtype=torch.int32,
                                      device=torch.device('cuda', index))
    return _TICKETS[index]


def resident_blocks(k: int, d: int, dev: torch.device) -> int:
    """P: the backward kernel's blocks that the card ``dev`` holds at once
    at (K, D). A call of more than P rows launches P blocks, each taking
    several rows; one of at most P rows, a block a row."""
    with torch.cuda.device(dev):
        p = _build.library().gmvae_fused_elbo_bwd_resident(k, d)
    if p <= 0:
        _build.check(-p, 'fused_elbo_bwd plan')
    return p


def launch_args(key_u32: Sequence[int], k_logits, q_means, q_logvars,
                pi_logits, p_means, p_logvars, tau, hard: bool, cs, cz, cy,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Check the inputs and allocate the outputs of one backward launch:
    ``(args, grads)``, ``args`` the C function's arguments on the current
    stream (the last a pointer to a C int that receives the blocks
    launched; they hold the key and tau on the card,
    ``_build.head_scalars``, and the scratch), ``grads`` the ``BwdGrads``
    it fills. ``chip_smoke.py`` reuses them to time the bare kernel."""
    b, k = k_logits.shape
    d = q_means.shape[-1]
    g_in, eps_in = noise if noise is not None else (None, None)
    inputs = {'k_logits': (k_logits, (b, k)),
              'q_means': (q_means, (b, k, d)),
              'q_logvars': (q_logvars, (b, k, d)),
              'pi_logits': (pi_logits, (k,)),
              'prior_means': (p_means, (k, d)),
              'prior_logvars': (p_logvars, (k, d)),
              'cs': (cs, (b, 8)), 'cz': (cz, (b, d)), 'cy': (cy, (b, k)),
              'g': (g_in, (b, k)), 'eps': (eps_in, (b, d))}
    _build.check_inputs(inputs, k_logits.device)
    dev = k_logits.device
    key_t, tau_t = _build.head_scalars(key_u32, tau, dev)
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    grads = BwdGrads(empty(b, k), empty(b, k, d), empty(b, k, d), empty(k),
                     empty(k, d), empty(k, d))
    # one prior-gradient partial per block
    with torch.cuda.device(dev):
        scratch = empty(_build.library().gmvae_fused_elbo_bwd_scratch(b, k, d))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = (ptr(k_logits), ptr(q_means), ptr(q_logvars), ptr(pi_logits),
            ptr(p_means), ptr(p_logvars), ptr(g_in), ptr(eps_in), ptr(cs),
            ptr(cz), ptr(cy), *(ptr(t) for t in grads), ptr(scratch),
            ptr(_ticket(dev)), b, k, d, ptr(key_t), ptr(tau_t),
            int(bool(hard)), torch.cuda.current_stream(dev).cuda_stream,
            ctypes.pointer(ctypes.c_int(0)))
    return _build.Args(args, (key_t, tau_t, scratch)), grads


def fused_elbo_bwd(key_u32, k_logits, q_means, q_logvars, pi_logits, p_means,
                   p_logvars, tau, hard: bool, cs, cz, cy,
                   noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> BwdGrads:
    """The head's backward: the CUDA kernel for CUDA tensors, ``manual_bwd``
    over the replayed (or streamed) noise for CPU tensors. The key and tau
    as ``fused_elbo.fused_mixture_elbo`` takes them."""
    device = k_logits.device
    if device.type == 'cpu':
        tau = float(tau)
        b, k = k_logits.shape
        g, eps = (noise if noise is not None
                  else replay_noise(key_u32, b, k, q_means.shape[-1]))
        return manual_bwd(g, eps, k_logits, q_means, q_logvars, pi_logits,
                          p_means, p_logvars, tau, cs, cz, cy, hard=hard)
    if device.type != 'cuda':
        raise ValueError(f'fused_elbo_bwd: unsupported device {device}')
    args, grads = launch_args(key_u32, k_logits, q_means, q_logvars,
                              pi_logits, p_means, p_logvars, tau, hard, cs,
                              cz, cy, noise)
    with torch.cuda.device(device):
        rc = _build.library().gmvae_fused_elbo_bwd(*args)
    _build.check(rc, 'fused_elbo_bwd launch')
    _build.LAUNCHES['fused_elbo_bwd'] += 1
    if args[-1].contents.value < k_logits.shape[0]:
        _build.LAUNCHES['fused_elbo_bwd_persistent'] += 1
    return grads
