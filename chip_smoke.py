#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gmvae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. the card's name and power limit, and the kernels' build (nvcc, one
   process per source, started together);
2. threefry: the device generator's raw words against the host replay,
   bit for bit;
3. the head forward kernel against its plain PyTorch version on the card
   at every shape the configs give it, soft and hard y, in-kernel and
   streamed noise; the bare kernel's device time a launch from the
   profiler over 200 launches (``device_us``), and CUDA-event medians of
   the bare kernel (launched back to back: at small shapes the host's
   launch rate), of the wrapper's call and of the plain version;
4. the head backward kernel (``[head_bwd]``) at the same shapes and modes
   against its plain version ``manual_bwd`` and against autograd of the
   plain forward, and bit-identical across two runs; the same timings
   (one launch a call), and the Function's backward through autograd;
5. the eval slice: mnist_k10 at full width from a seeded init, ``api.
   eval_elbo`` over the 10,000-image test set through the kernel (its launch
   count must be 79 batches x eval_samples), the same eval with the plain
   head on the card, the eval rate over 8 full evals back to back, a
   profile of the eval (device-busy share, time by kernel), a CPU
   cross-check on a small input, and the inference verbs answering a few
   requests, with their wall time per request;
6. training (``[train]``): ``api.train('mnist_k10')`` at full width for the
   config's 20,000 steps on the stand-in MNIST data, with the launch
   counts reset just before: the forward kernel once per step plus once
   per eval batch, the backward kernel once per step; the final eval
   ELBO within 1% of the reference's trained -225.94287109375, ACC and
   NMI >= 0.85, the ELBO rising from the first eval to the last; the img/s
   of each eval window, and a profile of one chunk of steps;
7. a GPU-vs-CPU cross-check (``[xcheck]``): 20 training steps from the
   same state (parameters and Adam moments), plan and keys on the card
   (kernels) and on the CPU (plain versions);
8. the wide head (``[head_wide]``): ``csrc/wide_head_fwd.cu`` against its
   plain version at the ablation's two shapes and a ragged batch, its
   Function's gradients against autograd of the plain version, reruns
   bit-identical; the bare kernel's device time a launch from the profiler
   over 200 launches (``device_us``) and its CUDA-event time, the call, the
   plain version and the narrow path (three matmuls + the head kernel) it
   stands beside; its float32 bound and the bound of its 3xTF32 work;
9. the head-boundary ablation (``[boundary]``): narrow and wide rows of
   ``gmvae_tpu_torch/tools/bench_head_boundary.py`` at both shapes, with
   exact launch counts;
10. cifar_k20 (``[cifar_train]``): ``api.train('cifar_k20')`` at full width
    for CIFAR_STEPS steps on the stand-in CIFAR-10, with exact launch
    counts and a finite, rising eval ELBO; a profile of one chunk by
    kernel class, the posterior-head GEMMs and the boundary's share
    (``[cifar_profile]``); and ``[cifar_xcheck]``, 5 steps GPU vs CPU.

Float32 convolutions run with TF32 off (``torch.backends.cudnn.
allow_tf32``); the configs' convolutions are bf16. Prints one
``{"kernels": [...]}`` line (the three kernels), the card's name and power
limit, and, last, ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, when no CUDA device is present or the port is not
importable.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gmvae_tpu_torch.ops.kernels import _build
from gmvae_tpu_torch.tools.head_kernel_times import (WIDE_SHAPES,
                                                     wide_bounds_us)
from gmvae_tpu_torch.utils.profiling import device_us, profile_device

# f32 operations outside the tensor cores and device memory rate of one
# H100 SXM (NVIDIA data sheet) at its 700 W limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
MAIN_SHAPE = (128, 10, 10)   # mnist_k10: batch 128, K=10, D=10
EXTRA_SHAPES = [(37, 10, 10), (128, 20, 128), (128, 64, 256)]
Z_Y_ATOL = 1e-5
SCAL_RTOL = 1e-4             # of max(|plain|, 1)
EVAL_PASSES = 8              # full evals timed back to back for the rate
# backward: each per-row gradient entry (d_k_logits, d_q_means,
# d_q_logvars) within GRAD_ATOL, or GRAD_RTOL of max(|plain|, 1); the
# prior gradients (batch sums over B rows) within PRIOR_RTOL of the
# tensor's max(|plain|, 1), since an entry can cancel to near 0 from terms
# of the tensor's size. At ROW_TOL_SHAPES (K*D >= 2560) a per-row entry is
# a difference of sums over thousands of terms, so its float32 error
# scales with its row's largest terms, not with the entry: there the
# GRAD_RTOL is of the batch row's max(|plain|, 1). Every row also prints
# each version's error against manual_bwd in float64, per gradient, as a
# share of the same tolerance: on an H100, up to 1.24 for both the kernel
# and the plain version at (128,64,256) with a hard y, so GRAD_RTOL is
# near float32's reach there. Autograd of the plain forward, a third
# float32 order of operations, is up to 3.4 off float64 at that shape: at
# ROW_TOL_SHAPES it is held to AUTOGRAD_RTOL.
GRAD_ATOL = 1e-5
GRAD_RTOL = 1e-4
PRIOR_RTOL = 1e-4
AUTOGRAD_RTOL = 4e-4
ROW_TOL_SHAPES = {(128, 20, 128), (128, 64, 256)}
ORACLE_ELBO = -225.94287109375   # the reference's trained mnist_k10 ELBO
ORACLE_RTOL = 0.01
MIN_ACC_NMI = 0.85
PROFILE_STEPS = 50           # training steps under the profiler
XCHECK_STEPS = 20            # GPU-vs-CPU training steps
# bf16 GEMMs round differently in cuBLAS and on the CPU (the [slice]
# phase holds the eval ELBO to 1e-3 for it). Adam's update is ~lr whatever
# the gradient's size, so a near-zero gradient that differs in sign moves
# a parameter by up to 2 lr a step: over the 1.44M parameters only the
# mean difference is held, to XCHECK_PARAM_MEAN. The prior's parameters
# (pi_logits, prior means and logvars: 210 of them) take batch-summed
# gradients from the head kernels alone; a wrong prior gradient moves them
# by ~lr a step, so their largest difference is held to a quarter of that
XCHECK_ELBO_RTOL = 1e-3
XCHECK_PARAM_MEAN = 5e-5
XCHECK_PRIOR_MAX = 0.25      # of lr * steps
PRIOR_LEAVES = ('pi_logits', 'prior_means', 'prior_logvars')
# the wide head at WIDE_SHAPES (H, K, D, B; head_kernel_times.py's): the
# ablation's two shapes and a ragged batch. k_logits is a float32 sum over
# H (3xTF32 on the tensor cores) in another order than cuBLAS's: within
# WIDE_KL_RTOL of max(|plain|, 1). Gradients against autograd of the plain
# version: each within GRAD_ATOL plus GRAD_RTOL (AUTOGRAD_RTOL at K*D >=
# 2560) of its tensor's largest |autograd| entry, since the weight and feats
# gradients are the matmuls' VJPs, sums over B or K*D products
WIDE_MAIN = (512, 20, 128, 128)   # cifar_head: the boundary in question
WIDE_KL_RTOL = 1e-5
# the ablation's parity of the two boundaries: z, y, k_logits within 1e-5;
# log p(z|y) (about -250 nats at D=128) and the KL within 1e-3 absolute
PARITY_ATOL = {'z': 1e-5, 'y': 1e-5, 'k_logits': 1e-5, 'lpc': 1e-3,
               'klc': 1e-3}
CIFAR_STEPS = 4000           # [cifar_train]: api.train('cifar_k20') steps
CIFAR_PROFILE_STEPS = 20
CIFAR_XCHECK_STEPS = 5       # GPU-vs-CPU cifar_k20 training steps


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, reps=5):
    """Median over ``reps`` of the mean per-call time of ``iters`` calls,
    from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def launch_device_us(fn, iters=200):
    """Device us a call of ``fn`` spends in kernels, from the profiler over
    ``iters`` calls back to back, after a warm-up."""
    for _ in range(3):
        fn()
    _, busy, _, _ = profile_device(lambda: [fn() for _ in range(iters)])
    return 1e6 * busy / iters


def wall_ms(fn, reps=9):
    """Median host wall time of ``fn`` (which must wait for its result)
    over ``reps`` calls, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def head_inputs(b, k, d, seed, dev):
    from gmvae_tpu_torch.elbo import MixturePrior
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    prior = MixturePrior(t(rng.normal(size=k)), t(rng.normal(size=(k, d))),
                         t(rng.uniform(-1, 1, size=(k, d))))
    noise = (t(-np.log(-np.log(rng.uniform(1e-6, 1, size=(b, k))))),
             t(rng.normal(size=(b, d))))
    return (t(2 * rng.normal(size=(b, k))), t(rng.normal(size=(b, k, d))),
            t(rng.uniform(-3, 1, size=(b, k, d))), prior, noise)


def head_bound_ms(b, k, d, streamed):
    """Least time for the head's work: each input read once, each output
    written once, against float32 operations (exp/log counted as one,
    the integer threefry not counted)."""
    floats = (b * k + 2 * b * k * d + k + 2 * k * d      # inputs
              + b * d + b * k + 8 * b)                   # outputs
    if streamed:
        floats += b * k + b * d
    flops = b * (22 * k * d + 14 * d + 25 * k)
    t_bytes = 4 * floats / PEAK_BYTES
    t_ops = flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else \
        'operations'


def compare_head(got, ref):
    """(max abs err of z/y, max err of the scalars relative to
    max(|plain|, 1), max abs err over every output)."""
    zy = max(float((got.z - ref.z).abs().max()),
             float((got.y - ref.y).abs().max()))
    rel, absmax = 0.0, zy
    for name in ('log_prior_mix', 'log_q_mix', 'log_p_cond', 'log_q_cond',
                 'kl_cat'):
        a, b = getattr(got, name), getattr(ref, name)
        err = (a - b).abs()
        check(bool(torch.isfinite(a).all()), f'{name} not finite')
        rel = max(rel, float((err / b.abs().clamp_min(1.0)).max()))
        absmax = max(absmax, float(err.max()))
    return zy, rel, absmax


def phase_threefry(dev):
    from gmvae_tpu_torch.ops.kernels import threefry
    rows, cols = threefry.host_grid(128, 20)
    c0 = ((rows << 16) | cols).reshape(-1)
    rng = np.random.default_rng(0)
    extra = torch.from_numpy(rng.integers(0, 1 << 32, size=(2, 4096),
                                          dtype=np.int64))
    c0 = torch.cat([c0, extra[0], torch.tensor([0, 0xFFFFFFFF])])
    c1 = torch.cat([torch.full((128 * 20,), threefry.SALT_GUMBEL),
                    extra[1], torch.tensor([0xFFFFFFFF, 0])])
    for key in ((0, 0), (0x0BADF00D, 0xFFFFFFFF), (1394159668, 1590028285)):
        got = threefry.threefry2x32_grid(*key, c0.to(dev), c1.to(dev))
        ref = threefry.threefry2x32(*key, c0, c1)
        for g, r in zip(got, ref):
            check(torch.equal(g.cpu(), r),
                  f'threefry words differ from the host replay, key {key}')
    log(f'[threefry] device words == host replay, bit for bit '
        f'({c0.numel()} counters x 3 keys)')


def phase_head(dev):
    from gmvae_tpu_torch.ops.kernels import fused_elbo
    rows, main = [], None
    cases = [(MAIN_SHAPE, hard, streamed, tau)
             for hard in (False, True) for streamed in (False, True)
             for tau in (1.0, 0.7)]
    cases += [(s, False, False, 1.0) for s in EXTRA_SHAPES]
    cases += [(s, True, True, 0.7) for s in EXTRA_SHAPES]
    key = (2724472204, 3573582090)
    launch = _build.library().gmvae_fused_elbo_fwd
    with torch.no_grad():
        for i, ((b, k, d), hard, streamed, tau) in enumerate(cases):
            kl, qm, qlv, prior, noise = head_inputs(b, k, d, i, dev)
            noise = noise if streamed else None
            kern = lambda: fused_elbo.fused_mixture_elbo(  # noqa: E731
                key, kl, qm, qlv, prior, tau, hard, noise)
            plain = lambda: fused_elbo.fused_mixture_elbo_plain(  # noqa: E731
                key, kl, qm, qlv, prior, tau, hard, noise)
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            zy, rel, absmax = compare_head(got, ref)
            check(zy <= Z_Y_ATOL, f'z/y differ by {zy} at {(b, k, d)}')
            check(rel <= SCAL_RTOL,
                  f'scalars differ by {rel} (relative) at {(b, k, d)}')
            # the bare kernel: launches back to back with the checked
            # arguments, so the events time the device and not the wrapper
            args, _ = fused_elbo.launch_args(key, kl, qm, qlv, prior, tau,
                                             hard, noise)
            check(launch(*args) == 0, f'bare launch failed at {(b, k, d)}')
            ms = cuda_ms(lambda: launch(*args), 200)
            dev_us = launch_device_us(lambda: launch(*args))
            call_ms = cuda_ms(kern, 200)
            plain_ms = cuda_ms(plain, 10)
            bound, by = head_bound_ms(b, k, d, streamed)
            row = dict(shape=[b, k, d], hard=hard,
                       noise='streamed' if streamed else 'threefry',
                       tau=tau, max_abs_err=absmax, zy_abs_err=zy,
                       scal_rel_err=rel, device_us=dev_us, ms=ms,
                       call_ms=call_ms,
                       plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            rows.append(row)
            log(f'[head] {json.dumps(row)}')
            if ((b, k, d) == MAIN_SHAPE and not hard and not streamed
                    and tau == 1.0):
                main = row
    return main, rows


def bwd_bound_ms(b, k, d, streamed):
    """Least time for the head backward's work, reckoned as
    ``head_bound_ms``: the inputs (head inputs, the three cotangents) read
    once and the six gradients written once, against float32 operations
    (the forward's recomputation, the VJP, the batch sum); and, apart, the
    time of the kernel's own scratch traffic (one prior-gradient partial
    per cluster of row blocks, written and read back), which the function
    does not need."""
    part = _build.library().gmvae_fused_elbo_bwd_scratch(b, k, d)
    floats = (b * k + 2 * b * k * d + k + 2 * k * d       # head inputs
              + b * d + b * k + 8 * b                     # cotangents
              + b * k + 2 * b * k * d + k + 2 * k * d)    # gradients
    if streamed:
        floats += b * k + b * d
    flops = b * (52 * k * d + 40 * d + 55 * k) + b * (k + 2 * k * d)
    t_bytes = 4 * floats / PEAK_BYTES
    t_ops = flops / PEAK_F32_FLOPS
    scratch_ms = 1e3 * 4 * 2 * part / PEAK_BYTES
    return (1e3 * max(t_bytes, t_ops),
            'bytes' if t_bytes >= t_ops else 'operations', scratch_ms)


def grad_errors(got, ref, per_row):
    """{gradient: its largest error as a share of its tolerance} (per
    element, or of the row's largest when ``per_row``; see GRAD_RTOL), and
    the largest absolute error over every gradient."""
    shares, absmax = {}, 0.0
    for name, a, b in zip(ref._fields, got, ref):
        check(bool(torch.isfinite(a).all()), f'{name} not finite')
        err = (a.double() - b.double()).abs()
        absmax = max(absmax, float(err.max()))
        if name in ('d_pi', 'd_p_means', 'd_p_logvars'):
            tol = PRIOR_RTOL * b.abs().max().clamp_min(1.0)
        else:
            scale = b.abs()
            if per_row:
                scale = scale.reshape(b.shape[0], -1).amax(-1).reshape(
                    -1, *[1] * (b.dim() - 1))
            tol = torch.clamp_min(GRAD_RTOL * scale.clamp_min(1.0),
                                  GRAD_ATOL)
        shares[name] = float((err / tol).max())
    return shares, absmax


def compare_grads(got, ref, what, per_row, loosen=1.0):
    """Raise past a tolerance (times ``loosen``); return (max abs err,
    largest share of the tolerance)."""
    shares, absmax = grad_errors(got, ref, per_row)
    worst = max(shares.values()) / loosen
    check(worst <= 1.0, f'{what}: gradients past tolerance '
          f'{json.dumps(shares)}')
    return absmax, worst


def phase_head_bwd(dev):
    from gmvae_tpu_torch.elbo import MixturePrior
    from gmvae_tpu_torch.ops.kernels import fused_elbo, fused_elbo_bwd
    from gmvae_tpu_torch.ops.kernels.threefry import replay_noise
    rows, main = [], None
    cases = [(shape, hard, streamed) for shape in [MAIN_SHAPE] + EXTRA_SHAPES
             for hard in (False, True) for streamed in (False, True)]
    key, tau = (1394159668, 1590028285), 0.8
    launch = _build.library().gmvae_fused_elbo_bwd
    for i, ((b, k, d), hard, streamed) in enumerate(cases):
        kl, qm, qlv, prior, noise = head_inputs(b, k, d, 100 + i, dev)
        noise = noise if streamed else None
        rng = np.random.default_rng(i)
        t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
        cs = np.zeros((b, 8))
        cs[:, :5] = rng.normal(size=(b, 5))
        cs, cz, cy = t(cs), t(rng.normal(size=(b, d))), t(rng.normal(size=(b, k)))
        args = (key, kl, qm, qlv, *prior, tau, hard, cs, cz, cy, noise)
        kern = lambda: fused_elbo_bwd.fused_elbo_bwd(*args)  # noqa: E731

        def plain():
            g, eps = noise if streamed else replay_noise(key, b, k, d, dev)
            return fused_elbo_bwd.manual_bwd(g, eps, kl, qm, qlv, *prior, tau,
                                             cs, cz, cy, hard=hard)

        got, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f'two backward runs differ at {(b, k, d)}')
        what = f'{(b, k, d)} hard={hard} streamed={streamed}'
        per_row = (b, k, d) in ROW_TOL_SHAPES
        err, share = compare_grads(got, ref, what, per_row)
        # both versions against manual_bwd in float64 on the same inputs
        f64 = lambda x: x.double()  # noqa: E731
        g, eps = noise if streamed else replay_noise(key, b, k, d, dev)
        exact = fused_elbo_bwd.manual_bwd(
            *map(f64, (g, eps, kl, qm, qlv, *prior)), tau,
            *map(f64, (cs, cz, cy)), hard=hard)
        # against autograd of the plain forward on the same noise
        ins = [x.clone().requires_grad_() for x in (kl, qm, qlv, *prior)]
        out = fused_elbo.fused_mixture_elbo_plain(
            key, *ins[:3], MixturePrior(*ins[3:]), tau, hard, noise)
        scal = torch.stack(list(out[2:]), -1)
        loss = ((out.z * cz).sum() + (out.y * cy).sum()
                + (scal * cs[:, :5]).sum())
        auto = fused_elbo_bwd.BwdGrads(*torch.autograd.grad(loss, ins))
        err_auto, share_auto = compare_grads(
            got, auto, what + ' vs autograd', per_row,
            AUTOGRAD_RTOL / GRAD_RTOL if per_row else 1.0)
        f64_shares = {name: grad_errors(grads, exact, per_row)[0]
                      for name, grads in (('kernel', got), ('plain', ref),
                                          ('autograd', auto))}
        # the Function's backward through autograd, from a kept graph
        ins = [x.clone().requires_grad_() for x in (kl, qm, qlv, *prior)]
        out = fused_elbo.fused_mixture_elbo(
            key, *ins[:3], MixturePrior(*ins[3:]), tau, hard, noise)
        scal = torch.stack(list(out[2:]), -1)
        loss = ((out.z * cz).sum() + (out.y * cy).sum()
                + (scal * cs[:, :5]).sum())
        fn_grads = torch.autograd.grad(loss, ins, retain_graph=True)
        check(all(torch.equal(x, y) for x, y in zip(fn_grads, got)),
              f'the Function\'s backward differs from the kernel at '
              f'{(b, k, d)}')
        bare_args, _ = fused_elbo_bwd.launch_args(*args)
        check(launch(*bare_args) == 0, f'bare launch failed at {(b, k, d)}')
        ms = cuda_ms(lambda: launch(*bare_args), 200)
        dev_us = launch_device_us(lambda: launch(*bare_args))
        call_ms = cuda_ms(kern, 200)
        fn_ms = cuda_ms(lambda: torch.autograd.grad(loss, ins,
                                                    retain_graph=True), 50)
        plain_ms = cuda_ms(plain, 10)
        bound, by, scratch_ms = bwd_bound_ms(b, k, d, streamed)
        row = dict(shape=[b, k, d], hard=hard,
                   noise='streamed' if streamed else 'threefry', tau=tau,
                   tol='per_row' if per_row else 'per_element',
                   max_abs_err=err, max_abs_err_vs_autograd=err_auto,
                   err_share_of_tol=share,
                   autograd_err_share_of_tol=share_auto,
                   f64_err_share_of_tol=f64_shares, device_us=dev_us,
                   ms=ms, call_ms=call_ms, autograd_bwd_ms=fn_ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                   scratch_ms=scratch_ms)
        rows.append(row)
        log(f'[head_bwd] {json.dumps(row)}')
        if (b, k, d) == MAIN_SHAPE and not hard and not streamed:
            main = row
    return main, rows


def phase_slice(dev):
    from gmvae_tpu_torch import api, configs, training
    from gmvae_tpu_torch.ops.kernels import fused_elbo

    cfg = configs.mnist_k10()
    t0 = time.perf_counter()
    trainer = training.Trainer(cfg, device=dev)
    ds = trainer.dataset
    log(f'[slice] config {cfg.name}: data source {ds.source!r}, '
        f'{len(ds.test_x)} test images, built in '
        f'{time.perf_counter() - t0:.1f} s')
    state = trainer.init_state()
    n_params = sum(p.numel() for p in state.params.values())
    check(n_params == 1_442_996, f'{n_params} parameters')
    check(not torch.backends.cuda.matmul.allow_tf32, 'TF32 matmuls are on')

    trainer.evaluate(state, max_examples=256)      # warm-up (cuBLAS, ...)
    torch.cuda.synchronize()
    # ---- the main path: counts from 0, eval through the kernel ----------
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
    res = api.eval_elbo(trainer, state)
    launches = dict(_build.LAUNCHES)
    n_batches = math.ceil(len(ds.test_x) / cfg.batch_size)
    want = n_batches * max(1, cfg.eval_samples)
    check(launches['fused_elbo_fwd'] == want,
          f'head kernel launched {launches["fused_elbo_fwd"]} times, '
          f'expected {want}')
    log(f'[slice] eval through the kernel: {json.dumps(res)}; '
        f'launches {json.dumps(launches)}')

    # ---- eval rate: full evals back to back, all images over all wall ---
    walls = []
    for _ in range(EVAL_PASSES):
        t0 = time.perf_counter()
        again = trainer.evaluate(state)
        walls.append(time.perf_counter() - t0)
        check(again == res, 'a repeated eval gave another result')
    n_img = len(ds.test_x)
    rate = dict(passes=EVAL_PASSES, images=EVAL_PASSES * n_img,
                wall_s=sum(walls), img_s=EVAL_PASSES * n_img / sum(walls),
                pass_img_s_min=n_img / max(walls),
                pass_img_s_median=n_img / statistics.median(walls),
                pass_img_s_max=n_img / min(walls))
    log(f'[rate] {json.dumps(rate)}')
    img_s = rate['img_s']
    for name, v in res.items():
        check(math.isfinite(v), f'{name} = {v}')
    check(0.0 <= res['acc'] <= 1.0 and 0.0 <= res['nmi'] <= 1.0,
          'ACC/NMI out of range')
    check(res['iwae_nats'] >= res['elbo_nats'] - 1e-3, 'IWAE below ELBO')

    # ---- where the eval's time goes (one more eval, profiled) -----------
    wall, busy, n_kernels, by_name = profile_device(
        lambda: trainer.evaluate(state))
    head = [v for k, v in by_name.items() if 'fused_elbo_fwd' in k]
    head_us = head[0][1] / head[0][0] if head else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    prof = dict(wall_s=wall, device_busy_s=busy,
                device_busy_share=busy / wall, device_ops=n_kernels,
                head_kernel_device_us=head_us,
                top=[dict(name=k[:80], launches=n, device_us=us)
                     for k, (n, us) in top])
    log(f'[profile] eval under the profiler: {json.dumps(prof)}')

    # ---- the same eval with the plain head on the card ------------------
    trainer.model.head_fn = fused_elbo.fused_mixture_elbo_plain
    res_plain = trainer.evaluate(state)
    trainer.model.head_fn = fused_elbo.fused_mixture_elbo
    rel = abs(res['elbo_nats'] - res_plain['elbo_nats']) / abs(
        res_plain['elbo_nats'])
    log(f'[slice] eval with the plain head: {json.dumps(res_plain)}; '
        f'ELBO relative difference {rel:.3e}')
    check(rel <= 1e-4, f'kernel and plain-head ELBO differ by {rel}')
    check(res['acc'] == res_plain['acc'] and res['nmi'] == res_plain['nmi'],
          'kernel and plain-head ACC/NMI differ')

    # ---- a small input against the CPU (plain versions) -----------------
    cpu = training.Trainer(cfg, dataset=ds, device='cpu')
    cpu_state = training.TrainState(
        {k: v.cpu() for k, v in state.params.items()}, None, state.step)
    small_gpu = trainer.evaluate(state, max_examples=512)
    small_cpu = cpu.evaluate(cpu_state, max_examples=512)
    rel_cpu = abs(small_gpu['elbo_nats'] - small_cpu['elbo_nats']) / abs(
        small_cpu['elbo_nats'])
    x_small = ds.test_x[:512]
    agree = float(np.mean(api.cluster_assign(trainer, state, x_small)
                          == api.cluster_assign(cpu, cpu_state, x_small)))
    log(f'[slice] 512 images, GPU vs CPU: ELBO {small_gpu["elbo_nats"]} vs '
        f'{small_cpu["elbo_nats"]} (relative {rel_cpu:.3e}); cluster '
        f'agreement {agree}')
    # bf16 matmuls round differently in cuBLAS and on the CPU
    check(rel_cpu <= 1e-3, f'GPU and CPU ELBO differ by {rel_cpu}')
    check(agree >= 0.99, f'GPU and CPU assignments agree on {agree}')

    # ---- the inference verbs --------------------------------------------
    k, d = cfg.n_components, cfg.latent_dim
    for n in (1, 7, 128, 1000):
        ids = api.cluster_assign(trainer, state, ds.test_x[:n])
        check(ids.shape == (n,) and ids.dtype == np.int32
              and ids.min() >= 0 and ids.max() < k, f'cluster_assign({n})')
    z, q = api.latent_embed(trainer, state, ds.test_x[:300])
    check(z.shape == (300, d) and q.shape == (300, k)
          and np.isfinite(z).all()
          and np.allclose(q.sum(-1), 1.0, atol=1e-5), 'latent_embed')
    rec = api.reconstruct(trainer, state, ds.test_x[:64])
    check(rec.shape == (64, 28, 28, 1) and np.isfinite(rec).all()
          and rec.min() >= 0 and rec.max() <= 1, 'reconstruct')
    smp = api.sample(trainer, state, 64, seed=0)
    check(smp.shape == (64, 28, 28, 1) and np.isfinite(smp).all()
          and smp.min() >= 0 and smp.max() <= 1, 'sample')
    check(np.array_equal(smp, api.sample(trainer, state, 64, seed=0)),
          'sample is not reproducible from its seed')
    log('[slice] verbs answered: cluster_assign on 1/7/128/1000 images, '
        'latent_embed, reconstruct, sample(n=64)')

    # ---- per-request latency of the verbs (each returns host numpy) -----
    x1, x128 = ds.test_x[:1], ds.test_x[:128]
    verb_ms = {
        'cluster_assign_1': lambda: api.cluster_assign(trainer, state, x1),
        'cluster_assign_128': lambda: api.cluster_assign(trainer, state,
                                                         x128),
        'latent_embed_128': lambda: api.latent_embed(trainer, state, x128),
        'reconstruct_128': lambda: api.reconstruct(trainer, state, x128),
        'sample_64': lambda: api.sample(trainer, state, 64, seed=1),
    }
    log(f'[verbs] wall ms per call, median of 9: '
        f'{json.dumps({k: wall_ms(f) for k, f in verb_ms.items()})}')
    return launches, img_s, prof


def phase_train(dev):
    """mnist_k10 trained through ``api.train`` at full width; the main
    path of this slice."""
    from gmvae_tpu_torch import api, configs

    cfg = configs.mnist_k10()
    with tempfile.TemporaryDirectory() as run_dir:
        torch.cuda.synchronize()
        for name in _build.LAUNCHES:
            _build.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        trainer, state, hist = api.train(cfg, device=dev, run_dir=run_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        ckpts = sorted(os.listdir(os.path.join(run_dir, cfg.name)))
    log(f'[train] {cfg.steps} steps of {cfg.name} in {wall:.1f} s '
        f'(evals and checkpoints included); launches {json.dumps(launches)};'
        f' run dir {ckpts}')
    for row in hist:
        log(f'[train] {json.dumps({k: v for k, v in row.items() if k != "time"})}')
    n_eval_batches = math.ceil(len(trainer.dataset.test_x) / cfg.batch_size)
    n_evals = len(hist)
    want_fwd = cfg.steps + n_evals * n_eval_batches * max(1, cfg.eval_samples)
    check(state.step == cfg.steps, f'trained to step {state.step}')
    check(launches['fused_elbo_fwd'] == want_fwd,
          f'forward kernel launched {launches["fused_elbo_fwd"]} times, '
          f'expected {want_fwd}')
    check(launches['fused_elbo_bwd'] == cfg.steps,
          f'backward kernel launched {launches["fused_elbo_bwd"]} times, '
          f'expected {cfg.steps}')
    final, first = hist[-1], hist[0]
    for name in ('elbo_nats', 'iwae_nats', 'acc', 'nmi'):
        check(math.isfinite(final[name]), f'{name} = {final[name]}')
    rel = abs(final['elbo_nats'] - ORACLE_ELBO) / abs(ORACLE_ELBO)
    rates = [r['img_per_sec_per_chip'] for r in hist[1:]]
    summary = dict(steps=cfg.steps, wall_s=wall, final_elbo=final['elbo_nats'],
                   oracle_elbo=ORACLE_ELBO, elbo_rel_to_oracle=rel,
                   acc=final['acc'], nmi=final['nmi'],
                   first_eval_elbo=first['elbo_nats'],
                   train_img_s_windows=rates,
                   train_img_s_median=statistics.median(rates) if rates
                   else None)
    log(f'[train] summary {json.dumps(summary)}')
    check(final['elbo_nats'] > first['elbo_nats'],
          'the ELBO did not rise from the first eval to the last')
    check(rel <= ORACLE_RTOL, f'trained ELBO {final["elbo_nats"]} is '
          f'{rel:.4f} from the reference\'s {ORACLE_ELBO}')
    check(final['acc'] >= MIN_ACC_NMI and final['nmi'] >= MIN_ACC_NMI,
          f'ACC {final["acc"]} / NMI {final["nmi"]} under {MIN_ACC_NMI}')

    # ---- where a training step's time goes: one chunk, profiled -----------
    idx = trainer.batch_plan(PROFILE_STEPS, start_step=cfg.steps)
    trainer.run_chunk(state, idx)                 # warm, same shapes
    wall_p, busy, n_kernels, by_name = profile_device(
        lambda: trainer.run_chunk(state, idx))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    def per_launch_us(name):
        n, us = device_us(by_name, name)
        return us / n if n else None
    prof = dict(steps=PROFILE_STEPS, wall_s=wall_p, device_busy_s=busy,
                device_busy_share=busy / wall_p,
                step_ms=1e3 * wall_p / PROFILE_STEPS,
                img_s=PROFILE_STEPS * cfg.batch_size / wall_p,
                device_kernels_per_step=n_kernels / PROFILE_STEPS,
                fwd_kernel_device_us=per_launch_us('fused_elbo_fwd_kernel'),
                bwd_kernel_device_us=per_launch_us('fused_elbo_bwd_kernel'),
                top=[dict(name=k[:80], launches=n, device_us=us)
                     for k, (n, us) in top])
    log(f'[train_profile] {json.dumps(prof)}')
    return launches, summary, prof, trainer, state


def phase_xcheck(dev, trainer, state, steps=XCHECK_STEPS, tag='xcheck'):
    """The same ``steps`` training steps on the card and on the CPU, from
    the same state (parameters and Adam moments, as a checkpoint holds
    them), plan and keys. Fresh moments would make the first step move
    every parameter by about lr, a shock after which a trained cifar_k20's
    ELBO falls from thousands of nats to minus hundreds of thousands on
    both devices, and the comparison would measure that chaos."""
    from gmvae_tpu_torch import training

    cfg = trainer.cfg.replace(metrics_mode='stacked')
    gpu = training.Trainer(cfg, dataset=trainer.dataset, device=dev)
    cpu = training.Trainer(cfg, dataset=trainer.dataset, device='cpu')
    tree = trainer.state_to_tree(state)
    start, cpu_start = gpu.tree_to_state(tree), cpu.tree_to_state(tree)
    idx = gpu.batch_plan(steps, start_step=state.step)
    got, m_gpu = gpu.run_chunk(start, idx)
    ref, m_cpu = cpu.run_chunk(cpu_start, idx.cpu())
    elbo_rel = float(((m_gpu['elbo'] - m_cpu['elbo']).abs()
                      / m_cpu['elbo'].abs()).max())
    diff = {k: (got.params[k].cpu() - ref.params[k]).abs().reshape(-1)
            for k in ref.params}
    check(all(k in diff for k in PRIOR_LEAVES), 'prior leaves not found')
    diffs = torch.cat(list(diff.values()))
    prior = torch.cat([diff[k] for k in PRIOR_LEAVES])
    row = dict(steps=steps, elbo_gpu=m_gpu['elbo'].tolist(),
               elbo_cpu=m_cpu['elbo'].tolist(), elbo_max_rel=elbo_rel,
               param_max_abs=float(diffs.max()),
               param_mean_abs=float(diffs.mean()),
               prior_max_abs=float(prior.max()),
               prior_mean_abs=float(prior.mean()))
    log(f'[{tag}] GPU vs CPU: {json.dumps(row)}')
    check(elbo_rel <= XCHECK_ELBO_RTOL, f'per-step ELBO differs by {elbo_rel}')
    check(row['param_mean_abs'] <= XCHECK_PARAM_MEAN,
          f'parameters differ by {row["param_mean_abs"]} on average')
    prior_limit = XCHECK_PRIOR_MAX * cfg.lr * steps
    check(row['prior_max_abs'] <= prior_limit,
          f'prior parameters differ by up to {row["prior_max_abs"]}, '
          f'limit {prior_limit}')
    return row


def wide_inputs(h, k, d, b, seed, dev):
    """feats ~ N(0, 1), the heads' weights at an initialized encoder's
    scale, the prior as ``head_inputs``'s."""
    rng = np.random.default_rng(seed)
    n = k * d
    t = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (scale * rng.normal(size=s)).astype(np.float32)).to(dev)
    return [t(b, h), t(h, k, scale=0.05), t(k, scale=0.1),
            t(h, n, scale=0.05), t(n, scale=0.1), t(h, n, scale=0.02),
            t(n, scale=0.1), t(k), t(n),
            torch.from_numpy(rng.uniform(-1, 1, size=n).astype(np.float32)
                             ).to(dev)]


def phase_head_wide(dev):
    """The wide kernel against its plain version, its Function's gradients
    against autograd of the plain version, and the narrow path (three
    torch.matmul + the head kernel) timed beside it as a yardstick."""
    from gmvae_tpu_torch.elbo import MixturePrior
    from gmvae_tpu_torch.ops.kernels import fused_elbo, wide_head
    rows, main = [], None
    key, tau = (2724472204, 3573582090), 1.0
    lib = _build.library()
    launch = lib.gmvae_wide_head_fwd
    for i, (h, k, d, b) in enumerate(WIDE_SHAPES):
        ins = wide_inputs(h, k, d, b, 200 + i, dev)
        kern = lambda: wide_head.wide_head(key, tau, *ins, k, d)  # noqa: E731
        plain = lambda: wide_head.wide_head_plain(  # noqa: E731
            key, tau, *ins, k, d)

        def narrow():
            kl, qm, qlv = wide_head.project(*ins[:7], k, d)
            return fused_elbo.fused_mixture_elbo(
                key, kl, qm, qlv, MixturePrior(ins[7], ins[8].reshape(k, d),
                                               ins[9].reshape(k, d)), tau)

        with torch.no_grad():
            got, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f'two wide forward runs differ at {(h, k, d, b)}')
        errs = {}
        for name, a, r in zip(('z', 'y', 'scal', 'k_logits'), got, ref):
            check(bool(torch.isfinite(a).all()), f'wide {name} not finite')
            err = (a - r).abs()
            errs[name] = float(err.max()) if name in ('z', 'y') else float(
                (err / r.abs().clamp_min(1.0)).max())
        check(max(errs['z'], errs['y']) <= Z_Y_ATOL,
              f'wide z/y differ by {errs} at {(h, k, d, b)}')
        check(errs['scal'] <= SCAL_RTOL and errs['k_logits'] <= WIDE_KL_RTOL,
              f'wide scalars/k_logits differ by {errs} at {(h, k, d, b)}')
        # gradients: the Function (wide kernel forward, narrow backward
        # kernel, torch.matmul VJPs) against autograd of the plain version
        rng = np.random.default_rng(i)
        cts = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
               for s in ((b, d), (b, k), (b, 8), (b, k))]
        cts[2][:, 5:] = 0.0

        def grads(fn):
            xs = [x.clone().requires_grad_() for x in ins]
            out = fn(key, tau, *xs, k, d)
            return torch.autograd.grad(
                sum((o * c).sum() for o, c in zip(out, cts)), xs)

        g_got, g_again = grads(wide_head.wide_head), grads(wide_head.wide_head)
        g_ref = grads(wide_head.wide_head_plain)
        check(all(torch.equal(x, y) for x, y in zip(g_got, g_again)),
              f'two wide backward runs differ at {(h, k, d, b)}')
        rel = AUTOGRAD_RTOL if k * d >= 2560 else GRAD_RTOL
        shares = []
        for a, r in zip(g_got, g_ref):
            check(bool(torch.isfinite(a).all()), 'wide gradient not finite')
            tol = GRAD_ATOL + rel * float(r.abs().max())
            shares.append(float((a - r).abs().max()) / tol)
        check(max(shares) <= 1.0, f'wide gradients past tolerance {shares} '
              f'at {(h, k, d, b)}')
        with torch.no_grad():
            args, out = wide_head.launch_args(key, tau, *ins, k, d)
            check(launch(*args) == 0, f'bare wide launch failed at '
                  f'{(h, k, d, b)}')
            dev_us = launch_device_us(lambda: launch(*args))
            ms = cuda_ms(lambda: launch(*args), 200)
            call_ms = cuda_ms(kern, 200)
            plain_ms = cuda_ms(plain, 10)
            library_call_ms = cuda_ms(narrow, 200)
            # the narrow path's kernels' device time: its back-to-back
            # calls are host-bound, the bare kernel's are not
            narrow()
            _, busy, _, _ = profile_device(
                lambda: [narrow() for _ in range(50)])
            library_ms = 1e3 * busy / 50
        # the float32 bound (the table's) and the bound of the work as the
        # kernel does it: three TF32 products a float32 product
        f32_us, f32_by, tf32_us, tf32_by = wide_bounds_us(h, k, d, b)
        row = dict(shape=[h, k, d, b], max_abs_err=max(
            float((a - r).abs().max()) for a, r in zip(got, ref)),
            rel_err=errs, grad_err_share_of_tol=max(shares),
            cluster=lib.gmvae_wide_head_cluster(b, h, k, d),
            device_us=dev_us, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            library_ms=library_ms, library_call_ms=library_call_ms,
            bound_ms=1e-3 * f32_us, bound_by=f32_by,
            bound_tf32_ms=1e-3 * tf32_us, bound_tf32_by=tf32_by)
        rows.append(row)
        log(f'[head_wide] {json.dumps(row)}')
        if (h, k, d, b) == WIDE_MAIN:
            main = row
    return main, rows


def phase_boundary(dev):
    """The head-boundary ablation at both shapes; each variant's launches
    counted from 0 by the tool."""
    from gmvae_tpu_torch.tools import bench_head_boundary as ablation
    rows, total = [], {}
    for shape in ablation.SHAPES:
        for name in _build.LAUNCHES:
            _build.LAUNCHES[name] = 0
        row = ablation.ablation_row(*shape, device=dev)
        launches = dict(_build.LAUNCHES)
        log(f'[boundary] {json.dumps(row)}')
        # the parity check launches each forward kernel once more
        check(launches == {'fused_elbo_fwd': row['narrow_steps'] + 1,
                           'fused_elbo_bwd': row['narrow_steps']
                           + row['wide_steps'],
                           'wide_head_fwd': row['wide_steps'] + 1,
                           'threefry_grid': 0},
              f'{row["shape"]}: launches {launches}')
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        for name, err in row['parity_detail'].items():
            check(err <= PARITY_ATOL[name], f'{row["shape"]}: narrow and '
                  f'wide differ in {name} by {err}')
        nar, wide = row['narrow_launches'], row['wide_launches']
        check(nar == {'fused_elbo_fwd': row['narrow_steps'],
                      'fused_elbo_bwd': row['narrow_steps']},
              f'narrow launches {nar}, {row["narrow_steps"]} steps')
        check(wide == {'wide_head_fwd': row['wide_steps'],
                       'fused_elbo_bwd': row['wide_steps']},
              f'wide launches {wide}, {row["wide_steps"]} steps')
        for v in ('narrow', 'wide'):
            check(math.isfinite(row[v + '_final_loss']), f'{v} loss')
        rows.append(row)
    return total, rows


def _kernel_class(name):
    """conv (cuDNN), head_gemm (the float32 posterior-head matmuls: the
    only float32 GEMMs of a bf16 step), net_gemm (bf16 Dense layers),
    head (the head kernels) or other."""
    low = name.lower()
    if 'fused_elbo' in low:
        return 'head'
    if any(p in low for p in ('fprop', 'dgrad', 'wgrad', 'conv', 'cudnn',
                              'implicit')):
        return 'conv'
    if 'gemm' in low or 'gemv' in low:
        return ('net_gemm' if 'bf16' in low or 'bfloat16' in low
                else 'head_gemm')
    return 'other'


def gemm_device_us(fn, reps=20):
    """Device us a call of ``fn`` spends in GEMM kernels (profiler)."""
    fn()
    _, _, _, by_name = profile_device(lambda: [fn() for _ in range(reps)])
    return sum(us for name, (_, us) in by_name.items()
               if _kernel_class(name) in ('head_gemm', 'net_gemm')) / reps


def phase_cifar_train(dev):
    """cifar_k20 at full width through ``api.train`` on the stand-in,
    launch counts from 0."""
    from gmvae_tpu_torch import api, configs, data
    t0 = time.perf_counter()
    ds = data.load('cifar10')
    log(f'[cifar_train] data {ds.source!r}: {ds.train_x.shape} train, '
        f'{ds.test_x.shape} test, made in {time.perf_counter() - t0:.1f} s')
    cfg = configs.cifar_k20(steps=CIFAR_STEPS, eval_every=CIFAR_STEPS // 2)
    with tempfile.TemporaryDirectory() as run_dir:
        torch.cuda.synchronize()
        for name in _build.LAUNCHES:
            _build.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        trainer, state, hist = api.train(cfg, dataset=ds, device=dev,
                                         run_dir=run_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    n_params = sum(p.numel() for p in state.params.values())
    log(f'[cifar_train] {cfg.steps} steps of {cfg.name} ({n_params} '
        f'parameters) in {wall:.1f} s; launches {json.dumps(launches)}')
    for row in hist:
        log(f'[cifar_train] {json.dumps(row)}')
    n_eval = math.ceil(len(ds.test_x) / cfg.batch_size) * max(
        1, cfg.eval_samples)
    want_fwd = cfg.steps + len(hist) * n_eval
    check(state.step == cfg.steps, f'trained to step {state.step}')
    check(launches['fused_elbo_fwd'] == want_fwd,
          f'forward kernel launched {launches["fused_elbo_fwd"]} times, '
          f'expected {want_fwd}')
    check(launches['fused_elbo_bwd'] == cfg.steps,
          f'backward kernel launched {launches["fused_elbo_bwd"]} times, '
          f'expected {cfg.steps}')
    for row in hist:
        for name in ('elbo_nats', 'iwae_nats', 'acc', 'nmi'):
            check(math.isfinite(row[name]), f'{name} = {row[name]}')
    check(hist[-1]['elbo_nats'] > hist[0]['elbo_nats'],
          'the cifar_k20 ELBO did not rise from the first eval to the last')
    rates = [r['img_per_sec_per_chip'] for r in hist]

    # ---- where a step's device time goes: one chunk, profiled ----------
    idx = trainer.batch_plan(CIFAR_PROFILE_STEPS, start_step=cfg.steps)
    trainer.run_chunk(state, idx)                 # warm, same shapes
    wall_p, busy, n_kernels, by_name = profile_device(
        lambda: trainer.run_chunk(state, idx))
    per_step = {}
    for name, (n, us) in by_name.items():
        c = _kernel_class(name)
        per_step[c] = per_step.get(c, 0.0) + us / CIFAR_PROFILE_STEPS
    # the posterior-head GEMMs at the step's shapes, forward (three) and
    # backward (d feats and d weights: six): their kernels' device time
    # from the profiler (CUDA events around such short calls would time
    # the host's launches)
    model = trainer.bind(state)
    b, k, d = cfg.batch_size, cfg.n_components, cfg.latent_dim
    feats = torch.randn(b, model.encoder.out_features, device=dev)
    heads = (model.k_head, model.mean_head, model.logvar_head)
    cts = [torch.randn(b, layer.out_features, device=dev) for layer in heads]
    with torch.no_grad():
        gemm_fwd_us = gemm_device_us(lambda: [
            feats @ layer.weight.t() for layer in heads])
        gemm_bwd_us = gemm_device_us(lambda: [
            (c @ layer.weight, feats.t() @ c)
            for c, layer in zip(cts, heads)])
    busy_us = 1e6 * busy / CIFAR_PROFILE_STEPS
    # the three boundary tensors, written and read once each way a step
    boundary_bytes = 2 * 2 * 4 * b * (k + 2 * k * d)
    boundary_us = 1e6 * boundary_bytes / PEAK_BYTES
    head_path_us = per_step.get('head', 0.0) + per_step.get('head_gemm', 0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    prof = dict(steps=CIFAR_PROFILE_STEPS, wall_s=wall_p,
                step_ms=1e3 * wall_p / CIFAR_PROFILE_STEPS,
                device_busy_share=busy / wall_p,
                device_us_per_step=busy_us,
                device_kernels_per_step=n_kernels / CIFAR_PROFILE_STEPS,
                device_us_per_step_by_class=per_step,
                fwd_kernel_device_us=device_us(
                    by_name, 'fused_elbo_fwd_kernel')[1] / CIFAR_PROFILE_STEPS,
                bwd_kernel_device_us=device_us(
                    by_name, 'fused_elbo_bwd_kernel')[1] / CIFAR_PROFILE_STEPS,
                head_gemms_fwd_device_us=gemm_fwd_us,
                head_gemms_bwd_device_us=gemm_bwd_us,
                head_path_share=head_path_us / busy_us,
                boundary_bytes_per_step=boundary_bytes,
                boundary_bytes_us_at_peak=boundary_us,
                boundary_bytes_share=boundary_us / busy_us,
                top=[dict(name=n[:90], launches=c, device_us=us)
                     for n, (c, us) in top])
    log(f'[cifar_profile] {json.dumps(prof)}')
    summary = dict(steps=cfg.steps, wall_s=wall, params=n_params,
                   first_eval_elbo=hist[0]['elbo_nats'],
                   final_elbo=hist[-1]['elbo_nats'], acc=hist[-1]['acc'],
                   nmi=hist[-1]['nmi'], train_img_s_windows=rates)
    log(f'[cifar_train] summary {json.dumps(summary)}')
    return launches, summary, prof, trainer, state


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2

    dev = torch.device('cuda', 0)
    card = card_line()
    log(f'[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    t0 = time.perf_counter()
    _build.library()
    log(f'[build] kernels built and loaded in {time.perf_counter() - t0:.1f}'
        f' s')
    for line in _build.build_log.splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'[build] {line.strip()}')

    # float32 convolutions in full float32 for every comparison (the
    # configs' convolutions run in bf16 and are not affected)
    torch.backends.cudnn.allow_tf32 = False
    phase_threefry(dev)
    main_row, rows = phase_head(dev)
    bwd_row, bwd_rows = phase_head_bwd(dev)
    eval_launches, img_s, prof = phase_slice(dev)
    launches, summary, train_prof, trainer, state = phase_train(dev)
    phase_xcheck(dev, trainer, state)
    wide_row, wide_rows = phase_head_wide(dev)
    boundary_launches, boundary_rows = phase_boundary(dev)
    (cifar_launches, cifar_summary, cifar_prof, cifar_trainer,
     cifar_state) = phase_cifar_train(dev)
    phase_xcheck(dev, cifar_trainer, cifar_state, CIFAR_XCHECK_STEPS,
                 'cifar_xcheck')

    kernels = [{
        'name': 'fused_elbo_fwd', 'route': 'cuda',
        'source': 'gmvae_tpu_torch/csrc/fused_elbo_fwd.cu',
        'replaces': 'gmvae_tpu/ops/kernels/fused_elbo.py:282',
        'also_replaces': 'gmvae_tpu/ops/kernels/fused_elbo.py:159',
        'launches': launches['fused_elbo_fwd'],
        'launches_eval': eval_launches['fused_elbo_fwd'],
        'max_abs_err': main_row['max_abs_err'],
        'device_us': main_row['device_us'],
        'ms': main_row['ms'], 'plain_ms': main_row['plain_ms'],
        'bound_ms': main_row['bound_ms'], 'bound_by': main_row['bound_by'],
        'library_ms': None,
        'device_us_in_eval': prof['head_kernel_device_us'],
        'device_us_in_train': train_prof['fwd_kernel_device_us'],
        'launches_cifar_train': cifar_launches['fused_elbo_fwd'],
        'device_us_in_cifar_train': cifar_prof['fwd_kernel_device_us'],
        'launches_boundary': boundary_launches['fused_elbo_fwd'],
        'shapes': rows,
    }, {
        'name': 'fused_elbo_bwd', 'route': 'cuda',
        'source': 'gmvae_tpu_torch/csrc/fused_elbo_bwd.cu',
        'replaces': 'gmvae_tpu/ops/kernels/fused_elbo_bwd.py:382',
        'also_replaces': 'gmvae_tpu/ops/kernels/fused_elbo_bwd.py:219',
        'launches': launches['fused_elbo_bwd'],
        'max_abs_err': bwd_row['max_abs_err'],
        'device_us': bwd_row['device_us'],
        'ms': bwd_row['ms'], 'call_ms': bwd_row['call_ms'],
        'plain_ms': bwd_row['plain_ms'],
        'bound_ms': bwd_row['bound_ms'], 'bound_by': bwd_row['bound_by'],
        'library_ms': None,
        'device_us_in_train': train_prof['bwd_kernel_device_us'],
        'launches_cifar_train': cifar_launches['fused_elbo_bwd'],
        'device_us_in_cifar_train': cifar_prof['bwd_kernel_device_us'],
        'launches_boundary': boundary_launches['fused_elbo_bwd'],
        'shapes': bwd_rows,
    }, {
        'name': 'wide_head_fwd', 'route': 'cuda',
        'source': 'gmvae_tpu_torch/csrc/wide_head_fwd.cu',
        'replaces': 'tools/bench_head_boundary.py:60',
        'launches': boundary_launches['wide_head_fwd'],
        'max_abs_err': wide_row['max_abs_err'],
        'device_us': wide_row['device_us'],
        'ms': wide_row['ms'], 'call_ms': wide_row['call_ms'],
        'plain_ms': wide_row['plain_ms'],
        'bound_ms': wide_row['bound_ms'], 'bound_by': wide_row['bound_by'],
        'bound_tf32_ms': wide_row['bound_tf32_ms'],
        'bound_tf32_by': wide_row['bound_tf32_by'],
        'library_ms': wide_row['library_ms'],
        'library': 'three torch.matmul + the head kernel (the narrow '
                   'path), its kernels\' device time',
        'shapes': wide_rows,
    }]
    log(f'[slice] eval img/s {img_s}; train img/s (median window) '
        f'{summary["train_img_s_median"]}; cifar_k20 train img/s (windows) '
        f'{cifar_summary["train_img_s_windows"]}')
    print(json.dumps({'kernels': kernels}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
