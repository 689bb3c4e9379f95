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
6. training (``[train]``): ``api.train('mnist_k10')`` at full width for
   TRAIN_STEPS steps (4,000 of the config's 20,000) on the stand-in MNIST
   data, with the launch counts reset just before: the forward kernel once
   per step plus once per eval batch, the backward kernel once per step,
   every step but the trainer's first (the capture's warm-up) replayed
   from the step's CUDA graphs (``training.StepGraphs``; the cifar, sweep
   and celeba phases check the same, the deep phase that none was);
   its evals within DEEP_TRACE_RTOL of the port's full 20,000-step run's
   at the same steps (TRAIN_TRACE); the last eval ELBO within 1% of the
   reference's trained -225.94287109375, ACC and NMI >= 0.85, the ELBO
   rising from the first eval to the last; the img/s of each eval window,
   and a profile of one chunk of steps;
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
    (``[cifar_profile]``); and ``[cifar_xcheck]``, 5 steps GPU vs CPU;
11. the deep mixture (``[deep_train]``): ``api.train('mnist_deepmix')`` at
    full width (1,798,618 parameters) for DEEP_STEPS steps (2,000 of the
    config's 20,000: the smoke must end within 1,200 s) on the stand-in
    MNIST, with the launch counts reset before it: no kernel of the port
    launches on this path; its evals within DEEP_TRACE_RTOL of the port's
    full run's at the same steps; the final eval ELBO within 1% of the
    reference's trained -225.88734436035156, ACC and NMI >= 0.85, the ELBO
    rising; the img/s of each eval window and a profile of one chunk
    (``[deep_profile]``); then ``[deep_xcheck]``, 20 steps GPU vs CPU with
    pi_logits and the prior network as the prior's leaves;
12. serving (``[serving]``): the four verbs of the trained mnist_k10 and
    mnist_deepmix states exported on the card, full and int8, each
    model's artifacts loaded and run in turn in one fresh ``python3`` (the
    two models' at once) that imports torch and numpy and not the port;
    outputs equal to the live API at batches 1, 37 and 128 (assign
    exactly, the rest within rtol 1e-5 / atol 1e-6);
    int8 below 1/2.5 of the full size, its assignments agreeing with the
    full artifact's on >= 99% of 1,000 images; the wall ms a request at
    batch 1 and 128, artifacts against the live API; and artifacts that
    move between devices (``platforms=['cuda', 'cpu']``): the trained
    mnist_k10's assign and latent written in this process on the CPU and
    loaded on the card by a fresh process through ``serving.
    load_program``, and written on the card and loaded on the CPU by
    another, each held to the live API on its device at the same batches
    and limits (those processes run beside [serving]'s own), and
    ``load_program`` with no device putting such an assign artifact, for
    either order of the list, on the card;

13. celeba_dp16 (``[celeba_train]``): ``api.train('celeba_dp16')`` at full
    width (28,691,462 parameters) and its global batch of 1,024 with the
    sharded train set and the per-leaf clip, on the CelebA stand-in, for
    CELEBA_STEPS steps in a one-rank NCCL group that the port's
    ``init_distributed`` starts (the gradient's all-reduce on the path),
    with exact launch counts of the head at (1024, 64, 256), every step but
    the first replayed from the step's CUDA graphs (the all-reduce captured
    in them), and a finite, rising eval ELBO; a profile of one chunk
    (``[celeba_profile]``); and
    ``[celeba_xcheck]``, 3 steps GPU vs CPU at batch 128;
14. ``[dp2]``: mnist_k10 at full width over two ranks on the card
    (``parallel/launch.py``, gloo), 64 rows a rank, 20 steps: both ranks'
    parameters bit-equal, and within DP2_RTOL of the manual shard average
    computed in this process (bit equality recorded);
15. ``[stream]``: mnist_k10 for 200 steps with host-streamed batches
    against device placement, parameters bit-equal, both img/s;
16. ``[cli]``, right after [train] and on its TRAIN_STEPS checkpoint: a
    fresh ``python -m gmvae_tpu_torch eval`` process whose row equals
    [train]'s last eval row bit for bit (its wall time split into import,
    data load, kernel library load and eval); a fresh ``train`` to 400
    steps and a fresh ``train --resume`` to 800, their rows equal to
    [train]'s at those steps bit for bit; in-process ``cli.main`` calls
    (describe: 1,442,996 parameters; configs; assign equal to
    ``api.cluster_assign``; sample, reconstruct and latent PNGs of the
    expected sizes; export, full and int8, through ``load_and_call``
    against the live API; bench in both pipelines); exact launch counts
    in every part;
17. ``[dryrun]``: ``dryrun.dryrun_multichip(2)`` as two gloo ranks on the
    one card: every phase's ELBO finite, streaming bit-equal to device
    placement, both head kernels launched in each rank's fused phase
    (at (8, 2, 4), a shape [head] and [head_bwd] hold against the plain
    versions);
18. ``[sweep_train]`` (after [deep_xcheck]): fmnist_deep, svhn_conv,
    mnist_vae and synthetic_hard, the configs the baseline sweep
    (``gmvae_tpu_torch/tools/reproduce_baselines.py``) first trained on the
    card, each through ``api.train`` at full width for SWEEP_STEPS steps
    (the first eval of its full run), the launch counts set to 0 before
    each: both head kernels at their heads, (128, 10, 64), (128, 10, 128),
    (128, 1, 10) and (128, 10, 10), shapes [head] and [head_bwd] hold
    against the plain versions (at K=1 also y = 1, kl_cat = 0, d_k_logits
    = d_pi = 0 exactly), with exact counts; the eval within
    DEEP_TRACE_RTOL of the full run's at that step (SWEEP_TRACE); at K=1
    kl_cat 0 in every step and every assignment 0; a profile of one chunk
    (``[sweep_profile]``); ``[sweep_xcheck]``, 20 steps GPU vs CPU, for
    fmnist_deep and mnist_vae;
19. ``[parity]`` (after [sweep_train]): ``gmvae_tpu_torch/tools/
    parity_conv.py``'s ``parity_pair`` at fmnist_deep, full width, matched
    noise, PARITY_STEPS steps an arm, the launch counts set to 0 before
    each arm: the fused arm launches both head kernels (exact counts), the
    unfused arm neither; both arms finite and their eval ELBOs within 1%;
20. ``[chaos]``: ``gmvae_tpu_torch/tools/chaos_floor.py``'s command line
    at fmnist_deep, seed 0, CHAOS_STEPS steps, one checkpoint, no kernel
    launched: with ``--eps 0`` the two arms' rows are bit-equal, with
    ``--eps 0.5`` their ELBOs differ;
21. ``[serve_http]`` (after [serving]): the assign and latent artifacts
    of [train]'s mnist_k10 state, exported on the card, each behind
    ``gmvae_tpu_torch/tools/serve_http.py`` on an ephemeral port from a
    thread: healthz, the answers at batches 1, 37 and 128 against the live
    API ([serving]'s limits), 400 for a body that is not npy and for a
    wrong shape, 413 over the cap; the wall ms a request at batches 1 and
    128;
22. ``[roofline]``: ``gmvae_tpu_torch/tools/roofline.py``'s count of one
    training step (FLOPs: GEMMs and convolutions from torch's flop counter,
    the head kernels' own from ``ops/kernels/bounds.py``; bytes: every aten
    op's inputs and outputs, an upper bound) for the trainers of [train],
    [cifar_train], [deep_train] and [celeba_train] (at 1,024, in its NCCL
    group), each with the img/s its phase measured: sustained TFLOP/s, MFU
    against 989 TFLOP/s dense bf16; each count finite and positive,
    mnist_k10's GEMM FLOPs equal to the count from its widths, the MFU in
    (0, 100];
23. ``[profile_attr]``: ``gmvae_tpu_torch/tools/profile_attr.py``'s
    capture of two 50-step chunks (after a warm-up chunk) from [train]'s
    and [celeba_train]'s states and datasets (celeba_dp16 at 1,024, in its
    NCCL group): device time by group over the window, the envelope and
    the idle share, checked against the same trace (shares sum to 100, the
    head group's us equal the fused_elbo kernels' durations within 1%,
    unattributed is the envelope less the busy time);
24. the six measurement tools (after [stream], before [dryrun]), the
    launch counts set to 0 just before each: four through ``main`` (its
    stdout captured, its first line the card's), ``[bench_serving]``
    through ``bench_verbs`` and ``[bench_conv_bound]`` through
    ``conv_only_rate``:
    ``[bench_ab]`` (mnist_k10, 400 steps, one run an arm: finite rates,
    both head kernels once a step of each arm), ``[autotune_scan]``
    (mnist_k10, chunks of 50 and 200: the same), ``[bench_eval]``
    (mnist_k10 on 2,048 test images: the arms bit-equal, the forward
    kernel once a batch of each call), ``[bench_serving]`` ([train]'s
    state, assign and reconstruct at batches 1/128/1,024: p50 <= p90,
    the assign answer at 128 equal to the live API's, no kernel),
    ``[bench_conv_bound]`` (svhn_conv and cifar_k20 at full width: finite
    rates and loss, the parameters moved, no kernel; the device-busy
    share of a traced chunk) and
    ``[bench_gather]`` (the defaults: checksums 1279096595 and
    1279509724, no kernel; each variant's device us a step from a traced
    repeat beside its wall us); their wall time together;
25. ``[dryrun_pod]`` (after [dryrun]): the pod pre-flight's command line
    (``python -m gmvae_tpu_torch.tools.dryrun_pod``) at celeba_dp16 over
    POD_RANKS ranks and at mnist_k10 over POD_STREAM_RANKS ranks with
    host-streamed batches, both at once, all gloo ranks on the one card:
    exit 0, the reference's keys, finite ELBOs, sharded and replicated
    train sets, every rank's head launches exact (at (2, K, D) in
    training: POD_SHAPES,
    which [head] and [head_bwd] hold against the plain versions, as [head]
    holds the eval's POD_EVAL_SHAPES); each run's wall s and the card's
    used memory at the peak of the two, polled from this process.

Float32 convolutions run with TF32 off (``torch.backends.cudnn.
allow_tf32``); the configs' convolutions are bf16. Prints one
``{"kernels": [...]}`` line (the three kernels), the smoke's wall time,
the card's name and power limit, and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero, printing no result, when no CUDA device is
present or the port is not importable.
"""

import contextlib
import io
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

from gmvae_tpu_torch.ops.kernels import _build, bounds
from gmvae_tpu_torch.tools.head_kernel_times import (WIDE_SHAPES,
                                                     wide_bounds_us)
from gmvae_tpu_torch.utils.profiling import device_us, profile_device

PEAK_BYTES = bounds.PEAK_BYTES
MAIN_SHAPE = (128, 10, 10)   # mnist_k10: batch 128, K=10, D=10
# celeba_dp16's head on one card: its whole global batch of 1,024 rows
CELEBA_SHAPE = (1024, 64, 256)
# [dryrun]'s fused phase: synthetic_tiny's head, 8 rows a rank, K=2, D=4
DRYRUN_SHAPE = (8, 2, 4)
# [sweep_train]'s heads: fmnist_deep (D=64), svhn_conv (D=128) and
# mnist_vae (one component; synthetic_hard's is MAIN_SHAPE)
SWEEP_SHAPES = [(128, 10, 64), (128, 10, 128), (128, 1, 10)]
# [dryrun_pod]: the pod pre-flight (tools/dryrun_pod.py) trains 2 rows a
# rank, celeba_dp16's head and mnist_k10's; its eval runs the forward on
# the whole global batch of 2 rows a rank, on every rank
POD_RANKS = 16                   # celeba_dp16, device placement (sharded)
POD_STREAM_RANKS = 4             # mnist_k10, host_stream (replicated)
POD_STEPS = 2
POD_SHAPES = [(2, 64, 256), (2, 10, 10)]
POD_EVAL_SHAPES = [(2 * POD_RANKS, 64, 256), (2 * POD_STREAM_RANKS, 10, 10)]
EXTRA_SHAPES = [(37, 10, 10), (128, 20, 128), (128, 64, 256), CELEBA_SHAPE,
                DRYRUN_SHAPE] + SWEEP_SHAPES
Z_Y_ATOL = 1e-5
SCAL_RTOL = 1e-4             # of max(|plain|, 1)
EVAL_PASSES = 8              # full evals timed back to back for the rate
# backward: each per-row gradient entry (d_k_logits, d_q_means,
# d_q_logvars) within GRAD_ATOL, or GRAD_RTOL of max(|plain|, 1); the
# prior gradients (batch sums over B rows) within PRIOR_RTOL of the
# tensor's max(|plain|, 1), since an entry can cancel to near 0 from terms
# of the tensor's size. Where K*D >= ROW_TOL_KD a per-row entry is
# a difference of sums over thousands of terms, so its float32 error
# scales with its row's largest terms, not with the entry: there the
# GRAD_RTOL is of the batch row's max(|plain|, 1). Every row also prints
# each version's error against manual_bwd in float64, per gradient, as a
# share of the same tolerance: on an H100, up to 1.24 for both the kernel
# and the plain version at (128,64,256) with a hard y, so GRAD_RTOL is
# near float32's reach there. Autograd of the plain forward, a third
# float32 order of operations, is up to 3.4 off float64 at that shape: at
# such shapes it is held to AUTOGRAD_RTOL. Every row also prints its
# per-element share, the default rule's, beside the per-row one. A pod
# rank's (2, 64, 256) (POD_SHAPES) is held per element all the same: its
# two rows give the error few draws (on an H100 at most 0.48 of that
# tolerance against the plain version, 0.86 against autograd).
GRAD_ATOL = 1e-5
GRAD_RTOL = 1e-4
PRIOR_RTOL = 1e-4
AUTOGRAD_RTOL = 4e-4
ROW_TOL_KD = 2560
# At celeba_dp16's (1024, 64, 256) eight times the rows give the largest
# per-row error more draws: against manual_bwd in float64, every float32
# version lands past GRAD_RTOL on d_k_logits (on an H100: the kernel up to
# 1.91 of it, the plain version 1.84, autograd 1.76), so two float32
# versions can differ by ~3.7 of it. There the kernel is held to the plain
# version evaluated in float64, each gradient within the larger of
# GRAD_RTOL and F64_MARGIN times the float32 plain version's own error:
# no less accurate than its plain version. The float32 comparisons are
# printed beside it. So too at the sweep's heads with D >= 64
# (F64_SPREAD_SHAPES), where d_k_logits takes (dy - sum_k y dy) y / tau,
# dy a sum over D products, and the float32 versions themselves spread
# around float64 past GRAD_RTOL: every case within F64_MARGIN of the
# card's plain version, with manual_bwd on the host's CPU and autograd of
# the plain forward printed beside it. The backward recomputes the
# mixture, z and the component log-densities in float64 for this
# (csrc/head_row.cuh:row_forward); y stays the forward's float32, and its
# rounding is most of what error is left (PERF.md §6).
F64_SPREAD_SHAPES = {(128, 10, 64), (128, 10, 128)}
F64_REF_SHAPES = {CELEBA_SHAPE} | F64_SPREAD_SHAPES
F64_MARGIN = 1.25
ORACLE_ELBO = -225.94287109375   # the reference's trained mnist_k10 ELBO
# [train] runs TRAIN_STEPS of mnist_k10's 20,000 steps so that the smoke
# ends well within its 1,200 s on the slowest hosts: its evals at 2,000 and
# 4,000 steps must retrace the port's full 20,000-step run on the card,
# whose evals there TRAIN_TRACE holds (``python -m gmvae_tpu_torch train
# --config mnist_k10``, one H100, with the backward that sums the prior
# gradients over a grid of min(B, P) blocks; that run's last eval is
# -225.9057, 1.6e-4 from ORACLE_ELBO, as the earlier clusters' run's
# -225.9063 was), each within DEEP_TRACE_RTOL as [deep_train]'s are. A
# new order of that batch sum moved the eval at 2,000 by 1.8e-3 (PERF.md
# §6), so the trace belongs to the sum's order and is taken again when
# the order changes. It
# evaluates every TRAIN_EVAL_EVERY steps, so that [cli]'s fresh processes
# have rows to equal at CLI_TRAIN_STEPS.
TRAIN_STEPS = 4000
TRAIN_EVAL_EVERY = 400
TRAIN_TRACE = {2000: -228.40269470214844, 4000: -226.37612915039062}
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
CIFAR_STEPS = 1000           # [cifar_train]: api.train('cifar_k20') steps
CIFAR_PROFILE_STEPS = 20
CIFAR_XCHECK_STEPS = 5       # GPU-vs-CPU cifar_k20 training steps
# [deep_train]: api.train('mnist_deepmix') at full width, its trained ELBO
# against the reference's, ACC/NMI against mnist_k10's limits. The smoke
# must end within 1,200 s, builds included, and aims at half of that. The
# config's 20,000 steps take 350-700 s on one H100 as fast as its host
# dispatches (PERF.md §2, §4), so the smoke trains DEEP_STEPS of them, and
# the evals of that cut run (every DEEP_EVAL_EVERY steps) must retrace the
# port's full 20,000-step run: DEEP_TRACE holds its evals at those steps,
# the same bits in every run on the card so far (the eval at 1,000 from
# ``python -m gmvae_tpu_torch train --config mnist_deepmix --set
# steps=2000 --set eval_every=1000``, which prints four decimals; the
# evals change no training state). How far other runs land from them
# (the larger of the two relative distances; one H100 80GB HBM3 at 700 W,
# ``gmvae_tpu_torch/tools/deep_trace.py``): compute in float32 1.5e-3,
# another seed 2.0e-3, the balance regularizer off 3.7e-3. A changed order
# of one float32 sum moved mnist_k10's 20k ELBO by 6.6e-5 (PERF.md §6).
DEEP_STEPS = 2000
DEEP_EVAL_EVERY = 1000
DEEP_TRACE = {1000: -228.6979, 2000: -227.5443572998047}
DEEP_TRACE_RTOL = 5e-4
DEEP_ORACLE_ELBO = -225.88734436035156
DEEP_PARAMS = 1_798_618
# [deep_xcheck]: the deep family's prior, pi_logits and the prior network
DEEP_PRIOR_LEAVES = ('pi_logits',) + tuple(
    f'{m}.{leaf}'
    for m in ('prior_trunk', 'prior_mean_head', 'prior_logvar_head')
    for leaf in ('weight', 'bias'))
# [sweep_train]: the four configs the baseline sweep first trained on the
# card (``python -m gmvae_tpu_torch.tools.reproduce_baselines``), each
# through ``api.train`` at full width for SWEEP_STEPS steps: the first eval
# of its full run (eval_every 2,000). SWEEP_TRACE holds that full run's
# eval ELBO at step 2,000 (PERF.md §2 and §6), held to DEEP_TRACE_RTOL
# as [deep_train]'s evals are; the two MLP configs with a new head shape
# also run [xcheck] on their trained state. The values are 2,000-step
# runs' of the backward that sums over a grid of min(B, P) blocks
# (``python -m gmvae_tpu_torch train --config NAME --set steps=2000``, one
# H100): the schedules depend on the step alone, so such a run is its full
# run's first 2,000 steps (the earlier kernel's 2,000-step runs gave its
# recorded svhn_conv value and mnist_k10's TRAIN_TRACE at 2,000 to the
# last bit, synthetic_hard's within 5.4e-5). That order of the batch sum
# moved them from the clusters' by 3.8e-4 (fmnist_deep), 4.3e-4
# (mnist_vae), 1.9e-3 (synthetic_hard) and 14% (svhn_conv), as another
# seed moves the last two by 5.5e-3 and 10%: they too belong to the sum's
# order.
SWEEP_STEPS = 2000
SWEEP_TRACE = {'fmnist_deep': -227.35435485839844,
               'svhn_conv': 3599.569580078125,
               'mnist_vae': -231.22164916992188,
               'synthetic_hard': -539.3593139648438}
SWEEP_XCHECK = ('fmnist_deep', 'mnist_vae')
SWEEP_PROFILE_STEPS = 20
# [serving]: artifacts against the live API at these batches (the
# reference test's tolerances), int8 assignments against the full
# artifact's over SERVE_AGREE_N images, latency at SERVE_TIME_BATCHES
SERVE_BATCHES = (1, 37, 128)
SERVE_AGREE_N = 1000
SERVE_TIME_BATCHES = (1, 128)
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6
# [serve_http]: the assign and latent artifacts of [train]'s state behind
# ``tools/serve_http.py``, each from a thread on an ephemeral port, with a
# body cap above a batch of 128 MNIST images (401 KB) and below SERVE_BIG
SERVE_HTTP_VERBS = ('assign', 'latent')
SERVE_HTTP_CAP = 512 * 1024
SERVE_BIG = 256
INT8_SIZE_RATIO = 2.5
# [serving]'s artifacts that move between devices: these verbs of
# [train]'s mnist_k10 state, listed for XDEV_PLATFORMS
XDEV_VERBS = ('assign', 'latent')
XDEV_PLATFORMS = ['cuda', 'cpu']
INT8_AGREE = 0.99
# [parity]: ``tools/parity_conv.py``'s parity_pair at fmnist_deep, full
# width, matched noise, cut from the PLAN's 20,000 steps to PARITY_STEPS,
# each arm evaluated on its first PARITY_EVAL test images, within 1%
PARITY_CONFIG = 'fmnist_deep'
PARITY_STEPS = 500
PARITY_EVAL = 2000
# [chaos]: ``tools/chaos_floor.py`` at fmnist_deep, seed 0, CHAOS_STEPS
# steps and one checkpoint: --eps 0 leaves the arms bit-equal, a large
# --eps moves the perturbed arm
CHAOS_STEPS = 200
CHAOS_EPS = 0.5
# [celeba_train]: api.train('celeba_dp16') at full width and its global
# batch of 1,024, in a one-rank NCCL group. The config's 20,000 steps do
# not fit the smoke's 1,200 s: CELEBA_STEPS of them, evals half way and at
# the end (PERF.md §4 gives the measured ms a step behind the cut)
CELEBA_STEPS = 1000
CELEBA_PARAMS = 28_691_462
CELEBA_PROFILE_STEPS = 10
# [celeba_xcheck]: GPU vs CPU at batch 128 (the CPU cannot take 1,024
# rows at these widths inside the time limit), [cifar_xcheck]'s limits
CELEBA_XCHECK_STEPS = 3
CELEBA_XCHECK_BATCH = 128
# [roofline]: one training step's FLOPs and bytes (gmvae_tpu_torch/tools/
# roofline.py's count_step) of the trainers the smoke builds, with the img/s
# each phase measured: MFU against dense bf16, each count finite and
# positive, mnist_k10's GEMM FLOPs equal to the count from its widths.
# [profile_attr]: gmvae_tpu_torch/tools/profile_attr.py's capture of
# PROFILE_ATTR_CHUNKS chunks of PROFILE_ATTR_STEPS steps (after a warm-up
# chunk) from [train]'s and [celeba_train]'s states and datasets; the group
# shares sum to 100 within GROUP_PCT_ATOL, the head group's us equal the
# fused_elbo kernels' durations in the same trace within 1%, unattributed
# equals the envelope less the busy time
PROFILE_ATTR_CHUNKS = 2
PROFILE_ATTR_STEPS = 50
GROUP_PCT_ATOL = 0.1
# [dp2]: two ranks on the one card (gloo: NCCL refuses two ranks on one
# device), mnist_k10 at full width, 64 rows a rank, against the manual
# shard average in one process; parameters within DP2_RTOL of the largest
DP2_STEPS = 20
DP2_RTOL = 1e-6
DP2_TIMEOUT = 300.0
# [cli]: the CLI on [train]'s checkpoint; fresh processes and in-process
# calls; the bench's steps in each pipeline (cut before any check is)
CLI_BENCH_STEPS = 400   # the verb's default is 2,000: cut to keep [cli] short
CLI_TRAIN_STEPS = (400, 800)     # a fresh train, then a fresh resume
CLI_TIMEOUT = 300.0              # seconds a fresh CLI process may take
CLI_ROW_KEYS = ('elbo_nats', 'iwae_nats', 'acc', 'nmi')
# [dryrun]: dryrun_multichip(2), two gloo ranks on the one card
DRYRUN_RANKS = 2
DRYRUN_STEPS = 2                 # the fused phase's steps on each rank
# [stream]: mnist_k10, host-streamed batches against device placement
STREAM_STEPS = 200
STREAM_CHUNK = 50
# the six measurement tools' phases (after [stream], before [dryrun]), the
# launch counts set to 0 just before each; together they aim at 60 s
BENCH_AB_STEPS = 400             # [bench_ab]: mnist_k10, one run an arm
AUTOTUNE_GRID = (50, 200)        # [autotune_scan]: mnist_k10
AUTOTUNE_STEPS = 400
BENCH_EVAL_EXAMPLES = 2048       # [bench_eval]: mnist_k10's test set cut
BENCH_EVAL_REPEATS = 2
BENCH_SERVING_VERBS = ('assign', 'reconstruct')   # [bench_serving]
BENCH_SERVING_BATCHES = (1, 128, 1024)
BENCH_SERVING_ITERS = 20
CONV_BOUND_CONFIGS = ('svhn_conv', 'cifar_k20')  # [bench_conv_bound]
CONV_BOUND_STEPS = 200
CONV_BOUND_INNER = 100
GATHER_REPEATS = 5               # [bench_gather]: the tool's defaults else
GATHER_DEFAULTS = (60_000, (28, 28, 1), 128, 100)   # n, shape, batch, steps
# the sums of the bytes the defaults gather (n 60,000, 28x28x1, batch 128,
# 100 steps), from the reference tool's definition in numpy
GATHER_CHECKSUM = 1279096595
GATHER_CONTIG_CHECKSUM = 1279509724


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def log(msg):
    print(msg, flush=True)


def elapsed(t_start):
    """Log the smoke's wall time so far (the phases' share of the 1,200 s
    limit)."""
    log(f'[elapsed] {time.perf_counter() - t_start:.1f} s')


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
    """Least time for the head's work (``bounds.head_fwd_work``)."""
    return bounds.bound_ms(bounds.head_fwd_work(b, k, d, streamed))


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
    pod = POD_SHAPES + POD_EVAL_SHAPES
    cases += [(s, False, False, 1.0) for s in pod]
    cases += [(s, True, True, 0.7) for s in pod]
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
            if k == 1:
                # a softmax over one component: y is 1 and the KL 0 exactly
                check(bool((got.y == 1).all() and (got.kl_cat == 0).all()),
                      f'y != 1 or kl_cat != 0 at {(b, k, d)}')
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
    """Least time for the head backward's work (``bounds.head_bwd_work``);
    and, apart, the time of the kernel's own scratch traffic (one
    prior-gradient partial per block, written and read back), which the
    function does not need."""
    part = _build.library().gmvae_fused_elbo_bwd_scratch(b, k, d)
    ms, by = bounds.bound_ms(bounds.head_bwd_work(b, k, d, streamed))
    return ms, by, 1e3 * 4 * 2 * part / PEAK_BYTES


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
    # every mode at each shape; at the celeba shape, whose launches take
    # milliseconds, soft y with in-kernel noise and hard y with streamed
    cases = [(shape, hard, streamed)
             for shape in [MAIN_SHAPE] + EXTRA_SHAPES + POD_SHAPES
             for hard in (False, True) for streamed in (False, True)
             if shape != CELEBA_SHAPE or hard == streamed]
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
        if k == 1:
            # the softmax's Jacobian over one entry is 0: no gradient
            # reaches k_logits or pi_logits
            check(bool((got.d_k_logits == 0).all() and (got.d_pi == 0).all()),
                  f'd_k_logits or d_pi not 0 at {(b, k, d)}')
        what = f'{(b, k, d)} hard={hard} streamed={streamed}'
        per_row = k * d >= ROW_TOL_KD and (b, k, d) not in POD_SHAPES
        f64_ref = (b, k, d) in F64_REF_SHAPES
        if f64_ref:
            shares, err = grad_errors(got, ref, per_row)
            share = max(shares.values())
        else:
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
        loosen = AUTOGRAD_RTOL / GRAD_RTOL if per_row else 1.0
        if f64_ref:
            shares_auto, err_auto = grad_errors(got, auto, per_row)
            share_auto = max(shares_auto.values()) / loosen
        else:
            err_auto, share_auto = compare_grads(
                got, auto, what + ' vs autograd', per_row, loosen)
        # the default rule's shares, printed beside the per-row ones
        elem = {name: max(grad_errors(got, r, False)[0].values())
                for name, r in (('plain', ref), ('autograd', auto))}
        versions = [('kernel', got), ('plain', ref), ('autograd', auto)]
        if (b, k, d) in F64_SPREAD_SHAPES:
            cpu = lambda x: x.cpu()  # noqa: E731
            ref_cpu = fused_elbo_bwd.manual_bwd(
                *map(cpu, (g, eps, kl, qm, qlv, *prior)), tau,
                *map(cpu, (cs, cz, cy)), hard=hard)
            versions.append(('plain_cpu', [x.to(dev) for x in ref_cpu]))
        f64_shares = {name: grad_errors(grads, exact, per_row)[0]
                      for name, grads in versions}
        if f64_ref:
            for name, kern_share in f64_shares['kernel'].items():
                plain_share = f64_shares['plain'][name]
                check(kern_share <= max(1.0, F64_MARGIN * plain_share),
                      f'{what}: {name} is {kern_share} of its tolerance from '
                      f'float64, the plain version {plain_share}')
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
        # milliseconds a launch at the celeba shape: fewer launches timed
        n_t = 20 if (b, k, d) == CELEBA_SHAPE else 200
        ms = cuda_ms(lambda: launch(*bare_args), n_t)
        dev_us = launch_device_us(lambda: launch(*bare_args), n_t)
        call_ms = cuda_ms(kern, n_t)
        fn_ms = cuda_ms(lambda: torch.autograd.grad(loss, ins,
                                                    retain_graph=True),
                        n_t // 4)
        plain_ms = cuda_ms(plain, 10)
        bound, by, scratch_ms = bwd_bound_ms(b, k, d, streamed)
        row = dict(shape=[b, k, d], hard=hard,
                   noise='streamed' if streamed else 'threefry', tau=tau,
                   tol=('float64_plain' if f64_ref else 'per_row'
                        if per_row else 'per_element'),
                   max_abs_err=err, max_abs_err_vs_autograd=err_auto,
                   err_share_of_tol=share,
                   autograd_err_share_of_tol=share_auto,
                   per_element_share_of_tol=elem,
                   f64_err_share_of_tol=f64_shares,
                   device_us=dev_us,
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


def train_and_profile(dev, cfg, tag, profile_steps, dataset=None,
                      run_dir=None):
    """``api.train(cfg)`` in ``run_dir`` (kept for the caller) or a scratch
    run directory, the launch counts set
    to 0 just before it and read just after; its eval rows logged under
    ``[tag]``; then one chunk of ``profile_steps`` steps after the last,
    warmed and profiled. Returns (launches, hist, wall_s, trainer, state,
    prof, by_name): ``prof`` holds the chunk's wall time, device-busy
    share, kernels a step, device us a step by ``_kernel_group`` and the
    top kernels; each phase adds its own keys and logs it."""
    from gmvae_tpu_torch import api

    with contextlib.ExitStack() as stack:
        if run_dir is None:
            run_dir = stack.enter_context(tempfile.TemporaryDirectory())
        torch.cuda.synchronize()
        for name in _build.LAUNCHES:
            _build.LAUNCHES[name] = 0
        _build.REPLAYS['train_step'] = 0
        t0 = time.perf_counter()
        trainer, state, hist = api.train(cfg, dataset=dataset, device=dev,
                                         run_dir=run_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES,
                        replays=_build.REPLAYS['train_step'])
        ckpts = sorted(os.listdir(os.path.join(run_dir, cfg.name)))
    n_params = sum(p.numel() for p in state.params.values())
    log(f'[{tag}] {cfg.steps} steps of {cfg.name} ({n_params} parameters) '
        f'in {wall:.1f} s (evals and checkpoints included); launches '
        f'{json.dumps(launches)}; run dir {ckpts}')
    for row in hist:
        log(f'[{tag}] {json.dumps({k: v for k, v in row.items() if k != "time"})}')
    check(state.step == cfg.steps, f'trained to step {state.step}')

    idx = trainer.batch_plan(profile_steps, start_step=cfg.steps)
    trainer.run_chunk(state, idx)                 # warm, same shapes
    wall_p, busy, n_kernels, by_name = profile_device(
        lambda: trainer.run_chunk(state, idx))
    per_step = {}
    for name, (n, us) in by_name.items():
        c = _kernel_group(name)
        per_step[c] = per_step.get(c, 0.0) + us / profile_steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    prof = dict(steps=profile_steps, wall_s=wall_p, device_busy_s=busy,
                device_busy_share=busy / wall_p,
                step_ms=1e3 * wall_p / profile_steps,
                img_s=profile_steps * cfg.batch_size / wall_p,
                device_us_per_step=1e6 * busy / profile_steps,
                device_kernels_per_step=n_kernels / profile_steps,
                device_us_per_step_by_class=per_step,
                top=[dict(name=k[:90], launches=n, device_us=us)
                     for k, (n, us) in top])
    return launches, hist, wall, trainer, state, prof, by_name


def trained_quality(tag, cfg, hist, wall, oracle, n_params=None):
    """The checks every trained config meets: finite metrics at the last
    eval, the ELBO rising from the first eval to it, the ELBO within
    ORACLE_RTOL of the reference's trained ``oracle``, ACC and NMI at
    least MIN_ACC_NMI. Logs and returns the summary."""
    final, first = hist[-1], hist[0]
    for name in ('elbo_nats', 'iwae_nats', 'acc', 'nmi'):
        check(math.isfinite(final[name]), f'{name} = {final[name]}')
    rel = abs(final['elbo_nats'] - oracle) / abs(oracle)
    rates = [r['img_per_sec_per_chip'] for r in hist[1:]]
    summary = dict(steps=cfg.steps, wall_s=wall, params=n_params,
                   final_elbo=final['elbo_nats'], oracle_elbo=oracle,
                   elbo_rel_to_oracle=rel, acc=final['acc'],
                   nmi=final['nmi'], first_eval_elbo=first['elbo_nats'],
                   train_img_s_windows=rates,
                   train_img_s_median=statistics.median(rates) if rates
                   else None)
    log(f'[{tag}] summary {json.dumps(summary)}')
    check(final['elbo_nats'] > first['elbo_nats'],
          f'{cfg.name}: the ELBO did not rise from the first eval to the last')
    check(rel <= ORACLE_RTOL, f'{cfg.name}: trained ELBO '
          f'{final["elbo_nats"]} is {rel:.4f} from the reference\'s {oracle}')
    check(final['acc'] >= MIN_ACC_NMI and final['nmi'] >= MIN_ACC_NMI,
          f'{cfg.name}: ACC {final["acc"]} / NMI {final["nmi"]} under '
          f'{MIN_ACC_NMI}')
    return summary


def check_trace(tag, hist, trace):
    """A cut run's evals at the steps of ``trace`` and no others, each
    within DEEP_TRACE_RTOL of the full run's ELBO there."""
    evals = {int(r['step']): r['elbo_nats'] for r in hist}
    check(set(evals) == set(trace),
          f'[{tag}] evals at {sorted(evals)}, the full run\'s at '
          f'{sorted(trace)}')
    trace_rel = {s: abs(evals[s] - e) / abs(e) for s, e in trace.items()}
    log(f'[{tag}] relative distance from the full run\'s evals: '
        f'{json.dumps(trace_rel)} (limit {DEEP_TRACE_RTOL})')
    check(max(trace_rel.values()) <= DEEP_TRACE_RTOL,
          f'[{tag}] the run left the full run\'s trajectory: {trace_rel}')


def check_replays(cfg, launches, replayed=True):
    """Every step of ``api.train`` replayed from the step's CUDA graphs but
    the trainer's first, which runs eagerly as the capture's warm-up, where
    ``replayed``; else none (the config stays eager)."""
    want = cfg.steps - 1 if replayed else 0
    check(launches['replays'] == want,
          f'{cfg.name}: {launches["replays"]} steps replayed, expected '
          f'{want}')


def check_head_launches(cfg, launches, hist, n_test, persistent=False):
    """The forward kernel once a step and once an eval batch, the backward
    once a step; its blocks taking several rows each (B > P) on every step
    where ``persistent`` (celeba_dp16's 1,024 rows), else on none (a
    128-row batch, a block a row)."""
    n_eval = math.ceil(n_test / cfg.batch_size) * max(1, cfg.eval_samples)
    want_fwd = cfg.steps + len(hist) * n_eval
    check(launches['fused_elbo_fwd'] == want_fwd,
          f'forward kernel launched {launches["fused_elbo_fwd"]} times, '
          f'expected {want_fwd}')
    check(launches['fused_elbo_bwd'] == cfg.steps,
          f'backward kernel launched {launches["fused_elbo_bwd"]} times, '
          f'expected {cfg.steps}')
    want_rows = cfg.steps if persistent else 0
    check(launches['fused_elbo_bwd_persistent'] == want_rows,
          f'backward kernel took several rows a block '
          f'{launches["fused_elbo_bwd_persistent"]} times, expected '
          f'{want_rows}')


def phase_train(dev, run_dir):
    """mnist_k10 trained through ``api.train`` at full width for
    TRAIN_STEPS steps into ``run_dir``, its evals retracing the full run's
    (TRAIN_TRACE); the main path of the first slices."""
    from gmvae_tpu_torch import configs

    cfg = configs.mnist_k10(steps=TRAIN_STEPS, eval_every=TRAIN_EVAL_EVERY)
    launches, hist, wall, trainer, state, prof, by_name = train_and_profile(
        dev, cfg, 'train', PROFILE_STEPS, run_dir=run_dir)
    check_head_launches(cfg, launches, hist, len(trainer.dataset.test_x))
    check_replays(cfg, launches)
    summary = trained_quality('train', cfg, hist, wall, ORACLE_ELBO)
    check_trace('train', [r for r in hist if r['step'] in TRAIN_TRACE],
                TRAIN_TRACE)

    def per_launch_us(name):
        n, us = device_us(by_name, name)
        return us / n if n else None
    prof.update(fwd_kernel_device_us=per_launch_us('fused_elbo_fwd_kernel'),
                bwd_kernel_device_us=per_launch_us('fused_elbo_bwd_kernel'))
    log(f'[train_profile] {json.dumps(prof)}')
    return launches, summary, prof, trainer, state, hist


def phase_xcheck(dev, trainer, state, steps=XCHECK_STEPS, tag='xcheck',
                 prior_leaves=PRIOR_LEAVES, batch_size=None):
    """The same ``steps`` training steps on the card and on the CPU, from
    the same state (parameters and Adam moments, as a checkpoint holds
    them), plan and keys, at the config's batch or ``batch_size``. Fresh
    moments would make the first step move every parameter by about lr, a
    shock after which a trained cifar_k20's ELBO falls from thousands of
    nats to minus hundreds of thousands on both devices, and the
    comparison would measure that chaos."""
    from gmvae_tpu_torch import training

    cfg = trainer.cfg.replace(metrics_mode='stacked',
                              batch_size=batch_size or trainer.cfg.batch_size)
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
    check(all(k in diff for k in prior_leaves), 'prior leaves not found')
    diffs = torch.cat(list(diff.values()))
    prior = torch.cat([diff[k] for k in prior_leaves])
    row = dict(steps=steps, batch=cfg.batch_size,
               elbo_gpu=m_gpu['elbo'].tolist(),
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
        rel = AUTOGRAD_RTOL if k * d >= ROW_TOL_KD else GRAD_RTOL
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
                           'fused_elbo_bwd_persistent': 0,
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


def _kernel_group(name):
    """A kernel's group in ``profile_attr.GROUP_RULES`` (no provenance: the
    profile here keeps kernel names only, so the optimizer's and the data
    gather's kernels count as elementwise)."""
    from gmvae_tpu_torch.tools.profile_attr import classify
    return classify(name, 'kernel')


def gemm_device_us(fn, reps=20):
    """Device us a call of ``fn`` spends in GEMM kernels (profiler)."""
    fn()
    _, _, _, by_name = profile_device(lambda: [fn() for _ in range(reps)])
    return sum(us for name, (_, us) in by_name.items()
               if _kernel_group(name) == 'matmul') / reps


def phase_cifar_train(dev):
    """cifar_k20 at full width through ``api.train`` on the stand-in,
    launch counts from 0."""
    from gmvae_tpu_torch import configs, data
    t0 = time.perf_counter()
    ds = data.load('cifar10')
    log(f'[cifar_train] data {ds.source!r}: {ds.train_x.shape} train, '
        f'{ds.test_x.shape} test, made in {time.perf_counter() - t0:.1f} s')
    cfg = configs.cifar_k20(steps=CIFAR_STEPS, eval_every=CIFAR_STEPS // 2)
    launches, hist, wall, trainer, state, prof, by_name = train_and_profile(
        dev, cfg, 'cifar_train', CIFAR_PROFILE_STEPS, dataset=ds)
    n_params = sum(p.numel() for p in state.params.values())
    check_head_launches(cfg, launches, hist, len(ds.test_x))
    check_replays(cfg, launches)
    for row in hist:
        for name in ('elbo_nats', 'iwae_nats', 'acc', 'nmi'):
            check(math.isfinite(row[name]), f'{name} = {row[name]}')
    check(hist[-1]['elbo_nats'] > hist[0]['elbo_nats'],
          'the cifar_k20 ELBO did not rise from the first eval to the last')
    rates = [r['img_per_sec_per_chip'] for r in hist]

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
    busy_us = prof['device_us_per_step']
    per_step = prof['device_us_per_step_by_class']
    # the three boundary tensors, written and read once each way a step
    boundary_bytes = 2 * 2 * 4 * b * (k + 2 * k * d)
    boundary_us = 1e6 * boundary_bytes / PEAK_BYTES
    # the head kernels in the step, and the head GEMMs timed alone
    head_path_us = (per_step.get('head_kernel', 0.0) + gemm_fwd_us
                    + gemm_bwd_us)
    prof.update(fwd_kernel_device_us=device_us(
                    by_name, 'fused_elbo_fwd_kernel')[1] / CIFAR_PROFILE_STEPS,
                bwd_kernel_device_us=device_us(
                    by_name, 'fused_elbo_bwd_kernel')[1] / CIFAR_PROFILE_STEPS,
                head_gemms_fwd_device_us=gemm_fwd_us,
                head_gemms_bwd_device_us=gemm_bwd_us,
                head_path_share=head_path_us / busy_us,
                boundary_bytes_per_step=boundary_bytes,
                boundary_bytes_us_at_peak=boundary_us,
                boundary_bytes_share=boundary_us / busy_us)
    log(f'[cifar_profile] {json.dumps(prof)}')
    summary = dict(steps=cfg.steps, wall_s=wall, params=n_params,
                   first_eval_elbo=hist[0]['elbo_nats'],
                   final_elbo=hist[-1]['elbo_nats'], acc=hist[-1]['acc'],
                   nmi=hist[-1]['nmi'], train_img_s_windows=rates)
    log(f'[cifar_train] summary {json.dumps(summary)}')
    return launches, summary, prof, trainer, state


def phase_deep_train(dev):
    """mnist_deepmix at full width through ``api.train`` on the MNIST
    stand-in, launch counts from 0: the deep family runs no kernel of the
    port's own. Its evals retrace the port's full-length run
    (``DEEP_TRACE``) and the last one meets the reference's limits."""
    from gmvae_tpu_torch import configs
    cfg = configs.mnist_deepmix(steps=DEEP_STEPS, eval_every=DEEP_EVAL_EVERY)
    launches, hist, wall, trainer, state, prof, _ = train_and_profile(
        dev, cfg, 'deep_train', PROFILE_STEPS)
    n_params = sum(p.numel() for p in state.params.values())
    check(n_params == DEEP_PARAMS, f'{n_params} parameters')
    check(not any(launches.values()),
          f'a kernel launched on the deep path: {launches}')
    check_replays(cfg, launches, replayed=False)
    summary = trained_quality('deep_train', cfg, hist, wall,
                              DEEP_ORACLE_ELBO, n_params)
    check_trace('deep_train', hist, DEEP_TRACE)
    log(f'[deep_profile] {json.dumps(prof)}')
    return launches, summary, prof, trainer, state


def phase_sweep_train(dev):
    """fmnist_deep, svhn_conv, mnist_vae and synthetic_hard at full width
    through ``api.train`` for SWEEP_STEPS steps each on their stand-ins,
    the launch counts set to 0 before each: both head kernels on each path
    (exact counts), the eval within DEEP_TRACE_RTOL of the full run's at
    the same step (SWEEP_TRACE); at K=1 (mnist_vae) kl_cat is 0 in every
    step and every test image is assigned cluster 0; GPU-vs-CPU cross-checks
    of SWEEP_XCHECK."""
    from gmvae_tpu_torch import api, configs
    launches, summaries = {}, {}
    for name, full_run in SWEEP_TRACE.items():
        cfg = configs.get_config(name, steps=SWEEP_STEPS)
        n, hist, wall, trainer, state, prof, by_name = train_and_profile(
            dev, cfg, 'sweep_train', SWEEP_PROFILE_STEPS)
        n_test = len(trainer.dataset.test_x)
        check_head_launches(cfg, n, hist, n_test)
        check_replays(cfg, n)
        check([int(r['step']) for r in hist] == [SWEEP_STEPS],
              f'{name}: evals at {[r["step"] for r in hist]}')
        row = hist[-1]
        for key in ('elbo_nats', 'iwae_nats', 'acc', 'nmi'):
            check(math.isfinite(row[key]), f'{name}: {key} = {row[key]}')
        rel = abs(row['elbo_nats'] - full_run) / abs(full_run)
        summary = dict(config=name, steps=cfg.steps, wall_s=wall,
                       params=sum(p.numel() for p in state.params.values()),
                       head_shape=[cfg.batch_size, cfg.n_components,
                                   cfg.latent_dim],
                       elbo=row['elbo_nats'], full_run_elbo=full_run,
                       elbo_rel_to_full_run=rel, acc=row['acc'],
                       nmi=row['nmi'], launches=n,
                       img_s=row['img_per_sec_per_chip'],
                       fwd_kernel_device_us=device_us(
                           by_name, 'fused_elbo_fwd_kernel')[1]
                       / SWEEP_PROFILE_STEPS,
                       bwd_kernel_device_us=device_us(
                           by_name, 'fused_elbo_bwd_kernel')[1]
                       / SWEEP_PROFILE_STEPS)
        if cfg.n_components == 1:
            _, m = trainer.run_chunk(state, trainer.batch_plan(
                SWEEP_PROFILE_STEPS, start_step=cfg.steps))
            ids = api.cluster_assign(trainer, state, trainer.dataset.test_x)
            check(bool((m['kl_cat'] == 0).all()), f'{name}: kl_cat '
                  f'{m["kl_cat"].tolist()} at K=1')
            check(bool((ids == 0).all()), f'{name}: assignments other than '
                  f'0 at K=1: {np.bincount(ids).tolist()}')
            summary.update(kl_cat=m['kl_cat'].tolist(),
                           assignments=np.bincount(ids).tolist())
        log(f'[sweep_train] summary {json.dumps(summary)}')
        log(f'[sweep_profile] {name} {json.dumps(prof)}')
        check(rel <= DEEP_TRACE_RTOL, f'{name}: eval at {SWEEP_STEPS} is '
              f'{rel} from the full run\'s {full_run}')
        if name in SWEEP_XCHECK:
            phase_xcheck(dev, trainer, state, XCHECK_STEPS,
                         f'sweep_xcheck {name}')
        launches[name], summaries[name] = n, summary
        del trainer, state
    return launches, summaries


# a model's artifacts checked, or timed, in turn in a fresh process that
# has torch and numpy and refuses to import the port
_SERVE_CHILD = r'''
import json, sys, time

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('gmvae_tpu_torch', 'gmvae_tpu', 'jax',
                                  'chip_smoke'):
            raise ImportError(f'the serving side imported {name}')
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch

mode, dev, x = sys.argv[1], sys.argv[2], np.load(sys.argv[3])

def run(prog, n):
    with torch.no_grad():
        out = prog(torch.from_numpy(x[:n]).to(dev))
    return [o.cpu().numpy() for o in (out if isinstance(out, (tuple, list))
                                      else (out,))]

if mode == 'check':
    for art in json.loads(sys.argv[4]):
        prog = torch.export.load(art).module()
        np.savez(art + '.npz', **{f'{n}_{i}': o
                                  for n in json.loads(sys.argv[5])
                                  for i, o in enumerate(run(prog, n))})
else:
    res = {}
    for art in json.loads(sys.argv[4]):
        prog = torch.export.load(art).module()
        for n in json.loads(sys.argv[5]):
            run(prog, n)
            ts = []
            for _ in range(9):
                t0 = time.perf_counter()
                run(prog, n)
                ts.append(time.perf_counter() - t0)
            res[f'{art}|{n}'] = 1e3 * sorted(ts)[4]
    print(json.dumps(res))
assert 'gmvae_tpu_torch' not in sys.modules
'''


def _serve_children(argvs, cwd):
    """Run one fresh ``python3`` per argument list, all at once; returns
    their standard outputs and fails on any non-zero exit."""
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    procs = [subprocess.Popen([sys.executable, '-c', _SERVE_CHILD, *a],
                              cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            check(p.returncode == 0, f'serving child failed: {err[-2000:]}')
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def live(trainer, state, verb, xs):
    """The live API's answer to ``verb`` on uint8 images ``xs``, as a list
    of arrays in an artifact's output order."""
    from gmvae_tpu_torch import api
    if verb == 'assign':
        return [api.cluster_assign(trainer, state, xs)]
    if verb == 'probs':
        return [api.latent_embed(trainer, state, xs)[1]]
    if verb == 'latent':
        return list(api.latent_embed(trainer, state, xs))
    return [api.reconstruct(trainer, state, xs)]


def phase_serving(dev, models):
    """Every verb of each ``(name, trainer, state)`` exported on the card,
    full and int8, each artifact loaded and run in a fresh process without
    the port, held to the live API; sizes and latency against the API."""
    from gmvae_tpu_torch import serving

    sizes = sorted({*SERVE_BATCHES, SERVE_AGREE_N})
    rows, latency = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        arts, argvs = [], []
        for name, trainer, state in models:
            x_path = os.path.join(tmp, f'{name}_x.npy')
            xs = trainer.dataset.test_x[:SERVE_AGREE_N]
            np.save(x_path, xs.astype(np.float32) / 255.0)
            n_before = len(arts)
            for verb in serving.VERBS:
                for quant in (None, 'int8'):
                    art = os.path.join(tmp, f'{name}_{verb}_{quant}.pt2')
                    t0 = time.perf_counter()
                    blob = serving.export_verb(trainer, state, verb,
                                               device=dev, path=art,
                                               quantize=quant)
                    arts.append((name, trainer, state, verb, quant, art,
                                 len(blob), time.perf_counter() - t0))
            argvs.append(['check', str(dev), x_path,
                          json.dumps([a[5] for a in arts[n_before:]]),
                          json.dumps(sizes)])
        t0 = time.perf_counter()
        _serve_children(argvs, tmp)
        log(f'[serving] {len(arts)} artifacts checked in {len(argvs)} fresh '
            f'processes in {time.perf_counter() - t0:.1f} s')
        full = {}
        for name, trainer, state, verb, quant, art, size, export_s in arts:
            got = np.load(art + '.npz')
            xs = trainer.dataset.test_x[:SERVE_AGREE_N]
            row = dict(model=name, verb=verb, quantize=quant, bytes=size,
                       export_s=export_s)
            if quant is None:
                full[(name, verb)] = (got, size)
                errs = []
                for n in sizes:
                    for i, w in enumerate(live(trainer, state, verb, xs[:n])):
                        g = got[f'{n}_{i}']
                        check(g.shape == w.shape and g.dtype == w.dtype,
                              f'{name} {verb} at {n}: {g.shape} {g.dtype}')
                        if verb == 'assign':
                            check(np.array_equal(g, w), f'{name} assign at '
                                  f'batch {n} differs from the live API')
                        else:
                            err = np.abs(g - w) - SERVE_RTOL * np.abs(w)
                            errs.append(float(np.abs(g - w).max()))
                            check(float(err.max()) <= SERVE_ATOL,
                                  f'{name} {verb} at batch {n} differs '
                                  f'from the live API by {errs[-1]}')
                row['max_abs_err_vs_live'] = max(errs, default=0.0)
            else:
                ref, ref_size = full[(name, verb)]
                row['size_ratio'] = size / ref_size
                check(size < ref_size / INT8_SIZE_RATIO,
                      f'{name} {verb}: int8 {size} bytes vs full {ref_size}')
                n = SERVE_AGREE_N
                for key in ref.files:
                    check(bool(np.isfinite(got[key]).all()),
                          f'{name} {verb} int8 {key} not finite')
                if verb == 'assign':
                    agree = float(np.mean(got[f'{n}_0'] == ref[f'{n}_0']))
                    row['agree_with_full'] = agree
                    check(agree >= INT8_AGREE, f'{name} int8 assignments '
                          f'agree with the full artifact on {agree}')
                else:
                    row['max_abs_diff_vs_full'] = max(
                        float(np.abs(got[k] - ref[k]).max())
                        for k in ref.files)
            rows.append(row)
            log(f'[serving] {json.dumps(row)}')

        # ---- wall ms a request: artifacts (fresh process) vs the API -------
        times = {}
        for name, _, _ in models:
            times.update(json.loads(_serve_children(
                [['time', str(dev), os.path.join(tmp, f'{name}_x.npy'),
                  json.dumps([a[5] for a in arts if a[0] == name]),
                  json.dumps(SERVE_TIME_BATCHES)]], tmp)[0]))
        for name, trainer, state, verb, quant, art, _, _ in arts:
            xs = trainer.dataset.test_x
            for n in SERVE_TIME_BATCHES:
                key = f'{name}|{verb}|{n}'
                lat = latency.setdefault(key, {})
                lat[f'artifact_{quant or "full"}_ms'] = times[f'{art}|{n}']
                if 'live_ms' not in lat:
                    lat['live_ms'] = wall_ms(
                        lambda: live(trainer, state, verb, xs[:n]))
    log(f'[serving] wall ms a request (median of 9): {json.dumps(latency)}')
    return rows, latency


class ServedThread:
    """``tools/serve_http.py``'s ``make_server`` on an ephemeral port,
    served from a thread until the block ends."""

    def __init__(self, path, cap):
        import threading
        from gmvae_tpu_torch.tools import serve_http
        self.srv = serve_http.make_server(path, port=0, max_body_bytes=cap)
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.url = (f'http://{self.srv.server_address[0]}:'
                    f'{self.srv.server_address[1]}')

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(30)
        return False

    def post(self, body):
        """(status, response body) of POST /predict."""
        import urllib.error
        import urllib.request
        req = urllib.request.Request(self.url + '/predict', data=body)
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()


def _npy(x):
    buf = io.BytesIO()
    np.save(buf, np.asarray(x))
    return buf.getvalue()


def phase_serve_http(dev, trainer, state):
    """The assign and latent verbs of [train]'s mnist_k10 state exported on
    the card and served over HTTP by ``tools/serve_http.py``: healthz, the
    answers at batches 1, 37 and 128 against the live API ([serving]'s
    limits), 400 for a body that is not npy and for a wrong shape, 413
    over the cap; the wall ms a request (median of 9) at batches 1 and
    128."""
    import urllib.request
    from gmvae_tpu_torch import api, serving
    xs = trainer.dataset.test_x
    latency, rows = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for verb in SERVE_HTTP_VERBS:
            path = os.path.join(tmp, f'{verb}.pt2')
            serving.export_verb(trainer, state, verb, device=dev, path=path)
            with ServedThread(path, SERVE_HTTP_CAP) as s:
                check(s.srv.program.device.type == 'cuda',
                      f'{verb} served from {s.srv.program.device}')
                with urllib.request.urlopen(s.url + '/healthz',
                                            timeout=30) as r:
                    check(r.read() == b'ok', 'healthz')
                for n in SERVE_BATCHES:
                    x = xs[:n].astype(np.float32) / 255.0
                    code, body = s.post(_npy(x))
                    check(code == 200, f'{verb} at {n}: {code} {body[:300]}')
                    got = np.load(io.BytesIO(body))
                    if verb == 'assign':
                        want = [api.cluster_assign(trainer, state, xs[:n])]
                    else:
                        want = list(api.latent_embed(trainer, state, xs[:n]))
                    check(list(got.files) == [f'out{i}' for i in
                                              range(len(want))],
                          f'{verb}: outputs {got.files}')
                    err = 0.0
                    for i, w in enumerate(want):
                        g = got[f'out{i}']
                        check(g.shape == w.shape and g.dtype == w.dtype,
                              f'{verb} at {n}: {g.shape} {g.dtype}')
                        if verb == 'assign':
                            check(np.array_equal(g, w), f'assign at {n} '
                                  f'differs from the live API')
                        else:
                            err = max(err, float(np.abs(g - w).max()))
                            check(float((np.abs(g - w) - SERVE_RTOL
                                         * np.abs(w)).max()) <= SERVE_ATOL,
                                  f'{verb} at {n} differs from the live API '
                                  f'by {err}')
                    rows.append(dict(verb=verb, batch=n,
                                     max_abs_err_vs_live=err))
                code, body = s.post(b'not-npy')
                check(code == 400 and 'error' in json.loads(body),
                      f'not npy: {code} {body[:300]}')
                code, body = s.post(_npy(np.zeros((4, 3, 3, 9), np.float32)))
                check(code == 400 and 'artifact spec' in
                      json.loads(body)['error'], f'wrong shape: {code}')
                big = _npy(xs[:SERVE_BIG].astype(np.float32) / 255.0)
                check(len(big) > SERVE_HTTP_CAP, 'the big body is small')
                code, body = s.post(big)
                check(code == 413, f'over the cap: {code} {body[:300]}')
                for n in SERVE_TIME_BATCHES:
                    body = _npy(xs[:n].astype(np.float32) / 255.0)
                    latency[f'{verb}|{n}'] = wall_ms(lambda: s.post(body))
    log(f'[serve_http] {json.dumps(rows)}')
    log(f'[serve_http] wall ms a request (median of 9): '
        f'{json.dumps(latency)}')
    return latency


def phase_parity(dev):
    """``parity_pair`` at PARITY_CONFIG, full width, matched noise, for
    PARITY_STEPS steps, the launch counts set to 0 before each arm: the
    fused arm launches both head kernels (exact counts), the unfused arm
    neither; both arms finite, their ELBOs within 1%."""
    from gmvae_tpu_torch import configs
    from gmvae_tpu_torch.tools.parity_conv import parity_pair
    cfg = configs.get_config(PARITY_CONFIG)
    arms = []

    def reset():
        torch.cuda.synchronize()
        for name in _build.LAUNCHES:
            _build.LAUNCHES[name] = 0

    def on_row(row):
        torch.cuda.synchronize()
        arms.append(dict(_build.LAUNCHES))
        log(f'[parity] {json.dumps(row)}')
        reset()

    reset()
    t0 = time.perf_counter()
    fused, oracle, summary = parity_pair(PARITY_CONFIG, PARITY_STEPS,
                                         PARITY_EVAL, {}, matched_noise=True,
                                         device=dev, emit=on_row)
    wall = time.perf_counter() - t0
    n_eval = math.ceil(PARITY_EVAL / cfg.batch_size) * max(1,
                                                            cfg.eval_samples)
    want = {'fused_elbo_fwd': PARITY_STEPS + n_eval,
            'fused_elbo_bwd': PARITY_STEPS}
    for name, n in want.items():
        check(arms[0][name] == n, f'[parity] fused arm: {name} launched '
              f'{arms[0][name]} times, expected {n}')
    check(not any(arms[1].values()), f'[parity] unfused arm launched '
          f'{arms[1]}')
    for row in (fused, oracle):
        for key in ('elbo_nats', 'iwae_nats', 'acc', 'nmi'):
            check(math.isfinite(row[key]), f'[parity] {key} = {row[key]}')
    summary.update(steps=PARITY_STEPS, eval_examples=PARITY_EVAL,
                   wall_s=wall, launches_fused=arms[0],
                   launches_oracle=arms[1])
    log(f'[parity] summary {json.dumps(summary)}')
    check(summary['within_1pct'], f'[parity] {PARITY_CONFIG}: ELBO delta '
          f'{summary["elbo_rel_delta_pct"]}% past 1%')
    return arms[0], summary


def phase_chaos(dev):
    """``tools/chaos_floor.py``'s command line at fmnist_deep, seed 0,
    CHAOS_STEPS steps, one checkpoint, with no kernel launched: --eps 0
    gives bit-equal arms, --eps CHAOS_EPS moves the perturbed arm's ELBO."""
    from gmvae_tpu_torch.tools import chaos_floor
    out = {}
    for eps in (0.0, CHAOS_EPS):
        torch.cuda.synchronize()
        for name in _build.LAUNCHES:
            _build.LAUNCHES[name] = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            chaos_floor.main(['--config', PARITY_CONFIG, '--seeds', '0',
                              '--steps', str(CHAOS_STEPS), '--checkpoints',
                              str(CHAOS_STEPS), '--eps', str(eps)])
        wall = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        check(lines[0] == card_line(), f'[chaos] first line {lines[0]!r}')
        rows = [json.loads(line) for line in lines[1:]]
        arms = {r['arm']: r for r in rows if 'arm' in r}
        summary, = [r for r in rows if r.get('chaos_floor')]
        check(not any(_build.LAUNCHES.values()),
              f'[chaos] launched {_build.LAUNCHES}')
        for row in arms.values():
            check(math.isfinite(row['elbo_nats']), f'[chaos] {row}')
        log(f'[chaos] eps {eps}: {json.dumps(summary)}; {wall:.1f} s')
        out[eps] = summary
        if eps == 0.0:
            strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                               if k not in ('arm', 'total_secs')}
            check(strip(arms['oracle']) == strip(arms['perturbed']),
                  f'[chaos] --eps 0: the arms differ {arms}')
        else:
            check(summary['elbo_oracle'] != summary['elbo_perturbed'],
                  f'[chaos] --eps {eps}: the arms\' ELBOs are equal')
    return out


# ---------------------------------------------------------------------------
# data parallelism (parallel/mesh.py): celeba_dp16 in a one-rank NCCL group,
# two ranks on the card, host-streamed batches
# ---------------------------------------------------------------------------


class OneRankGroup:
    """A one-rank NCCL process group on ``dev``, started by the port's
    ``init_distributed`` from torchrun's variables, and destroyed (the
    variables removed) on exit, so the other phases run without one."""

    def __init__(self, dev):
        from gmvae_tpu_torch.parallel.launch import free_port
        self.dev = dev
        self.env = dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK=str(dev.index),
                        MASTER_ADDR='127.0.0.1', MASTER_PORT=str(free_port()))

    def __enter__(self):
        import torch.distributed as dist
        from gmvae_tpu_torch.parallel import mesh
        check(not mesh.group_up(), 'a process group is already up')
        os.environ.update(self.env)
        check(mesh.init_distributed(self.dev), 'no process group started')
        check(dist.get_backend() == 'nccl' and mesh.world() == (0, 1),
              f'group {dist.get_backend()} {mesh.world()}, not one NCCL rank')
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        for k in self.env:
            os.environ.pop(k, None)
        return False


def roofline_row(trainer, state, img_s):
    """``[roofline]``: one step's counts of ``trainer`` from ``state`` and
    the rate's columns at ``img_s``, checked and logged."""
    from gmvae_tpu_torch.tools import roofline
    cfg = trainer.cfg
    t0 = time.perf_counter()
    c = roofline.count_step(trainer, state)
    for key in ('flops', 'gemm_flops', 'bytes'):
        check(math.isfinite(c[key]) and c[key] > 0,
              f'[roofline] {cfg.name} {key} = {c[key]}')
    # the deep family has no head kernel on its path
    fused = cfg.model_family == 'gmvae' and cfg.fused
    check((c['head_flops'] > 0) == fused,
          f'[roofline] {cfg.name} head_flops = {c["head_flops"]}')
    if cfg.name == 'mnist_k10':
        want = roofline.mlp_gemm_flops(cfg)
        check(c['gemm_flops'] == want, f'[roofline] mnist_k10 GEMM FLOPs '
              f'{c["gemm_flops"]}, its widths give {want}')
    row = roofline.rates(
        {'config': cfg.name, 'batch': cfg.batch_size,
         'gflops_per_step': c['flops'] / 1e9,
         'gemm_gflops_per_step': c['gemm_flops'] / 1e9,
         'head_gflops_per_step': c['head_flops'] / 1e9,
         'hbm_mb_per_step': c['bytes'] / 1e6}, img_s, card_line())
    check(0 < row['mfu_pct'] <= 100, f'[roofline] MFU {row["mfu_pct"]}%')
    row['count_s'] = time.perf_counter() - t0
    log(f'[roofline] {json.dumps(row)}')
    return row


def attribution(dev, tag, trainer, state):
    """``[profile_attr]``: ``profile_attr.capture_trainer`` on a trainer of
    ``trainer``'s config and dataset in PROFILE_ATTR_STEPS-step chunks,
    from ``state``; the attribution checked against the same trace, and
    logged with its per-op table."""
    from gmvae_tpu_torch import training
    from gmvae_tpu_torch.tools import profile_attr
    cfg = trainer.cfg.replace(scan_steps=PROFILE_ATTR_STEPS,
                              eval_every=10**9, ckpt_every=0)
    tr = training.Trainer(cfg, dataset=trainer.dataset, device=dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path, steps = profile_attr.capture_trainer(tr, state, tmp,
                                                   PROFILE_ATTR_CHUNKS)
        rows = profile_attr.parse_trace(path, on_card=True)
        table = io.StringIO()
        with contextlib.redirect_stderr(table):
            out = profile_attr.attribute(rows, top=15, steps=steps)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    del tr
    groups = out['groups_pct']
    check(abs(sum(groups.values()) - 100) <= GROUP_PCT_ATOL,
          f'[profile_attr] {tag} shares sum to {sum(groups.values())}')
    # the head kernels' device us, summed as utils/profiling.profile_device
    # sums a trace
    head = [e for e in events
            if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')
            and 'fused_elbo' in e.get('name', '')]
    head_us = sum(float(e.get('dur', 0)) for e in head)
    if cfg.model_family == 'gmvae' and cfg.fused:
        # the trace holds the head's kernels: one backward a traced step
        bwd = sum('fused_elbo_bwd' in e['name'] for e in head)
        check(head_us > 0 and bwd == steps, f'[profile_attr] {tag} '
              f'{bwd} head backward kernels, {head_us} us, in {steps} steps')
    per_step = out['groups_us_per_step']
    got = per_step.get('head_kernel', 0.0) * steps
    check(abs(got - head_us) <= 0.01 * head_us,
          f'[profile_attr] {tag} head_kernel {got} us, the trace {head_us}')
    idle = out['envelope_us'] - out['total_device_us']
    got = per_step.get('unattributed', 0.0) * steps
    check(abs(got - idle) <= 0.01 * out['envelope_us'],
          f'[profile_attr] {tag} unattributed {got} us, envelope less busy '
          f'{idle}')
    out.update(config=cfg.name, batch=cfg.batch_size, head_trace_us=head_us,
               idle_share=idle / out['envelope_us'], card=card_line(),
               wall_s=time.perf_counter() - t0)
    log(f'[profile_attr] {json.dumps(out)}')
    for line in table.getvalue().splitlines():
        log(f'[profile_attr] {tag} | {line}')
    return out


def phase_celeba_train(dev):
    """celeba_dp16 at full width and its global batch of 1,024, sharded
    layout, through ``api.train`` in a one-rank NCCL group (the gradient's
    all-reduce on the path), launch counts from 0; one chunk profiled."""
    from gmvae_tpu_torch import configs, data
    t0 = time.perf_counter()
    ds = data.load('celeba')
    log(f'[celeba_train] data {ds.source!r}: {ds.train_x.shape} train, '
        f'{ds.test_x.shape} test, made in {time.perf_counter() - t0:.1f} s')
    cfg = configs.celeba_dp16(steps=CELEBA_STEPS,
                              eval_every=CELEBA_STEPS // 2)
    check(cfg.data_sharding == 'sharded' and cfg.batch_size == 1024
          and cfg.grad_clip_impl == 'per_leaf', f'{cfg}')
    with OneRankGroup(dev):
        launches, hist, wall, trainer, state, prof, by_name = \
            train_and_profile(dev, cfg, 'celeba_train',
                              CELEBA_PROFILE_STEPS, dataset=ds)
        # in the group: the all-reduce is on the path
        roofline = roofline_row(trainer, state, statistics.median(
            r['img_per_sec_per_chip'] for r in hist))
        attr = attribution(dev, 'celeba_dp16', trainer, state)
    n_params = sum(p.numel() for p in state.params.values())
    check(n_params == CELEBA_PARAMS, f'{n_params} parameters')
    check(trainer.n_dp == 1 and trainer.n_local == len(ds.train_x),
          f'{trainer.n_dp} ranks, {trainer.n_local} rows')
    check_head_launches(cfg, launches, hist, len(ds.test_x), persistent=True)
    check_replays(cfg, launches)
    check(len(hist) == 2, f'{len(hist)} evals')
    for row in hist:
        for name in ('elbo_nats', 'iwae_nats', 'acc', 'nmi'):
            check(math.isfinite(row[name]), f'{name} = {row[name]}')
    check(hist[-1]['elbo_nats'] > hist[0]['elbo_nats'],
          'the celeba_dp16 ELBO did not rise from the first eval to the last')
    prof.update(fwd_kernel_device_us=device_us(
                    by_name, 'fused_elbo_fwd_kernel')[1]
                / CELEBA_PROFILE_STEPS,
                bwd_kernel_device_us=device_us(
                    by_name, 'fused_elbo_bwd_kernel')[1]
                / CELEBA_PROFILE_STEPS)
    log(f'[celeba_profile] {json.dumps(prof)}')
    summary = dict(steps=cfg.steps, wall_s=wall, params=n_params,
                   evals=[{k: r[k] for k in ('step', 'elbo_nats', 'iwae_nats',
                                             'acc', 'nmi')} for r in hist],
                   train_img_s_windows=[r['img_per_sec_per_chip']
                                        for r in hist])
    summary.update(roofline=roofline, profile_attr=attr)
    log(f'[celeba_train] summary {json.dumps(summary)}')
    return launches, summary, prof, trainer, state


_DP2_WORKER = r"""
import json, sys, time
import torch
from gmvae_tpu_torch import configs, training
from gmvae_tpu_torch.ops.kernels import _build
from gmvae_tpu_torch.parallel import mesh

steps, out, dev = int(sys.argv[1]), sys.argv[2], sys.argv[3]
mesh.init_distributed(dev, backend='gloo')
tr = training.Trainer(configs.mnist_k10(), device=dev)
state = tr.init_state()
idx = tr.batch_plan(steps)
tr.run_chunk(state, tr.batch_plan(2, start_step=steps))   # warm
torch.cuda.synchronize(dev)
for name in _build.LAUNCHES:
    _build.LAUNCHES[name] = 0
t0 = time.perf_counter()
st, m = tr.run_chunk(state, idx)
torch.cuda.synchronize(dev)
wall = time.perf_counter() - t0
torch.save({'flat': torch.cat([v.reshape(-1).cpu()
                               for v in st.params.values()]),
            'elbo': m['elbo']}, f'{out}/rank{tr.rank}.pt')
print(json.dumps({'rank': tr.rank, 'world': tr.n_dp, 'b_local': tr.b_local,
                  'launches': dict(_build.LAUNCHES), 'wall_s': wall,
                  'img_s': steps * tr.cfg.batch_size / wall}), flush=True)
"""


def manual_dp_steps(trainer, state, idx, n_shards):
    """``tests/test_dp.py:40`` on the card: each step, every shard's
    gradient from its shard-folded key, their sum over the shards divided
    by their number, one clip and Adam update. Returns the flat
    parameters, in ``state_dict`` order."""
    from gmvae_tpu_torch import data, prng, training
    cfg = trainer.cfg
    model = trainer.bind(state)
    opt_state = state.opt_state.clone()
    params = list(model.parameters())
    sizes = [p.numel() for p in params]
    loss_fn = training.make_loss_fn(model, cfg)
    b = cfg.batch_size // n_shards
    for step in range(idx.shape[0]):
        total = None
        for s in range(n_shards):
            key = prng.fold_in(prng.fold_in(trainer.base_key, step), s)
            k_pre, k_elbo = prng.split(key)
            rows = trainer.x_all[idx[step, s * b:(s + 1) * b]]
            x = data.preprocess_batch(
                k_pre, rows.reshape(b, *cfg.image_shape), cfg.binarize)
            with torch.enable_grad():
                grads = torch.autograd.grad(loss_fn(x, k_elbo, step)[0],
                                            params)
            g = torch.cat([t.reshape(-1) for t in grads])
            total = g if total is None else total + g
        with torch.no_grad():
            updates, opt_state = trainer.tx.update(total / n_shards,
                                                   opt_state, sizes)
            trainer.flat.add_(updates)
    return torch.cat([v.reshape(-1).cpu()
                      for v in model.state_dict().values()])


def phase_dp2(dev):
    """mnist_k10 at full width over two ranks on the one card (``parallel/
    launch.py``, gloo on cuda:0), global batch 128, against the manual
    shard average in this process."""
    from gmvae_tpu_torch import configs, training
    from gmvae_tpu_torch.parallel import launch
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        outs = launch.launch(2, ['-c', _DP2_WORKER, str(DP2_STEPS), out,
                                 str(dev)],
                             timeout=DP2_TIMEOUT,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        group_s = time.perf_counter() - t0
        rows = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        ranks = [torch.load(os.path.join(out, f'rank{r}.pt'),
                            weights_only=True) for r in range(2)]
    for r, row in enumerate(rows):
        check(row['rank'] == r and row['world'] == 2 and row['b_local'] == 64,
              f'[dp2] rank row {row}')
        check(row['launches']['fused_elbo_fwd'] == DP2_STEPS
              and row['launches']['fused_elbo_bwd'] == DP2_STEPS,
              f'[dp2] rank {r} launches {row["launches"]}')
    check(torch.equal(ranks[0]['flat'], ranks[1]['flat']),
          '[dp2] the two ranks\' parameters differ')
    check(torch.equal(ranks[0]['elbo'], ranks[1]['elbo']),
          '[dp2] the two ranks\' metrics differ')
    trainer = training.Trainer(configs.mnist_k10(), device=dev)
    want = manual_dp_steps(trainer, trainer.init_state(),
                           trainer.batch_plan(DP2_STEPS), 2)
    got = ranks[0]['flat']
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    launches = {k: sum(r['launches'][k] for r in rows)
                for k in rows[0]['launches']}
    summary = dict(steps=DP2_STEPS, ranks=2, b_local=64, group_s=group_s,
                   max_abs_diff_vs_manual=err, rel_diff_vs_manual=rel,
                   bit_equal_to_manual=bool(torch.equal(got, want)),
                   ranks_bit_equal=True, launches=launches,
                   elbo=ranks[0]['elbo'].tolist(),
                   img_s=[r['img_s'] for r in rows],
                   wall_s=[r['wall_s'] for r in rows])
    log(f'[dp2] {json.dumps(summary)}')
    check(rel <= DP2_RTOL, f'[dp2] parameters differ from the manual shard '
          f'average by {rel} (relative)')
    return launches, summary


def phase_stream(dev):
    """mnist_k10 for STREAM_STEPS steps with host-streamed batches against
    device placement: the parameters bit-equal, and both img/s."""
    from gmvae_tpu_torch import configs, data, training
    ds = data.load('mnist')
    out, launches = {}, {}
    for placement in ('device', 'host_stream'):
        cfg = configs.mnist_k10(data_placement=placement,
                                scan_steps=STREAM_CHUNK)
        trainer = training.Trainer(cfg, dataset=ds, device=dev)
        state = trainer.init_state()
        warm = trainer.init_state()
        for _, payload in trainer.iter_chunk_plans(0, 2):   # warm-up
            trainer.run_chunk(warm, payload)
        torch.cuda.synchronize()
        for name in _build.LAUNCHES:
            _build.LAUNCHES[name] = 0
        _build.REPLAYS['train_step'] = 0
        t0 = time.perf_counter()
        for _, payload in trainer.iter_chunk_plans(0, STREAM_STEPS):
            state, _ = trainer.run_chunk(state, payload)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[placement] = dict(_build.LAUNCHES)
        # the warm-up's chunks captured the graphs: every step replayed
        check(launches[placement]['fused_elbo_fwd'] == STREAM_STEPS
              and launches[placement]['fused_elbo_bwd'] == STREAM_STEPS
              and _build.REPLAYS['train_step'] == STREAM_STEPS,
              f'[stream] {placement} launches {launches[placement]}, '
              f'{_build.REPLAYS["train_step"]} steps replayed')
        out[placement] = (state, STREAM_STEPS * cfg.batch_size / wall)
    same = all(torch.equal(v, out['host_stream'][0].params[k])
               for k, v in out['device'][0].params.items())
    summary = dict(steps=STREAM_STEPS, chunk=STREAM_CHUNK,
                   params_bit_equal=same,
                   img_s_device=out['device'][1],
                   img_s_host_stream=out['host_stream'][1],
                   launches=launches)
    log(f'[stream] {json.dumps(summary)}')
    check(same, '[stream] streamed parameters differ from device placement')
    total = {k: sum(v[k] for v in launches.values())
             for k in launches['device']}
    return total, summary


# ``python -m gmvae_tpu_torch ARGV...`` (runpy runs the package's __main__
# as -m does), with the kernel launch counts and the seconds spent
# importing torch and the port, loading data, loading the kernel library
# and in Trainer.evaluate printed to stderr at exit
_CLI_CHILD = r'''
import time
t0 = time.perf_counter()
import atexit, json, runpy, sys
import torch
from gmvae_tpu_torch import data, training
from gmvae_tpu_torch.ops.kernels import _build
parts = {'import_s': time.perf_counter() - t0}

def timed(owner, name, key):
    fn = getattr(owner, name)
    def wrap(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            parts[key] = parts.get(key, 0.0) + time.perf_counter() - t
    setattr(owner, name, wrap)

timed(data, 'load', 'data_load_s')
timed(_build, 'library', 'kernel_library_s')
timed(training.Trainer, 'evaluate', 'eval_s')
atexit.register(lambda: print('CHILD ' + json.dumps(
    {'launches': _build.LAUNCHES, 'parts': parts}), file=sys.stderr,
    flush=True))
sys.argv = ['gmvae_tpu_torch', *sys.argv[1:]]
runpy.run_module('gmvae_tpu_torch', run_name='__main__', alter_sys=True)
'''


def run_cli_child(argv):
    """A fresh ``python -m gmvae_tpu_torch ARGV`` (``_CLI_CHILD``) from
    the repo's root: (its last stdout line as JSON, wall s, launches,
    the parts of its wall time)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, '-c', _CLI_CHILD, *argv],
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f'{argv[:1]} exited {out.returncode}:\n'
          f'{out.stderr[-3000:]}')
    tags = [ln for ln in out.stderr.splitlines() if ln.startswith('CHILD ')]
    child = json.loads(tags[-1][len('CHILD '):])
    return (json.loads(out.stdout.strip().splitlines()[-1]), wall,
            child['launches'], child['parts'])


def png_size(path):
    """(width, height) of an 8-bit RGB PNG whose image data decompresses
    with zlib to exactly its rows; fails otherwise."""
    import struct
    import zlib
    with open(path, 'rb') as f:
        blob = f.read()
    check(blob[:8] == b'\x89PNG\r\n\x1a\n', f'{path}: not a PNG')
    pos, chunks = 8, {}
    while pos < len(blob):
        (n,) = struct.unpack('>I', blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        chunks[tag] = chunks.get(tag, b'') + blob[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, ctype = struct.unpack('>IIBB', chunks[b'IHDR'][:10])
    check(depth == 8 and ctype == 2, f'{path}: depth {depth} type {ctype}')
    check(len(zlib.decompress(chunks[b'IDAT'])) == h * (1 + 3 * w),
          f'{path}: image data of the wrong size')
    return w, h


def cli_call(argv):
    """``cli.main(argv)`` in this process: (exit status, stdout lines)."""
    from gmvae_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f'cli {argv[:1]} exited {rc}')
    return buf.getvalue().strip().splitlines()


def phase_cli(dev, train_dir, hist, train_rate):
    """The CLI on [train]'s TRAIN_STEPS mnist_k10 checkpoint in
    ``train_dir``: a fresh ``python -m gmvae_tpu_torch eval`` equal to
    [train]'s last eval row bit for bit (its wall time split into parts);
    a fresh train to 400 steps and a fresh resume
    to 800 equal to [train]'s rows there; then in-process ``cli.main``
    calls with the launch counts set to 0 just before and read just after:
    describe, configs, assign against the live API, sample / reconstruct /
    latent PNGs, export (full and int8) against the live API, and bench
    in both pipelines."""
    from gmvae_tpu_torch import api, configs, serving, training
    from gmvae_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    cfg = configs.mnist_k10(steps=TRAIN_STEPS, eval_every=TRAIN_EVAL_EVERY)
    rows = {r['step']: r for r in hist}
    base = ['--config', cfg.name, '--set', f'run_dir={train_dir}']
    ckpt = os.path.join(train_dir, cfg.name, f'ckpt_{cfg.steps}.pt')
    check(os.path.exists(ckpt), f'[cli] no {ckpt}')
    n_eval = math.ceil(10_000 / cfg.batch_size) * max(1, cfg.eval_samples)

    def same_row(got, step, what):
        want = {k: rows[step][k] for k in CLI_ROW_KEYS}
        got = {k: got[k] for k in CLI_ROW_KEYS}
        check(got == want, f'[cli] {what}: {got} != [train]\'s {want}')

    # a fresh eval process
    row, eval_wall, eval_launches, parts = run_cli_child(['eval'] + base)
    same_row(row, cfg.steps, 'fresh eval')
    check(eval_launches['fused_elbo_fwd'] == n_eval
          and eval_launches['fused_elbo_bwd'] == 0,
          f'[cli] fresh eval launches {eval_launches}')

    # a fresh train into a new run directory, then a fresh resume
    fresh = {}
    with tempfile.TemporaryDirectory() as new_dir:
        for step in CLI_TRAIN_STEPS:
            argv = ['train', '--config', cfg.name, '--set',
                    f'run_dir={new_dir}', '--set', f'steps={step}']
            if step != CLI_TRAIN_STEPS[0]:
                argv.append('--resume')
            row, wall, launches, _ = run_cli_child(argv)
            same_row(row, step, f'fresh train to {step}')
            n_steps = step - (0 if '--resume' not in argv
                              else CLI_TRAIN_STEPS[0])
            check(launches['fused_elbo_fwd'] == n_steps + n_eval
                  and launches['fused_elbo_bwd'] == n_steps,
                  f'[cli] train to {step}: launches {launches}')
            fresh[step] = dict(wall_s=wall, launches=launches,
                               img_s=row['img_per_sec_per_chip'])

    # in-process calls
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0
    desc = json.loads(cli_call(['describe'] + base)[-1])
    check(desc['params_total'] == 1_442_996 and desc['fused_head'],
          f'[cli] describe {desc}')
    check(len(cli_call(['configs'])) == len(configs.CONFIGS),
          '[cli] configs')
    trainer = training.Trainer(cfg, device=dev)
    state = trainer.tree_to_state(ckpt_lib.restore_ckpt(ckpt))
    test_x = trainer.dataset.test_x
    with tempfile.TemporaryDirectory() as out_dir:
        out = os.path.join(out_dir, 'assign.npz')
        row = json.loads(cli_call(['assign'] + base + ['--out', out])[-1])
        with np.load(out) as saved:
            ids = saved['ids']
        live = api.cluster_assign(trainer, state, test_x)
        check(np.array_equal(ids, live), '[cli] assign ids != the live API')
        check(sum(row['cluster_counts']) == len(test_x) == row['n'],
              f'[cli] assign counts {row}')
        pngs = {}
        for verb, n in (('sample', 64), ('reconstruct', 32),
                        ('latent', 2048)):
            path = os.path.join(out_dir, f'{verb}.png')
            check(cli_call([verb] + base + ['--n', str(n), '--out', path])
                  == [path], f'[cli] {verb} output')
            pngs[verb] = png_size(path)
        check(pngs == {'sample': (8 * 28, 8 * 28),
                       'reconstruct': (32 * 28, 2 * 28),
                       'latent': (512, 512)}, f'[cli] PNG sizes {pngs}')
        x01 = test_x[:1000].astype(np.float32) / 255.0
        export = {}
        for quant in (None, 'int8'):
            path = os.path.join(out_dir, f'assign_{quant}.pt2')
            argv = ['export'] + base + ['--verb', 'assign', '--out', path]
            row = json.loads(cli_call(
                argv + (['--quantize', quant] if quant else []))[-1])
            got = serving.load_and_call(path, x01)
            export[quant or 'full'] = dict(
                bytes=row['bytes'], agree=float((got == live[:1000]).mean()))
        check(export['full']['agree'] == 1.0,
              f'[cli] the exported assign != the live API: {export}')
        check(export['int8']['agree'] >= 0.99,
              f'[cli] the int8 assign agrees on too few: {export}')
    bench = {}
    bench_argv = ['bench'] + base + ['--steps', str(CLI_BENCH_STEPS)]
    for pipeline in ('reused', 'windowed'):
        row = json.loads(cli_call(bench_argv + ['--pipeline', pipeline])[-1])
        check(math.isfinite(row['value']) and row['value'] > 0,
              f'[cli] bench {row}')
        bench[pipeline] = dict(img_s=row['value'],
                               vs_train_median=row['value'] / train_rate)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    in_process_s = time.perf_counter() - t0
    n_bench = (1 + CLI_BENCH_STEPS // cfg.scan_steps) * cfg.scan_steps
    check(launches['fused_elbo_fwd'] == 2 * n_bench
          and launches['fused_elbo_bwd'] == 2 * n_bench,
          f'[cli] in-process launches {launches}, expected {2 * n_bench} '
          f'each')
    total = {k: launches[k] + eval_launches[k]
             + sum(f['launches'][k] for f in fresh.values())
             for k in launches}
    summary = dict(fresh_eval_wall_s=eval_wall, fresh_eval_parts=parts,
                   fresh_train=fresh, bit_equal_rows=[cfg.steps,
                                                     *CLI_TRAIN_STEPS],
                   describe_params=desc['params_total'], pngs=pngs,
                   export=export, bench_steps=CLI_BENCH_STEPS, bench=bench,
                   train_median_img_s=train_rate,
                   launches_in_process=launches, launches_total=total,
                   in_process_s=in_process_s,
                   phase_s=time.perf_counter() - t_phase)
    log(f'[cli] {json.dumps(summary)}')
    return total, summary


def reset_launches():
    torch.cuda.synchronize()
    for name in _build.LAUNCHES:
        _build.LAUNCHES[name] = 0


def read_launches():
    torch.cuda.synchronize()
    return dict(_build.LAUNCHES)


def tool_rows(tag, main, argv):
    """A port tool's ``main(argv)`` with its stdout captured and the launch
    counts set to 0 just before: (its JSON rows, the launches, wall s). Its
    first line must be the card's; every line is logged."""
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
    except SystemExit as e:   # the tool's own refusal: fail with its lines
        raise RuntimeError(f'chip_smoke: [{tag}] exited {e.code}: '
                           f'{buf.getvalue()[-2000:]}') from e
    launches = read_launches()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    check(lines and lines[0] == card_line(),
          f'[{tag}] the first line {lines[:1]} is not the card\'s')
    for line in lines:
        log(f'[{tag}] {line}')
    return [json.loads(line) for line in lines[1:]], launches, wall


def bench_steps(scan_steps, steps):
    """Steps ``run_bench`` trains: one warm-up chunk and the timed ones."""
    return (1 + max(1, steps // scan_steps)) * scan_steps


def check_head_only(tag, launches, n_fwd, n_bwd):
    check(launches['fused_elbo_fwd'] == n_fwd
          and launches['fused_elbo_bwd'] == n_bwd
          and launches['wide_head_fwd'] == 0,
          f'[{tag}] launches {launches}, expected {n_fwd} forward and '
          f'{n_bwd} backward')


def phase_bench_ab(dev):
    """``tools/bench_ab.py`` at mnist_k10, one run an arm: both rates finite
    and positive, the summary their medians, both head kernels launched
    once a step of each arm."""
    from gmvae_tpu_torch import configs
    from gmvae_tpu_torch.tools import bench_ab
    rows, launches, wall = tool_rows('bench_ab', bench_ab.main, [
        '--config', 'mnist_k10', '--steps', str(BENCH_AB_STEPS),
        '--repeats-reused', '1', '--repeats-windowed', '1'])
    runs, summary = rows[:-1], rows[-1]
    check([r['pipeline'] for r in runs] == ['reused', 'windowed']
          and all(math.isfinite(r['value']) and r['value'] > 0
                  for r in runs), f'[bench_ab] runs {runs}')
    check(summary['reused_median'] == runs[0]['value']
          and summary['windowed_median'] == runs[1]['value']
          and math.isfinite(summary['plan_pipeline_cost_pct']),
          f'[bench_ab] summary {summary}')
    n = 2 * bench_steps(configs.mnist_k10().scan_steps, BENCH_AB_STEPS)
    check_head_only('bench_ab', launches, n, n)
    return launches, dict(summary, wall_s=wall)


def phase_autotune_scan(dev):
    """``tools/autotune_scan.py`` at mnist_k10 over AUTOTUNE_GRID: a row a
    setting and the best, both head kernels launched once a step run."""
    from gmvae_tpu_torch.tools import autotune_scan
    rows, launches, wall = tool_rows('autotune_scan', autotune_scan.main, [
        'mnist_k10', '--grid', ','.join(map(str, AUTOTUNE_GRID)),
        '--steps', str(AUTOTUNE_STEPS)])
    settings, best = rows[:-1], rows[-1]
    check([r['scan_steps'] for r in settings] == list(AUTOTUNE_GRID)
          and all(math.isfinite(r['img_per_sec_chip'])
                  and r['img_per_sec_chip'] > 0 for r in settings),
          f'[autotune_scan] rows {settings}')
    check(best['best_img_per_sec_chip'] == max(
        r['img_per_sec_chip'] for r in settings), f'[autotune_scan] {best}')
    n = sum(bench_steps(s, max(AUTOTUNE_STEPS, 2 * s))
            for s in AUTOTUNE_GRID)
    check_head_only('autotune_scan', launches, n, n)
    return launches, dict(best, rows=settings, wall_s=wall)


def phase_bench_eval(dev):
    """``tools/bench_eval.py`` at mnist_k10 on BENCH_EVAL_EXAMPLES test
    images: the arms bit-equal (the tool refuses otherwise; their rows'
    ELBOs equal here), the forward kernel once a batch and sample of every
    call of each arm (a warm-up and the repeats), no backward."""
    from gmvae_tpu_torch import configs
    from gmvae_tpu_torch.tools import bench_eval
    rows, launches, wall = tool_rows('bench_eval', bench_eval.main, [
        'mnist_k10', '--examples', str(BENCH_EVAL_EXAMPLES), '--repeats',
        str(BENCH_EVAL_REPEATS)])
    arms = {r['arm']: r for r in rows[:-1]}
    check(set(arms) == {'staged', 'legacy_per_batch'}
          and arms['staged']['elbo_nats']
          == arms['legacy_per_batch']['elbo_nats']
          and math.isfinite(arms['staged']['elbo_nats']),
          f'[bench_eval] arms {arms}')
    cfg = configs.mnist_k10()
    n = (2 * (1 + BENCH_EVAL_REPEATS)
         * math.ceil(BENCH_EVAL_EXAMPLES / cfg.batch_size)
         * max(1, cfg.eval_samples))
    check_head_only('bench_eval', launches, n, 0)
    return launches, dict(
        eval_secs={k: v['eval_secs'] for k, v in arms.items()},
        speedup=rows[-1]['speedup'], wall_s=wall)


def phase_bench_serving(dev, trainer, state):
    """``tools/bench_serving.py``'s timing of [train]'s mnist_k10 state:
    a row a (verb, batch), p50 <= p90 and finite, the assign artifact's
    answer at batch 128 equal to ``api.cluster_assign``; no custom kernel
    (the artifacts hold none)."""
    from gmvae_tpu_torch import api
    from gmvae_tpu_torch.tools import bench_serving
    log(f'[bench_serving] {card_line()}')
    reset_launches()
    t0 = time.perf_counter()
    rows, answers = bench_serving.bench_verbs(
        trainer, state, BENCH_SERVING_VERBS, BENCH_SERVING_BATCHES,
        BENCH_SERVING_ITERS, dev,
        emit=lambda row: log(f'[bench_serving] {json.dumps(row)}'))
    launches = read_launches()
    wall = time.perf_counter() - t0
    check([(r['verb'], r['batch']) for r in rows]
          == [(v, b) for v in BENCH_SERVING_VERBS
              for b in BENCH_SERVING_BATCHES], f'[bench_serving] {rows}')
    check(all(math.isfinite(r['p90_ms']) and 0 < r['p50_ms'] <= r['p90_ms']
              for r in rows), f'[bench_serving] latencies {rows}')
    x, ids = answers[('assign', 128)]
    check(np.array_equal(ids, api.cluster_assign(trainer, state, x)),
          '[bench_serving] the assign artifact != the live API at 128')
    check(not any(launches.values()), f'[bench_serving] launched {launches}')
    return dict(p50_ms={f"{r['verb']}@{r['batch']}": r['p50_ms']
                        for r in rows}, wall_s=wall)


def phase_bench_conv_bound(dev):
    """``tools/bench_conv_bound.py``'s conv-only rate of CONV_BOUND_CONFIGS
    at full width, CONV_BOUND_STEPS timed steps in chunks of
    CONV_BOUND_INNER: finite positive rates, a finite loss at the window's
    end, parameters moved from their start; no custom kernel."""
    from gmvae_tpu_torch import configs
    from gmvae_tpu_torch.tools import bench_conv_bound as cb
    log(f'[bench_conv_bound] {card_line()}')
    out = {}
    for name in CONV_BOUND_CONFIGS:
        reset_launches()
        t0 = time.perf_counter()
        stacks = cb.conv_stacks(configs.get_config(name), dev)
        start = [p.detach().clone() for m in stacks[:2]
                 for p in m.parameters()]
        row = cb.conv_only_rate(name, CONV_BOUND_STEPS, CONV_BOUND_INNER,
                                dev, stacks=stacks)
        # the device's share of a conv-only chunk: one more chunk traced
        traced_s, busy, _, _ = profile_device(
            lambda: cb.sgd_chunk(*stacks, CONV_BOUND_INNER)[-1].item())
        with torch.no_grad():
            loss = cb.conv_loss(*stacks).item()
        moved = sum(not torch.equal(a, p) for a, p in zip(
            start, (p for m in stacks[:2] for p in m.parameters())))
        launches = read_launches()
        log(f'[bench_conv_bound] {json.dumps(row)}')
        check(math.isfinite(row['conv_only_img_per_sec'])
              and row['conv_only_img_per_sec'] > 0 and math.isfinite(loss)
              and moved > 0, f'[bench_conv_bound] {name}: {row}, loss '
              f'{loss}, {moved} of {len(start)} parameters moved')
        check(not any(launches.values()),
              f'[bench_conv_bound] launched {launches}')
        out[name] = dict(img_s=row['conv_only_img_per_sec'], loss=loss,
                         moved=f'{moved}/{len(start)}',
                         traced_device_busy_pct=100 * busy / traced_s,
                         wall_s=time.perf_counter() - t0)
    log(f'[bench_conv_bound] {json.dumps(out)}')
    return out


def phase_bench_gather(dev):
    """``tools/bench_gather.py`` at its defaults, GATHER_REPEATS repeats:
    the four gathers' checksum GATHER_CHECKSUM, slice_contig's
    GATHER_CONTIG_CHECKSUM; no custom kernel."""
    from gmvae_tpu_torch.tools import bench_gather
    rows, launches, wall = tool_rows('bench_gather', bench_gather.main,
                                     ['--repeats', str(GATHER_REPEATS)])
    sums = {r['variant']: r['checksum'] for r in rows[:-1]}
    check(sums == {'u8_img': GATHER_CHECKSUM, 'u8_flat': GATHER_CHECKSUM,
                   'i32_packed': GATHER_CHECKSUM,
                   'f32_flat': GATHER_CHECKSUM,
                   'slice_contig': GATHER_CONTIG_CHECKSUM}
          and rows[-1]['checksums_identical'], f'[bench_gather] {sums}')
    check(not any(launches.values()), f'[bench_gather] launched {launches}')
    # the device's share of a step: one repeat of each variant traced
    n, shape, batch, steps = GATHER_DEFAULTS
    idx, offsets = bench_gather.make_plan(n, batch, steps, dev)
    device = {}
    for name, x, fn in bench_gather.make_variants(n, shape, batch, steps,
                                                  dev):
        fn(x, idx, offsets).item()
        _, busy, kernels, _ = profile_device(
            lambda: fn(x, idx, offsets).item())
        device[name] = dict(device_us_per_step=1e6 * busy / steps,
                            kernels_per_step=kernels / steps)
    log(f'[bench_gather] device {json.dumps(device)}')
    return dict(us_per_step={r['variant']: r['us_per_step']
                             for r in rows[:-1]}, device=device,
                wall_s=wall)


def phase_dryrun(dev):
    """``dryrun_multichip(2)`` on the card: two gloo ranks on the one card
    (NCCL refuses two ranks a device), every phase's ELBO finite, streaming
    bit-equal to device placement, and the fused phase's head kernels
    launched in each rank."""
    from gmvae_tpu_torch import dryrun
    t0 = time.perf_counter()
    reports = dryrun.dryrun_multichip(DRYRUN_RANKS, device=str(dev))
    wall = time.perf_counter() - t0
    for rep in reports:
        check(rep['backend'] == 'gloo' and rep['device'] == 'cuda:0',
              f'[dryrun] rank {rep["rank"]} on {rep["device"]} '
              f'({rep["backend"]})')
        check(all(math.isfinite(v) for v in rep['elbo'].values())
              and rep['stream_bit_equal'], f'[dryrun] rank report {rep}')
        check(rep['launches']['fused_elbo_fwd'] == DRYRUN_STEPS
              and rep['launches']['fused_elbo_bwd'] == DRYRUN_STEPS,
              f'[dryrun] rank {rep["rank"]} launches {rep["launches"]}')
    launches = {k: sum(r['launches'][k] for r in reports)
                for k in reports[0]['launches']}
    log(f'[dryrun] {json.dumps(dict(wall_s=wall, reports=reports))}')
    return launches, wall


POD_KEYS = ('config', 'devices', 'data_placement', 'data_sharding',
            'grad_clip_impl', 'train_elbo', 'eval_elbo_nats', 'ok')


def run_pod_tools(argvs):
    """``python -m gmvae_tpu_torch.tools.dryrun_pod *argv`` for each argv,
    all started at once from this process, with the card's used memory
    polled from here while they run (``torch.cuda.mem_get_info``): (each
    one's output lines, each one's wall s, used GiB before them, used GiB
    at the peak of them all). Each may take the tool's own time limit
    (``POD_TIMEOUT``) and a minute more."""
    from gmvae_tpu_torch.tools import dryrun_pod
    limit = dryrun_pod.POD_TIMEOUT + 60.0
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    before = peak = total - free
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'gmvae_tpu_torch.tools.dryrun_pod', *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for argv in argvs]
    walls = [None] * len(procs)
    try:
        while None in walls:
            for i, p in enumerate(procs):
                if walls[i] is None and p.poll() is not None:
                    walls[i] = time.perf_counter() - t0
            if time.perf_counter() - t0 > limit:
                raise RuntimeError(f'[dryrun_pod] {argvs} ran past {limit} s')
            free, total = torch.cuda.mem_get_info()
            peak = max(peak, total - free)
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate() for p in procs]
    lines = []
    for argv, p, (out, err) in zip(argvs, procs, outs):
        check(p.returncode == 0, f'[dryrun_pod] {argv} exited with '
              f'{p.returncode}:\n{out[-2000:]}\n{err[-3000:]}')
        lines.append(out.strip().splitlines())
    return lines, walls, before / 2**30, peak / 2**30


def phase_dryrun_pod(dev):
    """The pod pre-flight's command line: celeba_dp16 over POD_RANKS
    ranks (device placement, sharded) and mnist_k10 over POD_STREAM_RANKS
    (host_stream, replicated), both at once, all ranks on the one card
    over gloo: exit 0, the reference's keys, finite ELBOs, the expected
    sharding, every rank's head launches exact (one forward and one
    backward a step, and one forward for the eval's one batch); each run's
    wall s and the card's used memory at the peak of the two."""
    runs = [('celeba_dp16', POD_RANKS, None, 'sharded'),
            ('mnist_k10', POD_STREAM_RANKS, 'host_stream', 'replicated')]
    argvs = []
    for config, n, placement, _ in runs:
        argvs.append(['--config', config, '--devices', str(n),
                      '--steps', str(POD_STEPS)]
                     + (['--placement', placement] if placement else []))
    outs, walls, before, peak = run_pod_tools(argvs)
    launches, summary = {}, dict(card_used_gib_before=before,
                                 card_used_gib_peak=peak)
    for (config, n, _, sharding), lines, wall in zip(runs, outs, walls):
        check(lines[0] == card_line(), f'[dryrun_pod] first line {lines[0]!r}')
        row = json.loads(lines[-1])
        check(tuple(row)[:len(POD_KEYS)] == POD_KEYS and row['ok']
              and row['devices'] == n and row['config'] == config,
              f'[dryrun_pod] {row}')
        check(math.isfinite(row['train_elbo'])
              and math.isfinite(row['eval_elbo_nats']), f'[dryrun_pod] {row}')
        check(row['data_sharding'] == sharding
              and row['backend'] == 'gloo' and row['device'] == 'cuda:0',
              f'[dryrun_pod] {config}: {row}')
        want = {'fused_elbo_fwd': POD_STEPS + 1, 'fused_elbo_bwd': POD_STEPS}
        check(len(row['launches']) == n
              and all(r == want for r in row['launches']),
              f'[dryrun_pod] {config} launches {row["launches"]}, want '
              f'{want} on each of {n} ranks')
        launches[config] = {k: sum(r[k] for r in row['launches'])
                            for k in want}
        summary[config] = dict(
            row={k: row[k] for k in row if k != 'launches'}, ranks=n,
            wall_s=wall)
        log(f'[dryrun_pod] {json.dumps(summary[config])}')
    log(f'[dryrun_pod] the card\'s used GiB before {before}, at the peak of '
        f'both runs {peak}')
    return launches, summary


# a fresh process that loads listed artifacts with the port's
# load_program on a device and runs them at SERVE_BATCHES
_XDEV_CHILD = r'''
import json, sys
import numpy as np
import torch
from gmvae_tpu_torch import serving

dev, x = sys.argv[1], np.load(sys.argv[2])
for art in json.loads(sys.argv[3]):
    prog = serving.load_program(art, device=dev)
    assert prog.device.type == dev, prog.device
    tensors = prog.module.state_dict().values()
    assert all(t.device.type == dev for t in tensors), art
    outs = {}
    for n in json.loads(sys.argv[4]):
        got = prog(x[:n])
        for i, o in enumerate(got if isinstance(got, tuple) else (got,)):
            outs[f'{n}_{i}'] = o
    np.savez(art + '.npz', **outs)
'''


@contextlib.contextmanager
def phase_serving_xdev(dev, trainer, state):
    """Artifacts that move between devices (``platforms``): mnist_k10's
    assign and latent written here on the CPU for ['cuda', 'cpu'] and
    loaded on the card by a fresh process, and written on the card for
    the same list and loaded on the CPU by another; each held to the live
    API on its device at [serving]'s batches and limits. The two
    processes start on entry and run beside the block ([serving]); at its
    end their answers are checked, and that ``load_program`` with no
    device puts an assign artifact listed in either order, written on
    either device, on the card. They are stopped if anything raises."""
    from gmvae_tpu_torch import serving, training

    cpu = training.Trainer(trainer.cfg, dataset=trainer.dataset,
                           device='cpu')
    cpu_state = cpu.tree_to_state(trainer.state_to_tree(state))
    plats = XDEV_PLATFORMS
    cases = [('cpu', 'cuda', trainer, state), ('cuda', 'cpu', cpu, cpu_state)]
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['PYTHONPATH'] = os.path.dirname(os.path.abspath(__file__))
    xs = trainer.dataset.test_x[:max(SERVE_BATCHES)]
    procs, arts = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            x_path = os.path.join(tmp, 'x.npy')
            np.save(x_path, xs.astype(np.float32) / 255.0)
            for traced, target, _, _ in cases:
                arts[traced] = []
                for verb in XDEV_VERBS:
                    art = os.path.join(tmp, f'{verb}_{traced}.pt2')
                    serving.export_verb(trainer, state, verb,
                                        device=torch.device(traced),
                                        path=art, platforms=plats)
                    with open(art + '.json') as f:
                        meta = json.load(f)
                    check(meta['platforms'] == plats
                          and meta['device'].startswith(traced),
                          f'[serving] {art}: {meta}')
                    arts[traced].append((verb, art))
                procs.append(subprocess.Popen(
                    [sys.executable, '-c', _XDEV_CHILD, target, x_path,
                     json.dumps([a for _, a in arts[traced]]),
                     json.dumps(list(SERVE_BATCHES))], cwd=tmp, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            yield
            # with no device asked for: the card, for either order
            for traced in ('cpu', 'cuda'):
                for order in (plats, plats[::-1]):
                    prog = serving.load_program(serving.export_verb(
                        trainer, state, 'assign',
                        device=torch.device(traced), platforms=order))
                    check(prog.device.type == 'cuda' and all(
                        t.device.type == 'cuda'
                        for t in prog.module.state_dict().values()),
                          f'[serving] an assign artifact written on '
                          f'{traced} for {order} loads on {prog.device} by '
                          f'default')
                    for n in SERVE_BATCHES:
                        check(np.array_equal(
                            prog(xs[:n].astype(np.float32) / 255.0),
                            live(trainer, state, 'assign', xs[:n])[0]),
                              f'[serving] the default-device assign '
                              f'({traced}, {order}) at {n} differs from the '
                              f'live API')
            log(f'[serving] cross-device: load_program with no device puts '
                f'assign written on the CPU and on the card for {plats} and '
                f'{plats[::-1]} on the card, equal to the live API')
            for p in procs:
                _, err = p.communicate(timeout=600)
                check(p.returncode == 0, f'[serving] cross-device child '
                      f'failed: {err[-2000:]}')
            for traced, target, tr, st in cases:
                for verb, art in arts[traced]:
                    got, errs = np.load(art + '.npz'), []
                    for n in SERVE_BATCHES:
                        for i, w in enumerate(live(tr, st, verb, xs[:n])):
                            g = got[f'{n}_{i}']
                            check(g.shape == w.shape and g.dtype == w.dtype,
                                  f'[serving] {art} at {n}: {g.shape} '
                                  f'{g.dtype}')
                            if verb == 'assign':
                                check(np.array_equal(g, w), f'[serving] '
                                      f'{art} on {target} at {n} differs '
                                      f'from the live API')
                                continue
                            errs.append(float(np.abs(g - w).max()))
                            check(float((np.abs(g - w) - SERVE_RTOL
                                         * np.abs(w)).max()) <= SERVE_ATOL,
                                  f'[serving] {art} on {target} at {n} '
                                  f'differs from the live API by {errs[-1]}')
                    row = dict(verb=verb, traced_on=traced, loaded_on=target,
                               platforms=plats, assign_equal=verb == 'assign',
                               max_abs_err_vs_live=max(errs, default=0.0))
                    log(f'[serving] cross-device {json.dumps(row)}')
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2

    t_start = time.perf_counter()
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
    elapsed(t_start)
    phase_threefry(dev)
    main_row, rows = phase_head(dev)
    elapsed(t_start)
    bwd_row, bwd_rows = phase_head_bwd(dev)
    elapsed(t_start)
    eval_launches, img_s, prof = phase_slice(dev)
    # [train]'s run directory stays until [cli] has used its checkpoint
    with tempfile.TemporaryDirectory() as train_dir:
        launches, summary, train_prof, trainer, state, hist = phase_train(
            dev, train_dir)
        cli_launches, cli_summary = phase_cli(
            dev, train_dir, hist, summary['train_img_s_median'])
    elapsed(t_start)
    phase_xcheck(dev, trainer, state)
    elapsed(t_start)
    wide_row, wide_rows = phase_head_wide(dev)
    boundary_launches, boundary_rows = phase_boundary(dev)
    elapsed(t_start)
    (cifar_launches, cifar_summary, cifar_prof, cifar_trainer,
     cifar_state) = phase_cifar_train(dev)
    phase_xcheck(dev, cifar_trainer, cifar_state, CIFAR_XCHECK_STEPS,
                 'cifar_xcheck')
    elapsed(t_start)
    (deep_launches, deep_summary, deep_prof, deep_trainer,
     deep_state) = phase_deep_train(dev)
    phase_xcheck(dev, deep_trainer, deep_state, XCHECK_STEPS, 'deep_xcheck',
                 DEEP_PRIOR_LEAVES)
    elapsed(t_start)
    sweep_launches, sweep_summaries = phase_sweep_train(dev)
    elapsed(t_start)
    parity_launches, parity_summary = phase_parity(dev)
    chaos = phase_chaos(dev)
    elapsed(t_start)
    with phase_serving_xdev(dev, trainer, state):
        phase_serving(dev, [('mnist_k10', trainer, state),
                            ('mnist_deepmix', deep_trainer, deep_state)])
    http_latency = phase_serve_http(dev, trainer, state)
    elapsed(t_start)
    (celeba_launches, celeba_summary, celeba_prof, celeba_trainer,
     celeba_state) = phase_celeba_train(dev)
    phase_xcheck(dev, celeba_trainer, celeba_state, CELEBA_XCHECK_STEPS,
                 'celeba_xcheck', batch_size=CELEBA_XCHECK_BATCH)
    del celeba_trainer, celeba_state
    elapsed(t_start)
    roofline = [roofline_row(trainer, state, summary['train_img_s_median']),
                roofline_row(cifar_trainer, cifar_state, statistics.median(
                    cifar_summary['train_img_s_windows'])),
                roofline_row(deep_trainer, deep_state,
                             deep_summary['train_img_s_median']),
                celeba_summary['roofline']]
    attribution(dev, 'mnist_k10', trainer, state)
    elapsed(t_start)
    dp2_launches, dp2_summary = phase_dp2(dev)
    elapsed(t_start)
    stream_launches, stream_summary = phase_stream(dev)
    elapsed(t_start)
    t_tools = time.perf_counter()
    ab_launches, ab_summary = phase_bench_ab(dev)
    autotune_launches, autotune_summary = phase_autotune_scan(dev)
    beval_launches, beval_summary = phase_bench_eval(dev)
    bserving = phase_bench_serving(dev, trainer, state)
    conv_bound = phase_bench_conv_bound(dev)
    gather = phase_bench_gather(dev)
    tools = dict(bench_ab=ab_summary, autotune_scan=autotune_summary,
                 bench_eval=beval_summary, bench_serving=bserving,
                 bench_conv_bound=conv_bound, bench_gather=gather)
    log(f'[bench_tools] {json.dumps(tools)}')
    log(f'[bench_tools] the six phases took '
        f'{time.perf_counter() - t_tools:.1f} s')
    elapsed(t_start)
    dryrun_launches, dryrun_wall = phase_dryrun(dev)
    elapsed(t_start)
    pod_launches, pod_summary = phase_dryrun_pod(dev)

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
        'launches_deep_train': deep_launches['fused_elbo_fwd'],
        'launches_sweep_train': {name: n['fused_elbo_fwd'] for name, n in
                                 sweep_launches.items()},
        'launches_parity': parity_launches['fused_elbo_fwd'],
        'launches_celeba_train': celeba_launches['fused_elbo_fwd'],
        'device_us_in_celeba_train': celeba_prof['fwd_kernel_device_us'],
        'launches_dp2': dp2_launches['fused_elbo_fwd'],
        'launches_stream': stream_launches['fused_elbo_fwd'],
        'launches_cli': cli_launches['fused_elbo_fwd'],
        'launches_dryrun': dryrun_launches['fused_elbo_fwd'],
        'launches_dryrun_pod': {c: n['fused_elbo_fwd']
                                for c, n in pod_launches.items()},
        'launches_bench_ab': ab_launches['fused_elbo_fwd'],
        'launches_autotune_scan': autotune_launches['fused_elbo_fwd'],
        'launches_bench_eval': beval_launches['fused_elbo_fwd'],
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
        'launches_deep_train': deep_launches['fused_elbo_bwd'],
        'launches_sweep_train': {name: n['fused_elbo_bwd'] for name, n in
                                 sweep_launches.items()},
        'launches_parity': parity_launches['fused_elbo_bwd'],
        'launches_celeba_train': celeba_launches['fused_elbo_bwd'],
        'device_us_in_celeba_train': celeba_prof['bwd_kernel_device_us'],
        'launches_dp2': dp2_launches['fused_elbo_bwd'],
        'launches_stream': stream_launches['fused_elbo_bwd'],
        'launches_cli': cli_launches['fused_elbo_bwd'],
        'launches_dryrun': dryrun_launches['fused_elbo_bwd'],
        'launches_dryrun_pod': {c: n['fused_elbo_bwd']
                                for c, n in pod_launches.items()},
        'launches_bench_ab': ab_launches['fused_elbo_bwd'],
        'launches_autotune_scan': autotune_launches['fused_elbo_bwd'],
        'launches_bench_eval': beval_launches['fused_elbo_bwd'],
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
        f'{cifar_summary["train_img_s_windows"]}; mnist_deepmix train img/s '
        f'(median window) {deep_summary["train_img_s_median"]}; '
        f'[sweep_train] img/s (first window) '
        f'{json.dumps({k: v["img_s"] for k, v in sweep_summaries.items()})}; '
        f'celeba_dp16 train img/s (windows) '
        f'{celeba_summary["train_img_s_windows"]}; [dp2] img/s a rank '
        f'{dp2_summary["img_s"]}; [stream] img/s device / host_stream '
        f'{stream_summary["img_s_device"]} / '
        f'{stream_summary["img_s_host_stream"]}; [cli] bench img/s '
        f'{json.dumps(cli_summary["bench"])}; [cli] fresh eval '
        f'{cli_summary["fresh_eval_wall_s"]:.1f} s; [dryrun] '
        f'{dryrun_wall:.1f} s; [dryrun_pod] wall s '
        f'{json.dumps({c: pod_summary[c]["wall_s"] for c in pod_launches})}'
        f', card GiB at the peak {pod_summary["card_used_gib_peak"]:.2f}; '
        f'[parity] {PARITY_CONFIG} delta '
        f'{parity_summary["elbo_rel_delta_pct"]}%; [chaos] --eps '
        f'{CHAOS_EPS} delta {chaos[CHAOS_EPS]["elbo_rel_delta_pct"]}%; '
        f'[serve_http] wall ms {json.dumps(http_latency)}')
    log('[roofline] | Config | batch | img/s/chip | GFLOP/step | TFLOP/s '
        '| MFU (bf16 989 TFLOP/s) | HBM GB/s (upper bound) |')
    for r in roofline:
        log(f"[roofline] | {r['config']} | {r['batch']} | "
            f"{r['img_per_sec_chip']} | {r['gflops_per_step']} | "
            f"{r['sustained_tflops']} | {r['mfu_pct']}% | "
            f"{r['hbm_gbs_upper_bound']} |")
    print(json.dumps({'kernels': kernels}))
    print(f'[wall] chip_smoke: {time.perf_counter() - t_start:.1f} s')
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
