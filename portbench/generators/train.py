"""Training traffic: the port's ``Trainer`` over its windowed batch plan.

The mix's file gives ``trace_chunks``, the chunks the traced run records.
The configuration gives the model, the global batch, the chunk length
(``scan_steps``) and the train split's size, whose images come from the
seed.

Set-up builds one ``Trainer`` on the images, hands it the weights from the
seed (``Trainer.fresh_state``) and drives it through ``iter_chunk_plans``
and ``run_chunk``, the loop ``fit`` runs. ``run_chunk`` leaves the state it
is given unchanged, so from the same step-0 state it runs steps 1 and 2-3
of the first chunk's rows as chunks of one and two steps (the state after
step 1 and after step 3 exist only at a chunk's end), then the whole first
chunk of ``scan_steps`` steps, whose state the window goes on from. The
window runs whole chunks, each fenced by the host read ``run_chunk`` makes
of its metrics, until ``seconds`` have passed: ``train_img_per_s`` is the
images of those chunks over their time. Once the window has closed and
the program is freed, the reference follows the first three steps from
the same weights and images, and the numbers compared are

* ``loss1_gap``: the first step's loss, as the first whole chunk reports
  it, its relative gap (the later steps' losses swing with the decoder's
  log-variance, whose first updates move them by percent, and are given
  as ``loss_gap_steps``, not compared);
* ``grad_gap``: the first gradient as the optimizer got it (Adam's first
  moment after step 1, over ``1 - b1``), the worst leaf's norm gap;
* ``grad_err``: the same gradient, the worst leaf's norm of the
  difference over the larger of its reference norm and the median
  leaf's (a norm gap barely moves under per-element noise, so a lower
  precision shows only here);
* ``change_gap``: the parameters' change over the three steps, the worst
  leaf's norm gap, leaving out the leaves whose first gradient in the
  reference is under a thousandth of the median leaf's;
* ``nonfinite_losses``: the step losses of every whole chunk, the
  window's and the traced run's included, that are not finite (limit 0).
"""

from __future__ import annotations

import math
import statistics
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from portbench.core import compare, inputs
from portbench.core.trace import capture, span
from portbench.generators import common
from portbench.reference import model, optim
from portbench.reference import train as reference

CHECK_STEPS = 3
ZERO_GRAD = 1e-3   # a leaf's first gradient under this share of the median


def first_grad(opt_state, names, sizes):
    """The clipped first gradient, from Adam's first moment after one
    step, split into leaves."""
    flat = opt_state.mu.float().cpu() / (1.0 - optim.B1)
    return dict(zip(names, torch.split(flat, sizes)))


def leaf_gaps(params0, prog_grad, prog_params, ref):
    """Each leaf's norm gap (``compare.norm_gaps``) of the first gradient
    and of the change over the three steps, the latter leaving out the
    leaves whose first gradient in the reference is under ``ZERO_GRAD`` of
    the median leaf's."""
    raw = {k: float(v.norm()) for k, v in ref.first_raw.items()}
    med = statistics.median(raw.values())
    moved = {k for k, n in raw.items() if n >= ZERO_GRAD * med}
    change_p = {k: prog_params[k].cpu() - params0[k].cpu() for k in params0}
    change_r = {k: ref.params[k].cpu() - params0[k].cpu() for k in params0}
    return (compare.norm_gaps(prog_grad, {k: v.cpu() for k, v in
                                          ref.first_grad.items()}),
            compare.norm_gaps(change_p, change_r, keep=moved))


def numbers(cfg, params0, prog_losses, prog_grad, prog_params, ref):
    """The numbers worked out (module docstring); those the cell's limits
    name are compared. ``prog_losses``: every step loss the program
    reported, from step 1 on."""
    grad, change = leaf_gaps(params0, prog_grad, prog_params, ref)
    err = compare.diff_gaps({k: v.cpu() for k, v in prog_grad.items()},
                            {k: v.cpu() for k, v in ref.first_grad.items()})
    return {
        'loss1_gap': compare.rel_gap(prog_losses[0], ref.losses[0]),
        'loss_gap_steps': max(compare.rel_gap(a, b)
                              for a, b in zip(prog_losses, ref.losses)),
        'grad_gap': max(grad.values()),
        'grad_err': max(err.values()),
        'change_gap': max(change.values()),
        'nonfinite_losses': float(sum(not math.isfinite(x)
                                      for x in prog_losses)),
    }


class Start(NamedTuple):
    """A trainer driven through its first chunk, and what the check
    needs of its first steps."""
    trainer: object
    state: object
    chunks: object           # the trainer's chunk iterator, mid-run
    seed32: int
    train_u8: np.ndarray
    params0: dict
    losses: list             # the first whole chunk's step losses
    grad1: dict
    params3: dict


def start(cell, seed: int, device, t_start: float = 0.0) -> Start:
    """Set-up (module docstring): the trainer on the seed's images and
    weights, steps 1-3 as chunks of one and two steps, then the first
    whole chunk from step 0."""
    from gmvae_tpu_torch import data as data_lib
    from gmvae_tpu_torch import training

    cfg = cell.config
    if int(cell.traffic['global_batch']) != cfg['batch_size']:
        raise ValueError('the mix\'s global batch is not the configuration\'s')
    if cfg['metrics_mode'] != 'stacked':
        raise ValueError('the check reads each step\'s loss: metrics_mode '
                         'must be \'stacked\'')
    pcfg = common.port_config(cfg, seed)
    common.stage(t_start, 'set-up, import')
    train_u8 = inputs.images_u8(cfg['train_examples'], cfg['image_shape'],
                                seed, device)
    common.stage(t_start, 'set-up, images')
    labels = np.zeros(train_u8.shape[0], np.int32)
    ds = data_lib.Dataset(cfg['name'], train_u8, labels, train_u8[:1],
                          labels[:1])
    trainer = training.Trainer(pcfg, ds, device=device)
    params0 = model.make_params(cfg, seed, device)
    common.check_layout(cfg, trainer.model.state_dict())
    state0 = trainer.fresh_state({k: v.clone() for k, v in params0.items()})
    common.stage(t_start, 'set-up, trainer and weights')
    names = list(state0.params)
    sizes = [state0.params[k].numel() for k in names]

    chunks = trainer.iter_chunk_plans(0, 10 ** 9)
    _, payload = next(chunks)
    state, _ = trainer.run_chunk(state0, payload[:1])
    grad1 = first_grad(state.opt_state, names, sizes)
    state, _ = trainer.run_chunk(state, payload[1:CHECK_STEPS])
    params3 = {k: v.cpu() for k, v in state.params.items()}
    common.stage(t_start, 'set-up, steps 1-3')
    state, m = trainer.run_chunk(state0, payload)
    losses = m['loss'].tolist()
    common.sync(device)
    common.stage(t_start, 'set-up, first chunk')
    return Start(trainer, state, chunks, pcfg.seed, train_u8, params0,
                 losses, grad1, params3)


def check(cell, st: Start, device, later_losses=()):
    """The numbers compared, the reference worked out from ``st``'s
    weights and images; ``later_losses``: the step losses of the chunks
    run after the first."""
    ref = reference.train_steps(cell.config, st.params0, st.train_u8,
                                st.seed32, CHECK_STEPS, device)
    return numbers(cell.config, st.params0, st.losses + list(later_losses),
                   st.grad1, st.params3, ref)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> common.Outcome:
    st = start(cell, seed, device, t_start)
    trainer, state, chunks = st.trainer, st.state, st.chunks
    st = st._replace(trainer=None, state=None, chunks=None)

    seen = []    # the step losses of every chunk from here on

    def chunk(state):
        _, payload = next(chunks)
        with span('portbench.chunk'):
            state, m = trainer.run_chunk(state, payload)
        seen.extend(m['loss'].tolist())
        return state, payload.shape[0]

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps, ends = 0, []
    while True:
        state, s = chunk(state)
        steps += s
        ends.append(time.perf_counter() - t0)
        window = ends[-1]
        if window >= seconds:
            break
    times = np.diff([0.0] + ends)
    print(f'window: {len(ends)} chunks, a chunk {times.min():.4f} / '
          f'{np.median(times):.4f} / {times.max():.4f} s (least / median / '
          f'most)', file=sys.stderr)
    rows = trainer.b_local
    e2e = {'train_img_per_s': steps * cell.config['batch_size'] / window,
           'setup_s': setup_s}
    layers = None
    if trace:
        def run_chunks(n):
            nonlocal state
            done = 0
            for _ in range(n):
                state, s = chunk(state)
                done += s
            return done
        traced = []
        tr = capture(
            lambda: traced.append(run_chunks(cell.traffic['trace_chunks'])),
            lambda: common.sync(device), lambda: run_chunks(1))
        layers = common.LayerContext('train', cell.config, rows, tr,
                                     traced[0], window, steps, e2e)
    peak = common.memory_peak(device)
    del trainer, state, chunks
    common.free(device)
    t_check = time.perf_counter()
    vals = check(cell, st, device, seen)
    common.stage(t_check, 'the check')
    return common.Outcome(
        end_to_end=e2e,
        attempted=steps, failed=0,
        checks=compare.checks(vals, cell.limits), readings=vals,
        layers=layers, memory_peak_bytes=peak)
