"""The reference's training steps and cluster assignment, float32.

``train_steps`` follows a run from its first step: the batch plan (the
threefry epoch permutations; with a sharded train set each rank's own plan
over its own block, under ``fold_in(plan_key, rank)``), each step's key
``fold_in(fold_in(PRNGKey(seed), step), rank)`` split into a
preprocessing key and the head's key, the batch as ``u8 / 255`` (sampled
to 0/1 by the preprocessing key's uniforms when the configuration
binarizes), the head's threefry noise, the loss's gradient by autograd,
the clip and Adam. With ``n_dp`` ranks, every rank's rows of the step are
worked out and the gradients averaged, as one step of the global batch.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from portbench.reference import model, optim
from portbench.reference import threefry as tf


class Steps(NamedTuple):
    losses: List[float]            # each step's loss (the ranks' mean)
    first_grad: model.Params       # step 1's gradient after the clip
    first_raw: model.Params        # step 1's gradient before the clip
    params: model.Params           # the parameters after the last step


def rank_rows(cfg: dict, seed: int, n_data: int, rank: int, n_dp: int,
              steps, device) -> torch.Tensor:
    """``[len(steps), batch // n_dp]`` rows into rank ``rank``'s train
    set (its block when sharded, else the whole set)."""
    plan_key = tf.fold_in(tf.prng_key(seed), 1)
    b_local = cfg['batch_size'] // n_dp
    if cfg['data_sharding'] == 'sharded':
        return tf.batch_rows(tf.fold_in(plan_key, rank), n_data, b_local,
                             steps, device)
    rows = tf.batch_rows(plan_key, n_data, cfg['batch_size'], steps, device)
    return rows[:, rank * b_local:(rank + 1) * b_local]


def shard(cfg: dict, train_u8: np.ndarray, rank: int, n_dp: int):
    """Rank ``rank``'s block of the train set: the rows padded by
    wrapping to a multiple of ``n_dp``, one contiguous block a rank."""
    if cfg['data_sharding'] != 'sharded' or n_dp == 1:
        return train_u8
    n = train_u8.shape[0]
    idx = np.arange(-(-n // n_dp) * n_dp) % n
    per = idx.shape[0] // n_dp
    return train_u8[idx[rank * per:(rank + 1) * per]]


def batch(cfg: dict, u8: torch.Tensor, key, device) -> torch.Tensor:
    x = u8.to(device, torch.float32) * (1.0 / 255.0)
    x = x.reshape(x.shape[0], *cfg['image_shape'])
    if cfg['binarize']:
        x = (tf.uniform01(key, x.shape, device) < x).to(torch.float32)
    return x


def train_steps(cfg: dict, params0: model.Params, train_u8: np.ndarray,
                seed: int, n_steps: int, device, n_dp: int = 1,
                cast: model.Cast = model.identity,
                keep_rows: float = 1.0,
                grad_fault: Optional[Callable[[model.Params],
                                              model.Params]] = None
                ) -> Steps:
    """``n_steps`` steps from ``params0`` (module docstring).
    ``keep_rows`` < 1 keeps only the first share of each batch's rows;
    ``grad_fault`` changes each step's gradient before the clip (faults
    the benchmark's readings plant)."""
    params = {k: v.detach().to(device, torch.float32).clone()
              for k, v in params0.items()}
    state = optim.init(cfg, params)
    b_local = cfg['batch_size'] // n_dp
    k, d = cfg['n_components'], cfg['latent_dim']
    blocks = [shard(cfg, train_u8, r, n_dp) for r in range(n_dp)]
    plans = [rank_rows(cfg, seed, blocks[r].shape[0], r, n_dp,
                       range(n_steps), 'cpu') for r in range(n_dp)]
    losses, first_grad, first_raw = [], None, None
    for step in range(n_steps):
        tau = tf.temperature(step, cfg['tau0'], cfg['tau_min'],
                             cfg['tau_anneal'])
        beta = (min(1.0, (step + 1.0) / cfg['kl_warmup_steps'])
                if cfg['kl_warmup_steps'] > 0 else 1.0)
        grads = {n: torch.zeros_like(v) for n, v in params.items()}
        step_loss = 0.0
        for r in range(n_dp):
            key = tf.fold_in(tf.fold_in(tf.prng_key(seed), step), r)
            k_pre, k_elbo = tf.split(key)
            rows = plans[r][step].numpy()
            keep = max(1, int(round(b_local * keep_rows)))
            x = batch(cfg, torch.from_numpy(blocks[r][rows[:keep]]), k_pre,
                      device)
            g, eps = tf.head_noise(k_elbo, keep, k, d, device=device)
            leaves = {n: v.detach().requires_grad_(True)
                      for n, v in params.items()}
            out = model.loss(cfg, leaves, x, g, eps, tau, beta, cast)
            gr = torch.autograd.grad(out, list(leaves.values()))
            for n, t in zip(leaves, gr):
                grads[n] += t / n_dp
            step_loss += float(out.detach()) / n_dp
        losses.append(step_loss)
        if grad_fault is not None:
            grads = grad_fault(grads)
        clipped = optim.clip(cfg, grads)
        if step == 0:
            first_grad, first_raw = clipped, grads
        params, state = optim.adam(cfg, params, clipped, state)
    return Steps(losses, first_grad, first_raw, params)


@torch.no_grad()
def cluster_logits(cfg: dict, params: model.Params, images: torch.Tensor,
                   device, block: int = 2048,
                   cast: model.Cast = model.identity) -> torch.Tensor:
    """q(k|x) logits ``[N, K]`` (float32, on ``device``) of float32 NHWC
    ``images`` in [0, 1], in blocks of rows."""
    p = {k: v.to(device, torch.float32) for k, v in params.items()}
    out = [model.encode(cfg, p, images[i:i + block].to(device), cast)[0]
           for i in range(0, images.shape[0], block)]
    return torch.cat(out)
