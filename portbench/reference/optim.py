"""The gradient clip and Adam in plain PyTorch, float32: the reference's
optimizer.

A step takes the loss's gradient per leaf, clips it (``global``: the whole
gradient scaled to norm ``max`` when above it; ``per_leaf``: each leaf
scaled by ``min(1, max / max(|g|, 1e-12))``; ``value``: each element into
``[-max, max]``), then Adam: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 -
b2) g^2``, both kept in the configuration's moment type, and the update
``-lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}

Tree = Dict[str, torch.Tensor]


def clip(cfg: dict, grads: Tree) -> Tree:
    max_norm, impl = cfg['grad_clip'], cfg['grad_clip_impl']
    if max_norm <= 0:
        return grads
    if impl == 'per_leaf':
        return {k: g * min(1.0, max_norm / max(float(g.norm()), 1e-12))
                for k, g in grads.items()}
    if impl == 'global':
        n = float(torch.sqrt(sum(torch.sum(g * g) for g in grads.values())))
        s = 1.0 if n < max_norm else max_norm / n
        return {k: g * s for k, g in grads.items()}
    if impl == 'value':
        return {k: torch.clamp(g, -max_norm, max_norm)
                for k, g in grads.items()}
    raise ValueError(f'unknown grad_clip_impl {impl!r}')


def init(cfg: dict, params: Tree) -> Tuple[int, Tree, Tree]:
    dt = _DTYPES[cfg['opt_state_dtype']]
    return (0, {k: torch.zeros_like(v, dtype=dt) for k, v in params.items()},
            {k: torch.zeros_like(v, dtype=dt) for k, v in params.items()})


def adam(cfg: dict, params: Tree, grads: Tree, state):
    """One update of ``params`` by the (already clipped) ``grads``:
    (new params, new state)."""
    count, mu, nu = state
    count += 1
    dt = _DTYPES[cfg['opt_state_dtype']]
    bc1, bc2 = 1.0 - B1 ** count, 1.0 - B2 ** count
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = B1 * mu[k].float() + (1 - B1) * g
        v = B2 * nu[k].float() + (1 - B2) * g * g
        new_p[k] = p - cfg['lr'] * (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        new_mu[k], new_nu[k] = m.to(dt), v.to(dt)
    return new_p, (count, new_mu, new_nu)
