"""Model FLOPs counted on the benchmark's plain reference, by shape: the
GEMMs and convolutions that torch's flop counter sees (run on the meta
device, so nothing is computed), plus the head's operations from
``bounds``, which no counter sees inside a kernel. The count follows the
model, not the program, so a change to the program cannot change it."""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import model
from portbench.yardstick import bounds


def _meta_params(cfg: dict):
    return {k: torch.empty(s, device='meta', requires_grad=True)
            for k, s, _ in model.layout(cfg)}


@functools.lru_cache(maxsize=None)
def _train_nets(cfg_json: str, b: int) -> int:
    cfg = json.loads(cfg_json)
    p = _meta_params(cfg)
    x = torch.empty(b, *cfg['image_shape'], device='meta')
    z = torch.empty(b, cfg['latent_dim'], device='meta', requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        outs = [*model.encode(cfg, p, x), model.decode(cfg, p, z)]
        torch.autograd.grad(sum(o.sum() for o in outs),
                            [*p.values(), z], allow_unused=True)
    return fc.get_total_flops()


def train_step_flops(cfg: dict, b: int) -> int:
    """One training step of ``b`` rows: the nets' forward and backward
    (the input images need no gradient) and the head's forward and
    backward kernels' operations."""
    k, d = cfg['n_components'], cfg['latent_dim']
    head = (bounds.head_fwd_work(b, k, d, False).flops
            + bounds.head_bwd_work(b, k, d, False).flops)
    return _train_nets(json.dumps(cfg, sort_keys=True), b) + head


def assign_flops(cfg: dict, b: int) -> int:
    """Cluster assignment of ``b`` images: the encoder's forward and the
    cluster-logit head (the argmax is not counted)."""
    p = _meta_params(cfg)
    x = torch.empty(b, *cfg['image_shape'], device='meta')
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model._dense(p, 'k_head', model.features(cfg, p, x), model.identity)
    return fc.get_total_flops()
