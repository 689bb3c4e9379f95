"""Training and eval runtime: the port of ``gmvae_tpu/training.py``.

A step is a pure function of ``(params, opt_state, seed, step)`` as in the
reference: its key is ``fold_in(fold_in(PRNGKey(seed), step), shard)``,
split into a binarization key and a head key; the batch is a gather from the
train set, resident on the device as uint8 rows (flat ``[N, P]`` for MLP
archs) and indexed by the batch plan ``epoch_batch_indices(fold_in(
PRNGKey(seed), 1), ...)``, bit for bit the reference's. The loss is the
annealed negative ELBO plus the balance and confidence regularizers; the
update is Adam with its moments stored in ``opt_state_dtype`` after an
optional gradient clip.

Data parallelism is one process for each device in a ``torch.distributed``
group (``parallel/mesh.py``), the rank being the reference's shard index on
its ``('data',)`` axis. Each rank takes ``batch_size // world`` rows a step:
its column block of the one global plan (``data_sharding='replicated'``), or
its own plan over its own block of the train set (``'sharded'``, the
reference's per-shard plan key ``fold_in(plan_key, rank)``). After the
backward, one all-reduce averages the flat gradient and the step's device
metrics in one buffer, the reference's ``pmean``; the clip and Adam then
run on the average, the same bits on every rank. Without a group the same
code runs as shard 0 of 1. ``data_placement='host_stream'`` keeps the train
set in (pinned) host memory and stages each chunk's batches to the device
on a copy stream, one chunk ahead of the compute.

The reference scans ``scan_steps`` steps inside one compiled program; here
a chunk is a Python loop over the same steps that reads nothing back from
the device until its end. The model's parameters are views into one flat
float32 buffer, so the gradient is one concatenation and the optimizer a
handful of elementwise launches over that buffer.

Eval sweeps the test set in fixed-size batches exactly as the reference
does: the set is padded by tiling to a multiple of the batch, batch ``c``
gets the key ``fold_in(prng_key(17), c * batch)``, each batch splits it
into a binarization key and an ELBO key, and the ELBO key splits into one
key per eval sample.
"""

from __future__ import annotations

import functools
import math
import os
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Tuple,
                    Union)

import numpy as np
import torch

from gmvae_tpu_torch import data as data_lib
from gmvae_tpu_torch import dists, prng
from gmvae_tpu_torch.configs import Config
from gmvae_tpu_torch.deep import DeepGMVAE
from gmvae_tpu_torch.elbo import mixture_elbo_head
from gmvae_tpu_torch.gmvae import GMVAE
from gmvae_tpu_torch.ops.kernels.fused_elbo import fused_mixture_elbo
from gmvae_tpu_torch.parallel import mesh
from gmvae_tpu_torch.parallel.mesh import pad_to_multiple
from gmvae_tpu_torch.utils import checkpoint as ckpt_lib
from gmvae_tpu_torch.utils import metrics as metrics_lib
from gmvae_tpu_torch.utils.logging import RunLogger, save_image_grid
from gmvae_tpu_torch.utils.profiling import span

Model = Union[GMVAE, DeepGMVAE]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist, and float32
    matmuls on it must not run in TF32 (the reference contracts in full
    float32)."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device: gmvae_tpu_torch runs on the GPU by default; '
                "pass device='cpu' for the plain versions on the CPU")
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                'torch.backends.cuda.matmul.allow_tf32 is on: float32 '
                'matmuls would run in TF32; turn it off')
    return dev


def head_for(cfg: Config) -> Callable:
    """The head the config asks for, as the reference picks it: the fused
    head (the CUDA kernels on the card) when ``cfg.fused``, drawing its
    noise in the kernel (``fused_noise`` 'auto'/'threefry') or streaming
    the unfused head's noise ('xla'); else the unfused head."""
    if cfg.fused_noise not in ('auto', 'threefry', 'xla'):
        raise ValueError(f'fused_noise must be auto|threefry|xla, '
                         f'got {cfg.fused_noise!r}')
    if not cfg.fused:
        return mixture_elbo_head
    if cfg.fused_noise == 'xla':
        return functools.partial(fused_mixture_elbo, noise_mode='xla')
    return fused_mixture_elbo


def make_model(cfg: Config, device='cuda') -> Model:
    """The configured model on ``device``, parameters drawn from
    ``cfg.seed``: a ``GMVAE`` with the head ``head_for`` picks, or a
    ``DeepGMVAE``, which has no head to fuse and ignores ``cfg.fused``."""
    if cfg.model_family not in ('gmvae', 'deep'):
        raise ValueError(f'model_family must be gmvae|deep, '
                         f'got {cfg.model_family!r}')
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.model_family == 'deep':
        model = DeepGMVAE(cfg, generator=gen)
    else:
        model = GMVAE(cfg, head_fn=head_for(cfg), generator=gen)
    return model.to(dev).eval()


# ---------------------------------------------------------------------------
# optimizer over one flat float32 gradient
# ---------------------------------------------------------------------------
#
# A clip is ``clip(g, sizes) -> g``, ``sizes`` the leaf lengths that
# partition the flat gradient ``g`` (the per-leaf clip reads them).


def clip_by_global_norm(max_norm: float) -> Callable:
    """optax.clip_by_global_norm: above ``max_norm``, ``g / |g| * max``."""
    def clip(g, sizes):
        n = torch.linalg.vector_norm(g)
        return torch.where(n < max_norm, g, (g / n) * max_norm)
    return clip


def clip_by_leaf_norm(max_norm: float) -> Callable:
    """Each leaf scaled to norm <= ``max_norm`` on its own:
    ``g * min(1, max / max(|g|, 1e-12))``."""
    def clip(g, sizes):
        leaves = torch.split(g, list(sizes))
        norms = torch.stack(torch._foreach_norm(leaves))
        scale = torch.clamp_max(max_norm / torch.clamp_min(norms, 1e-12), 1.0)
        return g * torch.repeat_interleave(
            scale, torch.tensor(list(sizes), device=g.device),
            output_size=g.numel())
    return clip


def clip_by_value(max_delta: float) -> Callable:
    """optax.clip: each element into ``[-max_delta, max_delta]``."""
    return lambda g, sizes: torch.clamp(g, -max_delta, max_delta)


_CLIPS = {'global': clip_by_global_norm, 'per_leaf': clip_by_leaf_norm,
          'value': clip_by_value}
_STATE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class AdamState(NamedTuple):
    count: int             # steps taken
    mu: torch.Tensor       # first moment, flat, in the storage dtype
    nu: torch.Tensor       # second moment

    def clone(self) -> 'AdamState':
        return AdamState(self.count, self.mu.clone(), self.nu.clone())


class Optimizer(NamedTuple):
    """``init(flat_params) -> AdamState``; ``update(g, state, sizes) ->
    (u, state')``, the update ``u`` to add to the flat parameters."""
    init: Callable[[torch.Tensor], AdamState]
    update: Callable[..., Tuple[torch.Tensor, AdamState]]


def scale_by_adam_lowmem(b1: float = 0.9, b2: float = 0.999,
                         eps: float = 1e-8,
                         state_dtype: torch.dtype = torch.bfloat16
                         ) -> Optimizer:
    """Adam's moment tracking with the moments stored in ``state_dtype``
    and every operation in float32, as the reference's transform: each
    step upcasts m and v, blends them with the gradient, bias-corrects with
    ``1 - b^count`` taken in float32, and downcasts for storage. Its
    ``update`` is the direction, before the learning rate."""
    f32 = np.float32

    def init(params):
        return AdamState(0, torch.zeros_like(params, dtype=state_dtype),
                         torch.zeros_like(params, dtype=state_dtype))

    def update(g, state, sizes=None):
        count = state.count + 1
        c = f32(count)
        bc1 = float(f32(1.0) - f32(b1) ** c)
        bc2 = float(f32(1.0) - f32(b2) ** c)
        mu = b1 * state.mu.float() + (1 - b1) * g
        nu = b2 * state.nu.float() + (1 - b2) * torch.square(g)
        out = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        return out, AdamState(count, mu.to(state_dtype), nu.to(state_dtype))

    return Optimizer(init, update)


def make_optimizer(cfg: Config) -> Optimizer:
    """The ``grad_clip_impl`` clip when ``grad_clip > 0``, then Adam with
    its moments in ``opt_state_dtype``, scaled by ``-lr``: the reference's
    ``chain(clip, adam, scale(-lr))``. With float32 moments it is
    ``optax.adam`` (and ``torch.optim.Adam``)."""
    if cfg.opt_state_dtype not in _STATE_DTYPES:
        raise ValueError(f'opt_state_dtype must be float32|bfloat16, '
                         f'got {cfg.opt_state_dtype!r}')
    clip = None
    if cfg.grad_clip > 0:
        if cfg.grad_clip_impl not in _CLIPS:
            raise ValueError(f'grad_clip_impl must be one of {sorted(_CLIPS)}'
                             f', got {cfg.grad_clip_impl!r}')
        clip = _CLIPS[cfg.grad_clip_impl](cfg.grad_clip)
    adam = scale_by_adam_lowmem(state_dtype=_STATE_DTYPES[cfg.opt_state_dtype])
    lr = cfg.lr

    def update(g, state, sizes):
        if clip is not None:
            with span('gmvae.clip'):
                g = clip(g, sizes)
        u, state = adam.update(g, state)
        return u * -lr, state

    return Optimizer(adam.init, update)


# ---------------------------------------------------------------------------
# loss and step
# ---------------------------------------------------------------------------


def schedules(cfg: Config, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tau, beta) at a step, float32 scalars on the host: the temperature
    anneal and the linear KL warmup (beta = 1 without one)."""
    if cfg.kl_warmup_steps > 0:
        beta = torch.clamp_max(
            (torch.tensor(step, dtype=torch.float32) + 1.0)
            / cfg.kl_warmup_steps, 1.0)
    else:
        beta = torch.tensor(1.0)
    tau = dists.temperature_schedule(step, cfg.tau0, cfg.tau_min,
                                     cfg.tau_anneal)
    return tau, beta


# the per-step metrics, in this order; the first five are computed on the
# device, tau and beta on the host
METRIC_KEYS = ('loss', 'elbo', 'log_px_z', 'kl', 'kl_cat', 'tau', 'beta')


def make_loss_fn(model: Model, cfg: Config) -> Callable:
    """``loss_fn(x, key, step) -> (loss, metrics)``: the negative ELBO with
    the KL annealed by beta, plus the balance regularizer KL(mean_batch
    q(k|x) || uniform) and the confidence regularizer E_x[H(q(k|x))] when
    weighted. The reported ``elbo`` is never annealed."""
    def loss_fn(x: torch.Tensor, key: prng.Key, step: int):
        tau, beta = schedules(cfg, step)
        elbo, aux = model.elbo_terms(x, key, tau)
        log_px_z = aux['log_px_z']
        kl_total = log_px_z - elbo   # whatever the elbo_form charges
        loss = -torch.mean(log_px_z - beta * kl_total)
        if cfg.balance_weight > 0:
            qbar = torch.mean(torch.softmax(aux['k_logits'], dim=-1), dim=0)
            k = qbar.shape[-1]
            balance = torch.sum(qbar * torch.log(qbar * k + 1e-12))
            loss = loss + cfg.balance_weight * balance
        if cfg.conf_weight > 0:
            logq = torch.log_softmax(aux['k_logits'], dim=-1)
            ent = -torch.sum(torch.exp(logq) * logq, dim=-1)
            loss = loss + cfg.conf_weight * torch.mean(ent)
        metrics = {'loss': loss, 'elbo': torch.mean(elbo),
                   'log_px_z': torch.mean(log_px_z),
                   'kl': torch.mean(kl_total),
                   'kl_cat': torch.mean(aux['kl_cat']), 'tau': tau,
                   'beta': beta}
        assert tuple(metrics) == METRIC_KEYS
        return loss, metrics
    return loss_fn


def flatten_params(model: torch.nn.Module) -> torch.Tensor:
    """Move the model's parameters into one contiguous float32 buffer, in
    ``named_parameters`` order, and return it; each parameter becomes a
    view of it."""
    params = list(model.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    off = 0
    for p in params:
        n = p.numel()
        p.data = flat[off:off + n].view_as(p)
        off += n
    return flat


def make_train_step(model: Model, cfg: Config, tx: Optimizer,
                    flat: torch.Tensor, shard: int = 0) -> Callable:
    """``train_step(opt_state, batch_u8, base_key, step) -> (opt_state,
    device metrics [5], (tau, beta))``: one update of ``flat`` (the
    model's parameter buffer, see ``flatten_params``) in place, from this
    process's ``shard`` of the step's batch. The gradient and the device
    metrics go through one all-reduce (``mesh.all_reduce_mean_``; nothing
    without a process group) before the clip and Adam."""
    loss_fn = make_loss_fn(model, cfg)
    params = list(model.parameters())
    sizes = [p.numel() for p in params]
    n = sum(sizes)

    def train_step(opt_state, batch_u8: torch.Tensor, base_key: prng.Key,
                   step: int):
        key = prng.fold_in(prng.fold_in(base_key, step), shard)
        k_pre, k_elbo = prng.split(key)
        with span('gmvae.data_gather'):
            x = data_lib.preprocess_batch(k_pre, batch_u8, cfg.binarize)
        with torch.enable_grad():
            loss, m = loss_fn(x, k_elbo, step)
            grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            buf = torch.cat([t.reshape(-1) for t in grads]
                            + [m[k].detach().float().reshape(1)
                               for k in METRIC_KEYS[:5]])
            mesh.all_reduce_mean_(buf)
            with span('gmvae.optimizer'):
                updates, opt_state = tx.update(buf[:n], opt_state, sizes)
                flat.add_(updates)
        # a copy: a view would keep the whole buffer alive for the chunk
        return opt_state, buf[n:].clone(), (m['tau'], m['beta'])

    return train_step


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # the model's state_dict
    opt_state: Optional[AdamState]    # None: parameters for eval only
    step: int


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------


def make_eval_step(model: Model, cfg: Config) -> Callable:
    """``eval_step(batch_u8, key, step) -> (elbo [B], iwae [B], yhat [B])``:
    the mean of S single-sample ELBOs, the S-sample IWAE bound
    ``LSE - log S``, and argmax q(k|x)."""
    s = max(1, cfg.eval_samples)

    @torch.no_grad()
    def eval_step(batch_u8: torch.Tensor, key: prng.Key, step: int):
        k_pre, k_elbo = prng.split(key)
        x = data_lib.preprocess_batch(k_pre, batch_u8, cfg.binarize)
        tau = schedules(cfg, step)[0]
        runs = [model.elbo_terms(x, k, tau) for k in prng.split(k_elbo, s)]
        elbos = torch.stack([elbo for elbo, _ in runs])           # [S, B]
        iwae = torch.logsumexp(elbos, dim=0) - math.log(s)
        # the encoder is deterministic: any sample's logits give yhat
        yhat = torch.argmax(runs[0][1]['k_logits'], dim=-1)
        return elbos.mean(dim=0), iwae, yhat

    return eval_step


EVAL_SEED = 17   # the reference's fixed eval key


def evaluate(eval_step: Callable, cfg: Config, test_x: np.ndarray,
             test_y: Optional[np.ndarray], step: int, device
             ) -> Dict[str, float]:
    """Full test-set eval: ELBO and IWAE in nats, clustering ACC/NMI when
    labels are given. The padded set goes to the device once; batch ``c``
    is a slice of it.

    Under data parallelism every rank evaluates the whole set, with no
    collective: a test row's noise depends on its batch's key and its row
    in that batch, never on a rank, so every rank returns the same numbers,
    bit for bit those of the one-process eval of the same parameters."""
    bs = cfg.batch_size
    xs, n = pad_to_multiple(np.asarray(test_x), bs)
    x_dev = torch.from_numpy(np.ascontiguousarray(xs)).to(device)
    key = prng.prng_key(EVAL_SEED)
    elbos, iwaes, yhats = [], [], []
    for c in range(xs.shape[0] // bs):
        e, iw, y = eval_step(x_dev[c * bs:(c + 1) * bs],
                             prng.fold_in(key, c * bs), step)
        elbos.append(e)
        iwaes.append(iw)
        yhats.append(y)
    elbo = torch.cat(elbos)[:n].cpu().numpy()
    iwae = torch.cat(iwaes)[:n].cpu().numpy()
    out = {'elbo_nats': float(elbo.mean()), 'iwae_nats': float(iwae.mean())}
    if test_y is not None:
        yhat = torch.cat(yhats)[:n].cpu().numpy()
        out['acc'] = metrics_lib.cluster_acc(test_y, yhat)
        out['nmi'] = metrics_lib.nmi(test_y, yhat)
    return out


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _chunk_metrics(cfg: Config, dev_rows: List[torch.Tensor],
                   host_rows: List[Tuple[torch.Tensor, torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
    """A chunk's metrics as float32 CPU tensors: ``[S]`` per key
    ('stacked'), or the chunk mean as ``[1]`` ('mean'), summed in step
    order as the reference's scan carry does."""
    dev = torch.stack(dev_rows).cpu()                             # [S, 5]
    host = torch.stack([torch.stack(r) for r in host_rows])       # [S, 2]
    cols = torch.cat([dev, host.to(torch.float32)], dim=1)        # [S, 7]
    if cfg.metrics_mode == 'mean':
        acc = torch.zeros(cols.shape[1])
        for row in cols:
            acc = acc + row
        cols = (acc / float(cols.shape[0]))[None]
    return {k: cols[:, i].clone() for i, k in enumerate(METRIC_KEYS)}


class Staged(NamedTuple):
    """One chunk's batches staged for ``host_stream`` placement: ``[S,
    b_local, H, W, C]`` uint8 on the trainer's device, and on a card the
    event after which their copy is complete (None on the CPU)."""
    batches: torch.Tensor
    ready: Optional[Any] = None


def rank_plan(cfg: Config, base_key: prng.Key, n_local: int, rank: int,
              n_dp: int, n_steps: int, start_step: int = 0,
              device=None) -> torch.Tensor:
    """``[n_steps, batch_size // n_dp]`` rows of rank ``rank``'s train
    set for steps ``[start_step, start_step + n_steps)``: its column block
    of the global plan from ``fold_in(PRNGKey(seed), 1)`` (replicated data),
    or, for a sharded train set, its own plan over its ``n_local`` rows
    from ``fold_in(fold_in(PRNGKey(seed), 1), rank)``. The ranks' blocks
    side by side are the reference's ``Trainer.batch_plan`` at
    ``dp_devices=n_dp``."""
    plan_key = prng.fold_in(base_key, 1)
    b_local = cfg.batch_size // n_dp
    if cfg.data_sharding == 'sharded':
        return data_lib.epoch_batch_indices(
            prng.fold_in(plan_key, rank), n_local, b_local, n_steps,
            start_step, device=device)
    idx = data_lib.epoch_batch_indices(plan_key, n_local, cfg.batch_size,
                                       n_steps, start_step, device=device)
    return idx[:, rank * b_local:(rank + 1) * b_local]


class Trainer:
    """Owns a config's model, optimizer, train set and eval step on one
    device, as one rank of the data-parallel group when there is one
    (``parallel/mesh.py``; ``Trainer`` starts it from torchrun's variables).
    """

    def __init__(self, cfg: Config,
                 dataset: Optional[data_lib.Dataset] = None, device='cuda'):
        if cfg.metrics_mode not in ('stacked', 'mean'):
            raise ValueError(f'metrics_mode must be stacked|mean, '
                             f'got {cfg.metrics_mode!r}')
        if cfg.data_sharding not in ('replicated', 'sharded'):
            raise ValueError(f'data_sharding must be replicated|sharded, '
                             f'got {cfg.data_sharding!r}')
        if cfg.data_placement not in ('device', 'host_stream'):
            raise ValueError(f'data_placement must be device|host_stream, '
                             f'got {cfg.data_placement!r}')
        if (cfg.data_placement == 'host_stream'
                and cfg.data_sharding != 'replicated'):
            # streaming bounds device memory to the staged chunks; a
            # sharded train set solves the same problem another way, and
            # its per-rank plans do not apply to staged batches
            raise ValueError("data_placement='host_stream' requires "
                             "data_sharding='replicated'")
        self.cfg = cfg
        self.device = resolve_device(mesh.device_for_rank(device))
        mesh.init_distributed(self.device)
        self.rank, self.n_dp = mesh.world()
        if cfg.dp_devices not in (-1, 0, self.n_dp):
            raise ValueError(
                f'dp_devices={cfg.dp_devices}, but this process group has '
                f'{self.n_dp} rank(s): the port runs one process for each '
                f'device, so start {cfg.dp_devices} processes (torchrun or '
                f'parallel/launch.py) or set dp_devices=-1 (the group\'s '
                f'size)')
        if cfg.batch_size % self.n_dp:
            raise ValueError(f'batch_size {cfg.batch_size} not divisible by '
                             f'data-parallel size {self.n_dp}')
        self.b_local = cfg.batch_size // self.n_dp
        self.dataset = dataset or data_lib.load(cfg.dataset,
                                                image_shape=cfg.image_shape)
        self.model = make_model(cfg, self.device)
        self.flat = flatten_params(self.model)
        self.tx = make_optimizer(cfg)
        self.train_step = make_train_step(self.model, cfg, self.tx, self.flat,
                                          shard=self.rank)
        self.eval_step = make_eval_step(self.model, cfg)
        self.base_key = prng.prng_key(cfg.seed)
        xs = np.asarray(self.dataset.train_x)
        if cfg.data_placement == 'host_stream':
            # the train set stays in host memory (pinned on a card, so the
            # chunks' copies are asynchronous); the device holds only the
            # staged chunks
            host = torch.from_numpy(np.ascontiguousarray(xs))
            self.train_x_host = (host.pin_memory()
                                 if self.device.type == 'cuda' else host)
            self.x_all = None
            self.n_local = int(xs.shape[0])
            self._copy_stream = (torch.cuda.Stream(self.device)
                                 if self.device.type == 'cuda' else None)
            return
        # the train set on the device as uint8; MLP archs as flat [N, P]
        # rows (the model flattens its input anyway), gathered per step.
        # 'sharded': this rank's block of the padded set only
        if cfg.arch == 'mlp':
            xs = xs.reshape(xs.shape[0], -1)
        if cfg.data_sharding == 'sharded':
            xs = mesh.shard_rows(xs, self.rank, self.n_dp)
        self.x_all = torch.from_numpy(np.ascontiguousarray(xs)).to(
            self.device)
        self.n_local = int(self.x_all.shape[0])

    # -- state ----------------------------------------------------------
    def init_state(self) -> TrainState:
        """Step-0 state: parameters drawn from ``cfg.seed`` (the same on
        every rank), zero moments."""
        return self.fresh_state(make_model(self.cfg, self.device).state_dict())

    def fresh_state(self, params: Dict[str, torch.Tensor],
                    step: int = 0) -> TrainState:
        """``params`` (a state_dict on the device) with a fresh optimizer
        state: zero moments, count 0."""
        flat = torch.cat([p.reshape(-1) for p in params.values()])
        return TrainState(params, self.tx.init(flat), step)

    def bind(self, state: TrainState) -> Model:
        """Load ``state``'s parameters into the model and return it."""
        self.model.load_state_dict(state.params)
        return self.model

    def state_to_tree(self, state: TrainState) -> Dict[str, Any]:
        """``state`` as plain containers on the CPU (checkpoint format)."""
        opt = state.opt_state
        return {'params': {k: v.detach().cpu()
                           for k, v in state.params.items()},
                'opt_state': {'count': opt.count, 'mu': opt.mu.cpu(),
                              'nu': opt.nu.cpu()},
                'step': int(state.step)}

    def tree_to_state(self, tree: Dict[str, Any]) -> TrainState:
        """The inverse of ``state_to_tree``, on the trainer's device, with
        the moments cast to this config's ``opt_state_dtype`` (a snapshot
        taken under the other dtype restores into this one)."""
        dtype = _STATE_DTYPES[self.cfg.opt_state_dtype]
        opt = tree['opt_state']
        opt_state = AdamState(int(opt['count']),
                              opt['mu'].to(self.device, dtype),
                              opt['nu'].to(self.device, dtype))
        params = {k: v.to(self.device) for k, v in tree['params'].items()}
        return TrainState(params, opt_state, int(tree['step']))

    # -- data plan ------------------------------------------------------
    def batch_plan(self, n_steps: int, start_step: int = 0) -> torch.Tensor:
        """``[n_steps, batch_size // world]`` device indices into this
        rank's train set for steps ``[start_step, start_step + n_steps)``
        (``rank_plan``); with one process, the reference's whole plan."""
        if self.x_all is None:
            raise RuntimeError('host_stream placement uses batch_plan_host '
                               'and stage_batches')
        return rank_plan(self.cfg, self.base_key, self.n_local, self.rank,
                         self.n_dp, n_steps, start_step, device=self.device)

    def batch_plan_host(self, n_steps: int, start_step: int = 0
                        ) -> torch.Tensor:
        """The global ``[n_steps, batch_size]`` plan on the host, for
        ``host_stream`` placement: the same values as the replicated
        device plan (which is what makes streamed trajectories bit-equal to
        device placement); every rank computes it and stages its own
        columns (``stage_batches``)."""
        return data_lib.epoch_batch_indices(
            prng.fold_in(self.base_key, 1), self.n_local,
            self.cfg.batch_size, n_steps, start_step,
            device=self.device).cpu()

    def stage_batches(self, idx_host: torch.Tensor) -> Staged:
        """Gather this rank's rows of one chunk's global plan ``idx_host``
        ``[S, batch_size]`` on the host and start their copy to the device.
        On a card the rows land in pinned memory and go over on the copy
        stream without blocking, with an event that ``run_chunk`` makes
        the compute stream wait on, so chunk i+1's copy overlaps chunk i's
        steps (``iter_chunk_plans`` stages one chunk ahead)."""
        s = idx_host.shape[0]
        cols = idx_host[:, self.rank * self.b_local:
                        (self.rank + 1) * self.b_local].reshape(-1)
        shape = (s, self.b_local, *self.train_x_host.shape[1:])
        if self._copy_stream is None:
            return Staged(torch.index_select(self.train_x_host, 0,
                                             cols).reshape(shape))
        rows = torch.empty((cols.numel(), *self.train_x_host.shape[1:]),
                           dtype=self.train_x_host.dtype, pin_memory=True)
        torch.index_select(self.train_x_host, 0, cols, out=rows)
        with torch.cuda.stream(self._copy_stream):
            batches = rows.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return Staged(batches.reshape(shape), ready)

    def iter_chunk_plans(self, start: int, total: int):
        """Yield ``(n_steps, payload)`` per chunk of ``scan_steps`` steps
        for steps ``[start, total)``: the chunk's rows of this rank's plan
        (device placement) or its ``Staged`` batches (``host_stream``,
        staged one chunk ahead). Plans are generated a window at a time
        (~2M indices, at least 8 chunks); a run longer than one window
        always generates full windows, the last overshooting ``total``.
        The plan is prefix-stable, so windowing never changes the batches
        (the reference's rule)."""
        chunk = max(1, self.cfg.scan_steps)
        window = max(chunk * 8,
                     (2_000_000 // self.cfg.batch_size) // chunk * chunk)
        multi_window = total - start > window
        plan = (self.batch_plan if self.x_all is not None
                else self.batch_plan_host)

        def slices():
            plan_buf, plan_base = None, 0
            pos = start
            while pos < total:
                s = min(chunk, total - pos)
                if (plan_buf is None
                        or pos + s > plan_base + plan_buf.shape[0]):
                    w = window if multi_window else total - pos
                    plan_buf = plan(w, start_step=pos)
                    plan_base = pos
                off = pos - plan_base
                yield s, plan_buf[off:off + s]
                pos += s

        if self.x_all is not None:
            yield from slices()
            return
        ahead = None
        for s, idx in slices():
            staged = (s, self.stage_batches(idx))
            if ahead is not None:
                yield ahead
            ahead = staged
        if ahead is not None:
            yield ahead

    # -- loops ----------------------------------------------------------
    def run_chunk(self, state: TrainState, payload
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """``len(payload)`` train steps from ``state`` (left unchanged).
        ``payload`` is what ``iter_chunk_plans`` yields: ``[S, b_local]``
        rows of this rank's plan (device placement) or ``Staged`` batches
        (``host_stream``). Nothing is read back from the device until the
        chunk's end; the metrics come back as float32 CPU tensors
        (``_chunk_metrics``), averaged over the ranks."""
        self.bind(state)
        opt_state = state.opt_state.clone()
        if isinstance(payload, Staged):
            batches = payload.batches
            if payload.ready is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(payload.ready)
                batches.record_stream(compute)
            n_steps = batches.shape[0]
            batch_at = batches.__getitem__
        else:
            shape = (self.b_local, *self.cfg.image_shape)
            n_steps = payload.shape[0]
            batch_at = lambda i: self.x_all[payload[i]].reshape(shape)  # noqa: E731
        dev_rows, host_rows = [], []
        step = int(state.step)
        for i in range(n_steps):
            with span('gmvae.step'):
                with span('gmvae.data_gather'):
                    batch = batch_at(i)
                opt_state, m_dev, m_host = self.train_step(
                    opt_state, batch, self.base_key, step + i)
            dev_rows.append(m_dev)
            host_rows.append(m_host)
        params = {k: v.detach().clone()
                  for k, v in self.model.state_dict().items()}
        new_state = TrainState(params, opt_state, step + n_steps)
        return new_state, _chunk_metrics(self.cfg, dev_rows, host_rows)

    def evaluate(self, state: TrainState, max_examples: Optional[int] = None,
                 dataset: Optional[data_lib.Dataset] = None
                 ) -> Dict[str, float]:
        """Eval of ``state`` over the test set of ``dataset`` (default: the
        trainer's own), cut to its first ``max_examples`` when given; the
        whole set on every rank (``evaluate``)."""
        ds = dataset or self.dataset
        xs, ys = ds.test_x, ds.test_y
        if max_examples:
            xs, ys = xs[:max_examples], ys[:max_examples]
        self.bind(state)
        return evaluate(self.eval_step, self.cfg, xs, ys, int(state.step),
                        self.device)


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def fit(cfg: Config, dataset: Optional[data_lib.Dataset] = None,
        resume: bool = False, logger: Optional[RunLogger] = None,
        save_grids: bool = False, device='cuda'):
    """Train a config end to end: chunks of ``scan_steps`` steps over the
    windowed batch plan, eval every ``eval_every`` steps and at the end,
    a checkpoint every ``ckpt_every`` steps and at the end (0 disables
    either). Returns (trainer, state, history).

    In a process group every rank trains and evaluates and returns the
    same state and history; only rank 0 logs, draws grids and writes
    checkpoints, and the ranks wait for each write. On ``resume`` rank 0
    picks the snapshot and every rank restores it."""
    trainer = Trainer(cfg, dataset, device=device)
    run_dir = os.path.join(cfg.run_dir, cfg.name)
    rank0 = trainer.rank == 0
    logger = logger or RunLogger(run_dir)
    state = trainer.init_state()

    if resume:
        path = ckpt_lib.latest_ckpt(run_dir) if rank0 else None
        step0 = torch.tensor([ckpt_lib.parse_step(path) if path else -1])
        step0 = int(mesh.broadcast_(step0))
        if step0 >= 0:
            path = ckpt_lib.ckpt_path(run_dir, step0)
            state = trainer.tree_to_state(ckpt_lib.restore_ckpt(path))
            logger.log({'event': 'resume', 'from': path,
                        'step': int(state.step)})

    start, total = int(state.step), cfg.steps
    history = []
    t_last = time.perf_counter()
    imgs_since = 0
    step_now = start
    first_timing = True   # the first window includes the kernels' build
    for s, payload in trainer.iter_chunk_plans(start, total):
        state, _ = trainer.run_chunk(state, payload)
        imgs_since += s * cfg.batch_size
        step_now += s

        if cfg.eval_every and (step_now % cfg.eval_every < s
                               or step_now >= total):
            _sync(trainer.device)
            dt = time.perf_counter() - t_last
            # batch_size is global: the group's rate over its size
            rate = imgs_since / max(dt, 1e-9)
            row = {'step': step_now,
                   'img_per_sec_per_chip': rate / trainer.n_dp,
                   'img_per_sec_global': rate}
            if first_timing:
                row['includes_compile'] = True   # don't quote this one
                first_timing = False
            row.update(trainer.evaluate(state))
            logger.log(row)
            history.append(row)
            if save_grids and rank0:
                _save_grids(trainer, state, run_dir, step_now)
            t_last = time.perf_counter()
            imgs_since = 0

        if cfg.ckpt_every and (step_now % cfg.ckpt_every < s
                               or step_now >= total):
            if rank0:
                ckpt_lib.save_ckpt(ckpt_lib.ckpt_path(run_dir, step_now),
                                   trainer.state_to_tree(state))
                ckpt_lib.prune_ckpts(run_dir, keep=cfg.ckpt_keep)
            mesh.barrier()

    return trainer, state, history


@torch.no_grad()
def _save_grids(trainer: Trainer, state: TrainState, run_dir: str,
                step: int) -> None:
    """Sample and reconstruction PNG grids of ``state``. The samples come
    from a ``torch.Generator`` seeded with ``step``."""
    model = trainer.bind(state)
    gen = torch.Generator(device=trainer.device).manual_seed(step)
    samples = model.sample(64, gen).cpu().numpy()
    save_image_grid(os.path.join(run_dir, f'samples_{step}.png'), samples)
    x = data_lib.normalize_image(torch.from_numpy(
        np.ascontiguousarray(trainer.dataset.test_x[:64])).to(trainer.device))
    recon = model.reconstruct(x).cpu().numpy()
    both = np.stack([x.cpu().numpy(), recon], 1).reshape(-1, *recon.shape[1:])
    save_image_grid(os.path.join(run_dir, f'recon_{step}.png'), both, ncol=16)
