"""The GMVAE in plain PyTorch, float32: the benchmark's reference.

It reads the model's sizes from the benchmark's configuration file and its
parameters from a dict in the port's ``state_dict`` layout (names and
shapes below, ``layout``), which the benchmark fills from the seed
(``make_params``). Nothing here imports the port.

The math, written from the model's description:

* nets: MLP (dense + relu), conv (4x4 stride-2 convs with relu, a dense
  of 512; the decoder mirrors it with transposed convs) and ResNet (3x3
  stride-2 convs, each followed by a pre-activation residual block;
  the decoder a block, then a 4x4 stride-2 transposed conv a stage, then
  a 3x3 conv). Images are NHWC; convs pad SAME as XLA does (``total =
  max((ceil(n/s) - 1) s + k - n, 0)``, the smaller half low); a transposed
  conv is XLA's correlation of the stride-dilated input, whose weight the
  layout stores flipped, ``[in, out, k, k]``, as ``conv_transpose2d``
  takes it. Flattening is in (h, w, c) order.
* posterior: ``k_logits [B,K]``, ``q_means``/``q_logvars [B,K,D]`` from
  three dense heads on the encoder's features.
* head: ``y = softmax((k_logits + g) / tau)``; ``z = sum_k y q_means +
  exp(sum_k y clamp(q_logvars) / 2) eps``; the structured ELBO ``log p(x|z)
  - [log q(z|x,y) - log p(z|y) + KL(q(k|x) || Cat(pi))]`` with the
  y-interpolated Gaussians; log-variances clamped to [-12, 12].
* likelihood: Bernoulli logits, or a Gaussian whose decoder emits mean and
  log-variance channels (the log-variance floored at ``dec_logvar_min``).
* loss: ``-mean(log p(x|z) - beta KL)`` plus ``balance_weight`` times
  KL(batch-mean q(k|x) || uniform) and ``conf_weight`` times the mean
  entropy of q(k|x).

``cast`` is applied to every input and weight of a conv or dense layer:
the identity for the reference, a rounding to a lower precision for the
control (``tools/readings.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

LOGVAR_MIN, LOGVAR_MAX = -12.0, 12.0
LOG2PI = math.log(2.0 * math.pi)
DENSE = 512   # the conv and ResNet encoders' feature width

Params = Dict[str, torch.Tensor]
Cast = Callable[[torch.Tensor], torch.Tensor]


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _halve(n: int, stages: int) -> int:
    for _ in range(stages):
        n = -(-n // 2)
    return n


# ---------------------------------------------------------------------------
# layout: every parameter's name, shape and kind
# ---------------------------------------------------------------------------


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``(name, shape, kind)`` of every parameter, kind one of 'dense',
    'conv', 'convT' (weights), 'bias', 'zero', 'prior_mean'."""
    h, w, c = cfg['image_shape']
    k, d = cfg['n_components'], cfg['latent_dim']
    mult = 2 if cfg['likelihood'] == 'gaussian' else 1
    out: List[Tuple[str, Tuple[int, ...], str]] = [
        ('pi_logits', (k,), 'zero'), ('prior_means', (k, d), 'prior_mean'),
        ('prior_logvars', (k, d), 'zero')]

    def lin(name, n_in, n_out):
        out.append((f'{name}.weight', (n_out, n_in), 'dense'))
        out.append((f'{name}.bias', (n_out,), 'bias'))

    def conv(name, cin, cout, ks):
        out.append((f'{name}.weight', (cout, cin, ks, ks), 'conv'))
        out.append((f'{name}.bias', (cout,), 'bias'))

    def convt(name, cin, cout, ks):
        out.append((f'{name}.weight', (cin, cout, ks, ks), 'convT'))
        out.append((f'{name}.bias', (cout,), 'bias'))

    enc, dec, arch = cfg['enc_hidden'], cfg['dec_hidden'], cfg['arch']
    if arch == 'mlp':
        widths = (h * w * c, *enc)
        for i in range(len(enc)):
            lin(f'encoder.layers.{i}', widths[i], widths[i + 1])
        feat = enc[-1]
        widths = (d, *dec, h * w * c * mult)
        for i in range(len(widths) - 1):
            lin(f'decoder.layers.{i}', widths[i], widths[i + 1])
    else:
        n = len(enc)
        cin = c
        for i, f in enumerate(enc):
            if arch == 'conv':
                conv(f'encoder.Conv_{i}', cin, f, 4)
            else:
                conv(f'encoder.Conv_{i}', cin, f, 3)
                conv(f'encoder.ResBlock_{i}.Conv_0', f, f, 3)
                conv(f'encoder.ResBlock_{i}.Conv_1', f, f, 3)
            cin = f
        lin('encoder.Dense_0', _halve(h, n) * _halve(w, n) * cin, DENSE)
        feat = DENSE
        n = len(dec)
        h0, w0 = h // 2 ** n, w // 2 ** n
        lin('decoder.Dense_0', d, h0 * w0 * dec[0])
        if arch == 'conv':
            outs = (*dec[1:], c * mult)
            for i, (a, b) in enumerate(zip(dec, outs)):
                convt(f'decoder.ConvTranspose_{i}', a, b, 4)
        else:
            cin = dec[0]
            for i, f in enumerate(dec):
                conv(f'decoder.ResBlock_{i}.Conv_0', cin, f, 3)
                conv(f'decoder.ResBlock_{i}.Conv_1', f, f, 3)
                if cin != f:
                    conv(f'decoder.ResBlock_{i}.Conv_2', cin, f, 1)
                convt(f'decoder.ConvTranspose_{i}', f, f, 4)
                cin = f
            conv('decoder.Conv_0', cin, c * mult, 3)
    lin('k_head', feat, k)
    lin('mean_head', feat, k * d)
    lin('logvar_head', feat, k * d)
    return out


def make_params(cfg: dict, seed: int, device) -> Params:
    """Parameters from ``seed`` in one draw on ``device``: weights normal
    with variance 1/fan-in (fan-in: inputs times the kernel's area) cut at
    two standard deviations, biases zero, prior means N(0,
    ``prior_init_std``), the prior's
    other leaves and the log-variance head's weight zero."""
    lay = layout(cfg)
    n = sum(math.prod(s) for _, s, _ in lay)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, kind in lay:
        t = flat[off:off + math.prod(shape)].view(shape)
        off += math.prod(shape)
        if kind in ('bias', 'zero') or name == 'logvar_head.weight':
            t = torch.zeros_like(t)
        elif kind == 'prior_mean':
            t = t * cfg['prior_init_std']
        else:
            fan = (shape[1] if kind in ('dense', 'conv') else shape[0])
            fan *= math.prod(shape[2:])
            t = torch.clamp(t, -2.0, 2.0) * (1.0 / math.sqrt(fan))
        out[name] = t.clone()
    return out


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------


def _dense(p: Params, name: str, h: torch.Tensor, cast: Cast):
    return cast(h) @ cast(p[f'{name}.weight']).t() + p[f'{name}.bias']


def _same(n: int, k: int, s: int) -> Tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(p: Params, name: str, h: torch.Tensor, stride: int, cast: Cast):
    w = p[f'{name}.weight']
    k = w.shape[-1]
    (t, b), (lo, hi) = (_same(n, k, stride) for n in h.shape[-2:])
    y = F.conv2d(F.pad(cast(h), (lo, hi, t, b)), cast(w), None, stride)
    return y + p[f'{name}.bias'][:, None, None]


def _convt(p: Params, name: str, h: torch.Tensor, cast: Cast):
    """4x4 stride-2 SAME transposed conv: the dilated input padded (2, 2)
    before a correlation with the stored (flipped) kernel, which is
    ``conv_transpose2d`` with padding 1."""
    w = p[f'{name}.weight']
    y = F.conv_transpose2d(cast(h), cast(w), None, 2, 1, 0)
    return y + p[f'{name}.bias'][:, None, None]


def _resblock(p: Params, name: str, x: torch.Tensor, cast: Cast):
    h = _conv(p, f'{name}.Conv_0', torch.relu(x), 1, cast)
    h = _conv(p, f'{name}.Conv_1', torch.relu(h), 1, cast)
    if f'{name}.Conv_2.weight' in p:
        x = _conv(p, f'{name}.Conv_2', x, 1, cast)
    return x + h


def _flat_nhwc(h: torch.Tensor) -> torch.Tensor:
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def features(cfg: dict, p: Params, x: torch.Tensor, cast: Cast = identity):
    """x ``[B,H,W,C]`` float32 -> the encoder's features ``[B,F]``."""
    arch = cfg['arch']
    if arch == 'mlp':
        h = x.reshape(x.shape[0], -1)
        for i in range(len(cfg['enc_hidden'])):
            h = torch.relu(_dense(p, f'encoder.layers.{i}', h, cast))
    else:
        h = x.permute(0, 3, 1, 2)
        for i in range(len(cfg['enc_hidden'])):
            if arch == 'conv':
                h = torch.relu(_conv(p, f'encoder.Conv_{i}', h, 2, cast))
            else:
                h = _conv(p, f'encoder.Conv_{i}', h, 2, cast)
                h = _resblock(p, f'encoder.ResBlock_{i}', h, cast)
        if arch == 'resnet':
            h = torch.relu(h)
        h = torch.relu(_dense(p, 'encoder.Dense_0', _flat_nhwc(h), cast))
    return h


def encode(cfg: dict, p: Params, x: torch.Tensor, cast: Cast = identity):
    """x ``[B,H,W,C]`` float32 -> (k_logits, q_means, q_logvars)."""
    k, d = cfg['n_components'], cfg['latent_dim']
    h = features(cfg, p, x, cast)
    return (_dense(p, 'k_head', h, cast),
            _dense(p, 'mean_head', h, cast).reshape(-1, k, d),
            _dense(p, 'logvar_head', h, cast).reshape(-1, k, d))


def decode(cfg: dict, p: Params, z: torch.Tensor, cast: Cast = identity):
    """z ``[B,D]`` -> the decoder's output ``[B,H,W,C*mult]``."""
    h_img, w_img, c = cfg['image_shape']
    arch = cfg['arch']
    if arch == 'mlp':
        n = len(cfg['dec_hidden'])
        h = z
        for i in range(n):
            h = torch.relu(_dense(p, f'decoder.layers.{i}', h, cast))
        h = _dense(p, f'decoder.layers.{n}', h, cast)
        return h.reshape(z.shape[0], h_img, w_img, -1)
    dec = cfg['dec_hidden']
    n = len(dec)
    h = _dense(p, 'decoder.Dense_0', z, cast)
    if arch == 'conv':
        h = torch.relu(h)
    h = h.reshape(z.shape[0], h_img // 2 ** n, w_img // 2 ** n, dec[0])
    h = h.permute(0, 3, 1, 2)
    for i in range(n):
        if arch == 'conv':
            h = _convt(p, f'decoder.ConvTranspose_{i}', h, cast)
            if i < n - 1:
                h = torch.relu(h)
        else:
            h = _resblock(p, f'decoder.ResBlock_{i}', h, cast)
            h = torch.relu(_convt(p, f'decoder.ConvTranspose_{i}', h, cast))
    if arch == 'resnet':
        h = _conv(p, 'decoder.Conv_0', h, 1, cast)
    return h.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# ELBO and loss
# ---------------------------------------------------------------------------


def _clamp(lv: torch.Tensor) -> torch.Tensor:
    return torch.clamp(lv, LOGVAR_MIN, LOGVAR_MAX)


def _gauss_logpdf(z, mean, logvar):
    logvar = _clamp(logvar)
    return -0.5 * torch.sum(torch.square(z - mean) * torch.exp(-logvar)
                            + logvar + LOG2PI, dim=-1)


def log_likelihood(cfg: dict, x: torch.Tensor, out: torch.Tensor):
    b = x.shape[0]
    if cfg['likelihood'] == 'gaussian':
        mean, logvar = torch.chunk(out, 2, dim=-1)
        logvar = _clamp(torch.clamp(logvar, cfg['dec_logvar_min'],
                                    LOGVAR_MAX))
        ll = -0.5 * (torch.square(x - mean) * torch.exp(-logvar) + logvar
                     + LOG2PI)
    else:
        ll = x * out - F.softplus(out)
    return ll.reshape(b, -1).sum(-1)


def elbo_terms(cfg: dict, p: Params, x: torch.Tensor, g: torch.Tensor,
               eps: torch.Tensor, tau: float, cast: Cast = identity):
    """(elbo [B], log p(x|z) [B], kl_cat [B], k_logits [B,K]) for a batch
    and its head noise (the structured ELBO, soft y)."""
    if cfg['elbo_form'] != 'structured' or cfg['hard_gumbel']:
        raise ValueError('the reference computes the structured ELBO with '
                         'soft y')
    k_logits, q_means, q_logvars = encode(cfg, p, x, cast)
    y = torch.softmax((k_logits + g) / tau, dim=-1)
    qlv = _clamp(q_logvars)
    mean = torch.einsum('bk,bkd->bd', y, q_means)
    logvar = torch.einsum('bk,bkd->bd', y, qlv)
    z = mean + torch.exp(0.5 * logvar) * eps
    log_pi = torch.log_softmax(p['pi_logits'], dim=-1)
    p_mean = y @ p['prior_means']
    p_logvar = y @ _clamp(p['prior_logvars'])
    log_p_cond = _gauss_logpdf(z, p_mean, p_logvar)
    log_q_cond = _gauss_logpdf(z, mean, logvar)
    log_q = torch.log_softmax(k_logits, dim=-1)
    kl_cat = torch.sum(torch.exp(log_q) * (log_q - log_pi), dim=-1)
    log_px_z = log_likelihood(cfg, x, decode(cfg, p, z, cast))
    elbo = log_px_z - (log_q_cond - log_p_cond + kl_cat)
    return elbo, log_px_z, kl_cat, k_logits


def loss(cfg: dict, p: Params, x: torch.Tensor, g: torch.Tensor,
         eps: torch.Tensor, tau: float, beta: float = 1.0,
         cast: Cast = identity) -> torch.Tensor:
    """The training loss of one batch (module docstring)."""
    elbo, log_px_z, _, k_logits = elbo_terms(cfg, p, x, g, eps, tau, cast)
    out = -torch.mean(log_px_z - beta * (log_px_z - elbo))
    if cfg['balance_weight'] > 0:
        qbar = torch.softmax(k_logits, dim=-1).mean(0)
        out = out + cfg['balance_weight'] * torch.sum(
            qbar * torch.log(qbar * qbar.shape[-1] + 1e-12))
    if cfg['conf_weight'] > 0:
        logq = torch.log_softmax(k_logits, dim=-1)
        out = out + cfg['conf_weight'] * torch.mean(
            -torch.sum(torch.exp(logq) * logq, dim=-1))
    return out
