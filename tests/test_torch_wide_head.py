"""The wide-boundary head: the port's plain ``WideHead`` against the
reference's ``wide_head`` (``tools/bench_head_boundary.py``, loaded by file
path, its Pallas kernels in interpret mode), on the CPU.

Same seeded numpy inputs and threefry key on both sides. Forward: z, y and
k_logits within 1e-5 absolute, the per-row scalars within 1e-4 of
max(|reference|, 1) (the head kernels' tolerances). Gradients of a loss
that touches every output, against ``jax.grad``: each within 1e-5 absolute
plus 1e-4 of its tensor's largest |reference| entry (the weight and feats
gradients are the matmuls' VJPs, sums over B or K*D products, whose float32
error scales with the tensor's largest entries, not with each entry).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmvae_tpu_torch.ops.kernels import wide_head as wh
from gmvae_tpu_torch.tools import bench_head_boundary as port_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ('feats', 'wk', 'bk', 'wm', 'bm', 'wlv', 'blv', 'pi', 'pm', 'plv')
KEY = (1394159668, 1590028285)
TAU = 0.7


@pytest.fixture(scope='module')
def ref_tool():
    spec = importlib.util.spec_from_file_location(
        'reference_bench_head_boundary',
        os.path.join(REPO, 'tools', 'bench_head_boundary.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _problem(h, k, d, b, seed):
    rng = np.random.default_rng(seed)
    n = k * d
    f = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(  # noqa: E731
        np.float32)
    ins = dict(feats=f(b, h), wk=f(h, k, scale=0.3), bk=f(k, scale=0.1),
               wm=f(h, n, scale=0.1), bm=f(n, scale=0.1),
               wlv=f(h, n, scale=0.05), blv=f(n, scale=0.1), pi=f(k),
               pm=f(n), plv=(0.5 * f(n)))
    cts = dict(cz=f(b, d), cy=f(b, k), cs=f(b, 5), ckl=f(b, k))
    return ins, cts


def _loss(z, y, scal, klo, cts, lib):
    return (lib.sum(z * cts['cz']) + lib.sum(y * cts['cy'])
            + lib.sum(scal[:, :5] * cts['cs']) + lib.sum(klo * cts['ckl']))


def _reference(tool, ins, cts, k, d):
    key_f = jax.lax.bitcast_convert_type(jnp.asarray(np.array(KEY, np.uint32)),
                                         jnp.float32)
    tau = jnp.float32(TAU)

    def fwd(*xs):
        return tool.wide_head(key_f, tau, *xs, k, d, True)

    xs = [jnp.asarray(ins[n]) for n in NAMES]
    out = fwd(*xs)
    jcts = {c: jnp.asarray(v) for c, v in cts.items()}
    grads = jax.grad(lambda *a: _loss(*fwd(*a), jcts, jnp),
                     argnums=tuple(range(len(xs))))(*xs)
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


# (H, K, D, B). The last three sit at the edges of the CUDA kernel's
# tiling, whose plain version this is on the CPU: B not a multiple of its
# 16-row tile, K + 2N not a multiple of the mma's n = 8 nor of the column
# stripes of a 16-block cluster, H not a multiple of the k-step of 8.
SHAPES = [(32, 4, 6, 8), (32, 3, 128, 8), (64, 10, 10, 37), (40, 3, 7, 19),
          (24, 5, 9, 17), (36, 2, 5, 3)]


@pytest.mark.parametrize('h,k,d,b', SHAPES)
def test_wide_head_matches_reference(ref_tool, h, k, d, b):
    ins, cts = _problem(h, k, d, b, seed=h + k + d + b)
    ref_out, ref_grads = _reference(ref_tool, ins, cts, k, d)
    xs = [torch.from_numpy(ins[n]).requires_grad_() for n in NAMES]
    out = wh.wide_head(KEY, TAU, *xs, k, d)
    z, y, scal, klo = out
    for name, got, want in (('z', z, ref_out[0]), ('y', y, ref_out[1]),
                            ('k_logits', klo, ref_out[3])):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5, err_msg=name)
    s_ref = ref_out[2][:, :5]
    err = np.abs(scal.detach().numpy()[:, :5] - s_ref)
    assert (err <= 1e-4 * np.maximum(np.abs(s_ref), 1.0)).all(), err.max()
    assert not scal[:, 5:].any()
    tcts = {c: torch.from_numpy(v) for c, v in cts.items()}
    grads = torch.autograd.grad(_loss(*out, tcts, torch), xs)
    for name, got, want in zip(NAMES, grads, ref_grads):
        assert got.shape == want.shape, name
        tol = 1e-5 + 1e-4 * np.abs(want).max()
        err = np.abs(got.numpy() - want).max()
        assert err <= tol, (name, err, tol)


def test_wide_head_matches_plain_narrow_head():
    """The narrow boundary (three matmuls + the head) and the wide one give
    the same head from the same weights and key: the port's ablation
    parity check, on the CPU."""
    for h, k, d, b in SHAPES:
        errs = port_tool.check_parity(h, k, d, b, device='cpu')
        assert set(errs) == {'z', 'y', 'lpc', 'klc', 'k_logits'}
        assert max(errs.values()) <= 1e-5, errs


def test_wide_head_grads_need_no_unused_outputs():
    """Outputs left out of the loss (None cotangents) count as zero."""
    ins, cts = _problem(32, 4, 6, 8, seed=0)
    xs = [torch.from_numpy(ins[n]).requires_grad_() for n in NAMES]
    z, y, scal, klo = wh.wide_head(KEY, TAU, *xs, 4, 6)
    only_z = torch.autograd.grad(z.sum(), xs)
    xs2 = [x.detach().clone().requires_grad_() for x in xs]
    z2, y2, s2, k2 = wh.wide_head(KEY, TAU, *xs2, 4, 6)
    full = torch.autograd.grad(z2.sum() + 0 * (y2.sum() + s2.sum()
                                               + k2.sum()), xs2)
    for a, b_ in zip(only_z, full):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_wide_head_rejects_what_the_kernel_cannot_take():
    ins, _ = _problem(32, 4, 6, 8, seed=1)
    xs = [torch.from_numpy(ins[n]) for n in NAMES]
    with pytest.raises(ValueError, match='2\\^16'):
        wh.wide_head(KEY, TAU, *xs, 1 << 16, 1)
    with pytest.raises(ValueError, match='unsupported device'):
        wh.wide_head(KEY, TAU, *[x.to('meta') for x in xs], 4, 6)
