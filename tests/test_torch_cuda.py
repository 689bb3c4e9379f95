"""The CUDA kernels on the card, against their plain versions.

Needs an NVIDIA GPU with nvcc (sm_90a); skips without one. On the card:

    python -m pytest tests/test_torch_cuda.py -q

Tolerance: z and y within 1e-5 absolute, the per-row scalars within 1e-4
of max(|plain|, 1) (float32, different summation order and math library);
threefry words and eval ACC/NMI exact. Backward: each per-row gradient
entry within 1e-5 absolute or 1e-4 of max(|plain|, 1), and at K*D >= 2560
within 1e-4 of its batch row's max(|plain|, 1) (there an entry is a
difference of sums over thousands of terms, so its float32 error scales
with the row's largest term); the prior gradients (batch sums) within
1e-4 of their tensor's max(|plain|, 1); two runs bit-identical. The head
inputs have the scale of an encoder's outputs (logvars in [-3, 1], so std
<= e^0.5): with logvars near the +-12 clamp, std reaches e^6 and z's
absolute error scales with it.

The wide head (``wide_head``): z, y and the scalars as above, k_logits
within 1e-5 of max(|plain|, 1); its gradients against autograd of its
plain version within 1e-5 plus 1e-4 (4e-4 at K*D >= 2560) of each
tensor's largest entry; reruns bit-identical.

One test runs on the CPU: a float64 finite-difference check of the plain
backward ``manual_bwd``.
"""

import numpy as np
import pytest
import torch

from gmvae_tpu_torch import configs, prng, training
from gmvae_tpu_torch.data import make_synthetic, preprocess_batch
from gmvae_tpu_torch.elbo import MixturePrior, head_from_noise
from gmvae_tpu_torch.ops.kernels import (_build, fused_elbo, fused_elbo_bwd,
                                         threefry, wide_head)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _inputs(b, k, d, dev, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    prior = MixturePrior(t(rng.normal(size=k)), t(rng.normal(size=(k, d))),
                         t(rng.uniform(-1, 1, size=(k, d))))
    noise = (t(-np.log(-np.log(rng.uniform(1e-6, 1, size=(b, k))))),
             t(rng.normal(size=(b, d))))
    return (t(2 * rng.normal(size=(b, k))), t(rng.normal(size=(b, k, d))),
            t(rng.uniform(-3, 1, size=(b, k, d))), prior, noise)


@pytest.mark.parametrize('streamed', [False, True])
@pytest.mark.parametrize('hard', [False, True])
@pytest.mark.parametrize('shape', [(128, 10, 10), (37, 5, 11),
                                   (128, 20, 128), (64, 64, 256),
                                   (16, 3, 40), (5, 1, 1), (9, 40, 3)])
def test_head_kernel_matches_plain(dev, shape, hard, streamed):
    kl, qm, qlv, prior, noise = _inputs(*shape, dev)
    noise = noise if streamed else None
    n0 = _build.LAUNCHES['fused_elbo_fwd']
    with torch.no_grad():
        got = fused_elbo.fused_mixture_elbo((7, 9), kl, qm, qlv, prior, 0.8,
                                            hard, noise)
        ref = fused_elbo.fused_mixture_elbo_plain((7, 9), kl, qm, qlv,
                                                  prior, 0.8, hard, noise)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['fused_elbo_fwd'] == n0 + 1
    for name, a, b in zip(ref._fields, got, ref):
        if name in ('z', 'y'):
            assert float((a - b).abs().max()) <= 1e-5, name
        else:
            err = (a - b).abs() / b.abs().clamp_min(1.0)
            assert float(err.max()) <= 1e-4, name


def test_head_kernel_is_deterministic(dev):
    kl, qm, qlv, prior, _ = _inputs(128, 10, 10, dev)
    with torch.no_grad():
        a = fused_elbo.fused_mixture_elbo((1, 2), kl, qm, qlv, prior, 1.0)
        b = fused_elbo.fused_mixture_elbo((1, 2), kl, qm, qlv, prior, 1.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_head_kernel_rejects_what_it_cannot_take(dev):
    kl, qm, qlv, prior, _ = _inputs(16, 4, 6, dev)
    call = lambda *a: fused_elbo.fused_mixture_elbo(  # noqa: E731
        (1, 2), *a, prior, 1.0)
    with torch.no_grad():
        with pytest.raises(ValueError, match='contiguous float32'):
            call(kl.double(), qm, qlv)
        with pytest.raises(ValueError, match='contiguous float32'):
            call(kl, qm.transpose(1, 2).contiguous().transpose(1, 2), qlv)
        with pytest.raises(ValueError, match='shape'):
            call(kl, qm[:, :3].contiguous(), qlv)
    with pytest.raises(ValueError, match='shape'):
        fused_elbo_bwd.fused_elbo_bwd((1, 2), kl, qm, qlv, *prior, 1.0,
                                      False, kl.new_zeros(16, 7),
                                      kl.new_zeros(16, 6), kl)


def test_threefry_grid_matches_host_replay(dev):
    c0 = torch.randint(0, 1 << 32, (4097,), dtype=torch.int64)
    c1 = torch.randint(0, 1 << 32, (4097,), dtype=torch.int64)
    got = threefry.threefry2x32_grid(0xDEADBEEF, 5, c0.to(dev), c1.to(dev))
    ref = threefry.threefry2x32(0xDEADBEEF, 5, c0, c1)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize('eval_samples', [1, 2])
def test_eval_kernel_matches_plain_head(dev, eval_samples):
    cfg = configs.synthetic_tiny(eval_samples=eval_samples, fused=True)
    ds = make_synthetic(n_train=64, n_test=300, seed=5)
    trainer = training.Trainer(cfg, dataset=ds, device=dev)
    state = trainer.init_state()
    n0 = _build.LAUNCHES['fused_elbo_fwd']
    got = trainer.evaluate(state)
    assert _build.LAUNCHES['fused_elbo_fwd'] == n0 + 5 * eval_samples
    trainer.model.head_fn = fused_elbo.fused_mixture_elbo_plain
    ref = trainer.evaluate(state)
    np.testing.assert_allclose(got['elbo_nats'], ref['elbo_nats'],
                               rtol=1e-5)
    np.testing.assert_allclose(got['iwae_nats'], ref['iwae_nats'],
                               rtol=1e-5)
    assert got['acc'] == ref['acc'] and got['nmi'] == ref['nmi']


def _cotangents(b, k, d, dev, seed=1):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    cs = rng.normal(size=(b, 8))
    cs[:, 5:] = 0.0
    return t(cs), t(rng.normal(size=(b, d))), t(rng.normal(size=(b, k)))


def _assert_grads_close(got, ref, per_row=False):
    for name, a, b in zip(ref._fields, got, ref):
        if name in ('d_pi', 'd_p_means', 'd_p_logvars'):
            # batch sums: an element can cancel to near 0 from terms of
            # size ~|plain|_max, so the error is relative to the tensor's
            err = float((a - b).abs().max() / b.abs().max().clamp_min(1.0))
            assert err <= 1e-4, (name, err)
        else:
            scale = b.abs()
            if per_row:
                # at large K*D each entry is a difference of sums over
                # thousands of terms: its float32 error scales with the
                # row's largest terms
                scale = scale.reshape(b.shape[0], -1).amax(-1).reshape(
                    -1, *[1] * (b.dim() - 1))
            tol = torch.clamp_min(1e-4 * scale.clamp_min(1.0), 1e-5)
            assert bool(((a - b).abs() <= tol).all()), (
                name, float((a - b).abs().max()))


@pytest.mark.parametrize('streamed', [False, True])
@pytest.mark.parametrize('hard', [False, True])
@pytest.mark.parametrize('shape', [(128, 10, 10), (37, 5, 11),
                                   (64, 64, 256), (16, 3, 40), (5, 1, 1),
                                   (9, 40, 3)])
def test_bwd_kernel_matches_manual_bwd(dev, shape, hard, streamed):
    b, k, d = shape
    kl, qm, qlv, prior, noise = _inputs(b, k, d, dev)
    cs, cz, cy = _cotangents(b, k, d, dev)
    key = (7, 9)
    g, eps = noise if streamed else threefry.replay_noise(key, b, k, d, dev)
    n0 = _build.LAUNCHES['fused_elbo_bwd']
    args = (key, kl, qm, qlv, *prior, 0.8, hard, cs, cz, cy,
            noise if streamed else None)
    got = fused_elbo_bwd.fused_elbo_bwd(*args)
    again = fused_elbo_bwd.fused_elbo_bwd(*args)
    ref = fused_elbo_bwd.manual_bwd(g, eps, kl, qm, qlv, *prior, 0.8, cs,
                                    cz, cy, hard=hard)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['fused_elbo_bwd'] == n0 + 2
    _assert_grads_close(got, ref, per_row=k * d >= 2560)
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)   # no atomics: bit-identical runs


def _bwd_args(b, k, d, dev, streamed, hard=False, key=(7, 9)):
    kl, qm, qlv, prior, noise = _inputs(b, k, d, dev)
    cs, cz, cy = _cotangents(b, k, d, dev)
    g, eps = noise if streamed else threefry.replay_noise(key, b, k, d, dev)
    args = (key, kl, qm, qlv, *prior, 0.8, hard, cs, cz, cy,
            noise if streamed else None)
    ref = fused_elbo_bwd.manual_bwd(g, eps, kl, qm, qlv, *prior, 0.8, cs, cz,
                                    cy, hard=hard)
    return args, ref


@pytest.mark.parametrize('streamed', [False, True])
@pytest.mark.parametrize('shape', [(1, 10, 10), (13, 10, 10), (1, 20, 128),
                                   (17, 20, 128)])
def test_bwd_kernel_at_ragged_batches(dev, shape, streamed):
    """Batches that are not a multiple of the cluster size (padding blocks)
    and B=1 (a cluster of one)."""
    b, k, d = shape
    args, ref = _bwd_args(b, k, d, dev, streamed)
    got = fused_elbo_bwd.fused_elbo_bwd(*args)
    torch.cuda.synchronize()
    _assert_grads_close(got, ref, per_row=k * d >= 2560)


def test_bwd_kernel_is_one_launch(dev):
    """10 backward calls launch 10 kernels, all the backward kernel."""
    from gmvae_tpu_torch.utils.profiling import profile_device
    args, _ = _bwd_args(128, 10, 10, dev, False)
    fused_elbo_bwd.fused_elbo_bwd(*args)      # warm: the ticket, the build
    _, _, _, by_name = profile_device(
        lambda: [fused_elbo_bwd.fused_elbo_bwd(*args) for _ in range(10)])
    kernels = {name: n for name, (n, _) in by_name.items()
               if not name.startswith(('Memcpy', 'Memset'))}
    assert len(kernels) == 1, by_name
    (name, n), = kernels.items()
    assert 'fused_elbo_bwd_kernel' in name and n == 10, by_name


@pytest.mark.parametrize('shape', [(128, 10, 10), (37, 5, 11),
                                   (128, 20, 128)])
def test_bwd_kernel_reruns_bit_identical(dev, shape):
    """50 calls in a row equal the first bit for bit: the cluster tickets
    are back at 0 after every call."""
    args, _ = _bwd_args(*shape, dev, False)
    first = fused_elbo_bwd.fused_elbo_bwd(*args)
    for _ in range(50):
        again = fused_elbo_bwd.fused_elbo_bwd(*args)
        for a, b_ in zip(first, again):
            assert torch.equal(a, b_)
    assert not fused_elbo_bwd._ticket(dev).any()


@pytest.mark.parametrize('gumbel', [0.0, 0.37])
def test_hard_argmax_agrees_on_tied_logits(dev, gumbel):
    """Rows whose perturbed logits tie (streamed noise, the same in every
    column of a row): the forward's one-hot y sits at the first index among
    equals, and the backward takes the same y (it matches manual_bwd, whose
    argmax is the first index)."""
    b, k, d = 16, 10, 10
    kl, qm, qlv, prior, _ = _inputs(b, k, d, dev)
    kl = torch.zeros_like(kl)
    kl[:, 3] = kl[:, 6] = kl[:, 8] = 2.0           # three tied maxima
    kl[::2, 1] = 2.0                               # and a fourth, earlier
    eps = torch.randn(b, d, device=dev, generator=torch.Generator(
        dev).manual_seed(0))
    noise = (torch.full_like(kl, gumbel), eps)
    with torch.no_grad():
        y = fused_elbo.fused_mixture_elbo((7, 9), kl, qm, qlv, prior, 0.8,
                                          True, noise).y
    first = torch.where(torch.arange(b, device=dev) % 2 == 0, 1, 3)
    assert torch.equal(y.argmax(-1), first)
    assert torch.equal(y.sum(-1), torch.ones(b, device=dev))
    cs, cz, cy = _cotangents(b, k, d, dev)
    got = fused_elbo_bwd.fused_elbo_bwd((7, 9), kl, qm, qlv, *prior, 0.8,
                                        True, cs, cz, cy, noise)
    ref = fused_elbo_bwd.manual_bwd(*noise, kl, qm, qlv, *prior, 0.8, cs, cz,
                                    cy, hard=True)
    _assert_grads_close(got, ref)


@pytest.mark.parametrize('hard', [False, True])
def test_head_function_grads_match_autograd_of_plain(dev, hard):
    b, k, d = 37, 5, 11
    kl, qm, qlv, prior, _ = _inputs(b, k, d, dev)
    cs, cz, cy = _cotangents(b, k, d, dev)
    grads = []
    for fn in (fused_elbo.fused_mixture_elbo,
               fused_elbo.fused_mixture_elbo_plain):
        ins = [t.clone().requires_grad_() for t in (kl, qm, qlv, *prior)]
        out = fn((3, 4), *ins[:3], MixturePrior(*ins[3:]), 0.8, hard)
        scal = torch.stack(list(out[2:]), -1)
        loss = ((out.z * cz).sum() + (out.y * cy).sum()
                + (scal * cs[:, :5]).sum() + out.kl_cat.mean())
        grads.append(fused_elbo_bwd.BwdGrads(*torch.autograd.grad(loss, ins)))
    _assert_grads_close(*grads)


def test_manual_bwd_matches_finite_differences():
    """The plain backward against torch.autograd.gradcheck's numerical
    Jacobian in float64 (CPU): the VJP with random cotangents equals the
    finite-difference directional derivatives."""
    torch.manual_seed(0)
    b, k, d = 4, 3, 2
    f64 = dict(dtype=torch.float64)
    g = -torch.log(-torch.log(torch.rand(b, k, **f64)))
    eps = torch.randn(b, d, **f64)
    ins = (torch.randn(b, k, **f64), torch.randn(b, k, d, **f64),
           torch.rand(b, k, d, **f64) * 2 - 1, torch.randn(k, **f64),
           torch.randn(k, d, **f64), torch.rand(k, d, **f64) * 2 - 1)
    cs = torch.randn(b, 8, **f64)
    cs[:, 5:] = 0.0
    cz, cy = torch.randn(b, d, **f64), torch.randn(b, k, **f64)

    def scalar(*xs):
        out = head_from_noise(g, eps, *xs[:3], MixturePrior(*xs[3:]), 0.7)
        scal = torch.stack(list(out[2:]), -1)
        return ((out.z * cz).sum() + (out.y * cy).sum()
                + (scal * cs[:, :5]).sum())

    got = fused_elbo_bwd.manual_bwd(g, eps, *ins, 0.7, cs, cz, cy)
    h = 1e-6
    for i, x in enumerate(ins):
        num = torch.zeros_like(x).reshape(-1)
        for j in range(x.numel()):
            step = torch.zeros_like(x).reshape(-1)
            step[j] = h
            step = step.reshape(x.shape)
            xs_p = [y + step if n == i else y for n, y in enumerate(ins)]
            xs_m = [y - step if n == i else y for n, y in enumerate(ins)]
            num[j] = (scalar(*xs_p) - scalar(*xs_m)) / (2 * h)
        torch.testing.assert_close(got[i], num.reshape(x.shape), rtol=1e-6,
                                   atol=1e-6)


def test_train_steps_through_kernels_match_plain_head(dev):
    """mnist_k10 training steps through both kernels against the same steps
    with the plain head (autograd of the plain forward) on the card, in
    float32 so that only the head differs: the first step's gradients
    within 1e-4 of each leaf's largest, the ELBO of 4 steps within 1e-4,
    and the parameters within Adam's reach (an update is ~lr whatever the
    gradient's size, so a near-zero gradient that differs in sign moves a
    parameter by up to 2 lr a step)."""
    cfg = configs.mnist_k10(scan_steps=4, metrics_mode='stacked',
                            compute_dtype='float32',
                            opt_state_dtype='float32')
    ds = make_synthetic(image_shape=(28, 28, 1), n_clusters=10, n_train=512,
                        n_test=128, seed=3)
    trainer = training.Trainer(cfg, dataset=ds, device=dev)
    state = trainer.init_state()
    idx = trainer.batch_plan(4)
    loss_fn = training.make_loss_fn(trainer.model, cfg)
    k_pre, k_elbo = prng.split(prng.fold_in(prng.fold_in(trainer.base_key, 0),
                                            0))
    x = preprocess_batch(k_pre, trainer.x_all[idx[0]].reshape(128, 28, 28, 1),
                         True)

    def grads():
        model = trainer.bind(state)
        loss, _ = loss_fn(x, k_elbo, 0)
        return torch.autograd.grad(loss, list(model.parameters()))

    n_fwd = _build.LAUNCHES['fused_elbo_fwd']
    n_bwd = _build.LAUNCHES['fused_elbo_bwd']
    g_got = grads()
    got, m_got = trainer.run_chunk(state, idx)
    assert _build.LAUNCHES['fused_elbo_fwd'] == n_fwd + 5
    assert _build.LAUNCHES['fused_elbo_bwd'] == n_bwd + 5
    trainer.model.head_fn = fused_elbo.fused_mixture_elbo_plain
    g_ref = grads()
    ref, m_ref = trainer.run_chunk(state, idx)
    assert _build.LAUNCHES['fused_elbo_fwd'] == n_fwd + 5
    for a, b in zip(g_got, g_ref):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    np.testing.assert_allclose(m_got['elbo'].numpy(), m_ref['elbo'].numpy(),
                               rtol=1e-4)
    diffs = torch.cat([(got.params[k] - ref.params[k]).abs().reshape(-1)
                       for k in ref.params])
    assert float(diffs.max()) <= 2 * cfg.lr * 4
    assert float(diffs.mean()) <= 1e-6


# ---------------------------------------------------------------------------
# the wide-boundary head (csrc/wide_head_fwd.cu) and the conv stacks
# ---------------------------------------------------------------------------

# cifar_head at B=1, 17, 129: a lone row, and ragged last row tiles of 16
WIDE_SHAPES = [(512, 10, 10, 128), (512, 20, 128, 128), (512, 10, 10, 37),
               (64, 3, 40, 9), (30, 4, 6, 5),   # H=30: the h % 4 tail
               (512, 20, 128, 1), (512, 20, 128, 17), (512, 20, 128, 129)]


def _wide_inputs(h, k, d, b, dev, seed=0):
    rng = np.random.default_rng(seed)
    n = k * d
    t = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (scale * rng.normal(size=s)).astype(np.float32)).to(dev)
    return [t(b, h), t(h, k, scale=0.05), t(k, scale=0.1),
            t(h, n, scale=0.05), t(n, scale=0.1), t(h, n, scale=0.02),
            t(n, scale=0.1), t(k), t(n), t(n, scale=0.5)]


@pytest.mark.parametrize('shape', WIDE_SHAPES)
def test_wide_kernel_matches_plain(dev, shape):
    """z/y and the scalars as the head kernel's; k_logits, a float32 sum
    over H in another order than cuBLAS's, within 1e-5 of max(|plain|, 1)."""
    h, k, d, b = shape
    ins = _wide_inputs(h, k, d, b, dev)
    n0 = _build.LAUNCHES['wide_head_fwd']
    with torch.no_grad():
        got = wide_head.wide_head((7, 9), 0.8, *ins, k, d)
        again = wide_head.wide_head((7, 9), 0.8, *ins, k, d)
        ref = wide_head.wide_head_plain((7, 9), 0.8, *ins, k, d)
    torch.cuda.synchronize()
    assert _build.LAUNCHES['wide_head_fwd'] == n0 + 2
    for name, a, b_, a2 in zip(('z', 'y', 'scal', 'k_logits'), got, ref,
                               again):
        assert torch.equal(a, a2), name
        err = (a - b_).abs()
        if name in ('z', 'y'):
            assert float(err.max()) <= 1e-5, name
        else:
            rtol = 1e-4 if name == 'scal' else 1e-5
            assert float((err / b_.abs().clamp_min(1.0)).max()) <= rtol, name


def test_wide_kernel_reruns_bit_identical(dev):
    """50 launches at cifar_head give the same bits: each projection is a
    sum over H in a fixed order inside one block, no atomics."""
    h, k, d, b = 512, 20, 128, 128
    ins = _wide_inputs(h, k, d, b, dev, seed=3)
    with torch.no_grad():
        first = wide_head.wide_head((5, 6), 0.8, *ins, k, d)
        for _ in range(49):
            again = wide_head.wide_head((5, 6), 0.8, *ins, k, d)
            for name, a, a2 in zip(('z', 'y', 'scal', 'k_logits'), first,
                                   again):
                assert torch.equal(a, a2), name


@pytest.mark.parametrize('shape', [(512, 10, 10, 128), (512, 20, 128, 128),
                                   (64, 3, 40, 9)])
def test_wide_function_grads_match_autograd_of_plain(dev, shape):
    """Each gradient within 1e-5 plus 1e-4 (4e-4 at K*D >= 2560, autograd's
    tolerance in chip_smoke.py) of its tensor's largest |autograd| entry;
    the backward kernel launched once a call, bit-identical reruns."""
    h, k, d, b = shape
    ins = _wide_inputs(h, k, d, b, dev, seed=1)
    rng = np.random.default_rng(2)
    cts = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
           for s in ((b, d), (b, k), (b, 8), (b, k))]
    cts[2][:, 5:] = 0.0

    def grads(fn):
        xs = [t.clone().requires_grad_() for t in ins]
        out = fn((3, 4), 0.8, *xs, k, d)
        loss = sum((o * c).sum() for o, c in zip(out, cts))
        return torch.autograd.grad(loss, xs)

    n0 = _build.LAUNCHES['fused_elbo_bwd']
    got, again = grads(wide_head.wide_head), grads(wide_head.wide_head)
    assert _build.LAUNCHES['fused_elbo_bwd'] == n0 + 2
    ref = grads(wide_head.wide_head_plain)
    rel = 4e-4 if k * d >= 2560 else 1e-4
    for i, (a, a2, b_) in enumerate(zip(got, again, ref)):
        assert torch.equal(a, a2), i
        tol = 1e-5 + rel * float(b_.abs().max())
        assert float((a - b_).abs().max()) <= tol, i


def test_wide_kernel_rejects_what_it_cannot_take(dev):
    ins = _wide_inputs(32, 4, 6, 8, dev)
    with torch.no_grad():
        with pytest.raises(ValueError, match='shape'):
            wide_head.wide_head((1, 2), 1.0, *ins, 4, 5)
        bad = list(ins)
        bad[1] = ins[1].t().contiguous().t()
        with pytest.raises(ValueError, match='contiguous float32'):
            wide_head.wide_head((1, 2), 1.0, *bad, 4, 6)
        # celeba's head: its projections do not fit a block's shared memory
        with pytest.raises(ValueError, match='shared memory'):
            wide_head.wide_head((1, 2), 1.0,
                                *_wide_inputs(512, 64, 256, 4, dev), 64, 256)


@pytest.mark.parametrize('name', ['cifar_k20', 'svhn_conv'])
def test_conv_stacks_on_card_match_cpu(dev, name, monkeypatch):
    """The conv/ResNet GMVAE in float32 on the card (cuDNN with TF32 off,
    channels-last) against the CPU from the same parameters: the ELBO
    through the head kernel within 1e-4 relative, encoder outputs within
    1e-4 absolute."""
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    cfg = configs.get_config(name, compute_dtype='float32')
    model = training.make_model(cfg, 'cpu')
    gpu = training.make_model(cfg, dev)
    gpu.load_state_dict(model.state_dict())
    x = torch.rand(16, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for a, b in zip(gpu.encode(x.to(dev)), model.encode(x)):
            assert float((a.cpu() - b).abs().max()) <= 1e-4
        e_gpu, _ = gpu.elbo_terms(x.to(dev), (5, 6), 1.0)
        e_cpu, _ = model.elbo_terms(x, (5, 6), 1.0)
    np.testing.assert_allclose(e_gpu.cpu().numpy(), e_cpu.numpy(), rtol=1e-4)
