"""The training step replayed as CUDA graphs (``training.StepGraphs``).

On the card (marker ``cuda``; skips without one): replayed steps are bit
for bit the eager steps (parameters, both moments and every per-step
metric) over chunks of 1, 2 and 50 steps from the same state, which a chunk
leaves unchanged; the launch counters count each replay's kernels; the
spans nest as in the eager step; the trainers that stay eager do. Run
there with

    python -m pytest tests/test_torch_graphs.py -q

On the CPU: the head takes its key and tau from tensors as the kernels now
do (bit-equal to host values); the chunk's scalar table holds what
``train_step`` works out; the graphs' three parts, run eagerly, read the
right columns of it; the in-place Adam half, the clip's leaf lengths and
``preprocess_batch(out=...)``; which trainers stay eager, and why.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gmvae_tpu_torch import configs, training
from gmvae_tpu_torch.data import loaders, preprocess
from gmvae_tpu_torch.elbo import MixturePrior
from gmvae_tpu_torch.ops.kernels import _build, fused_elbo, fused_elbo_bwd

# one intra-op thread a test process (why: tests/test_torch_hygiene.py)
torch.set_num_threads(1)

# small configs shaped like the two families the graphs serve: a conv net
# with the per-leaf clip and float32 moments at celeba_dp16's head (K=64,
# D=256; 256 rows, over the backward's one wave of blocks), and an MLP,
# binarized, with bfloat16 moments and the global clip, like mnist_k10
CONFIGS = {
    'conv_per_leaf': lambda **kw: configs.celeba_dp16(
        enc_hidden=(8, 16, 16, 32), dec_hidden=(32, 16, 16, 8),
        batch_size=256).replace(**kw),
    'mlp_global': lambda **kw: configs.mnist_k10(
        enc_hidden=(64, 64), dec_hidden=(64, 64), grad_clip=1.0,
        grad_clip_impl='global').replace(**kw),
    'mlp_kl_warmup': lambda **kw: configs.mnist_k10(
        enc_hidden=(64, 64), dec_hidden=(64, 64),
        kl_warmup_steps=20).replace(**kw),
}


def _data(cfg, n_train=1024):
    return loaders.make_synthetic(image_shape=cfg.image_shape, n_clusters=4,
                                  n_train=n_train, n_test=8, seed=5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


def _state_tensors(state):
    return ([state.params[k] for k in state.params]
            + [state.opt_state.mu, state.opt_state.nu])


def _bit_equal(a, b):
    """The same dtype, shape and bits (NaNs included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_replayed_steps_are_the_eager_steps_bit_for_bit(dev, name):
    cfg = CONFIGS[name](scan_steps=50, metrics_mode='stacked')
    ds = _data(cfg)
    graphed = training.Trainer(cfg, ds, device=dev)
    eager = training.Trainer(cfg, ds, device=dev)
    assert graphed.graphs is not None and graphed.eager_reason is None
    eager.graphs = None
    state0 = graphed.init_state()
    before = [t.clone() for t in _state_tensors(state0)]
    plan = graphed.batch_plan(53)
    replays = _build.REPLAYS['train_step']
    for lo, hi in ((0, 1), (1, 3), (3, 53)):
        launches = dict(_build.LAUNCHES)
        got, m_got = graphed.run_chunk(state0, plan[lo:hi])
        torch.cuda.synchronize()
        graphed_launches = {k: _build.LAUNCHES[k] - launches[k]
                            for k in launches}
        launches = dict(_build.LAUNCHES)
        want, m_want = eager.run_chunk(state0, plan[lo:hi])
        torch.cuda.synchronize()
        assert graphed_launches == {k: _build.LAUNCHES[k] - launches[k]
                                    for k in launches}
        assert got.step == want.step == hi - lo
        assert got.opt_state.count == want.opt_state.count == hi - lo
        for a, b in zip(_state_tensors(got), _state_tensors(want)):
            assert _bit_equal(a, b)
        for k in training.METRIC_KEYS:
            assert _bit_equal(m_got[k], m_want[k]), k
        for a, b in zip(_state_tensors(state0), before):
            assert _bit_equal(a, b)
    # every step replayed but the trainer's first, the capture's warm-up
    assert _build.REPLAYS['train_step'] == replays + 52


@pytest.mark.cuda
def test_replayed_chunks_go_on_from_each_other(dev):
    """Chunks that carry the state on (as ``fit`` runs them) equal the
    eager ones, metrics in 'mean' mode included."""
    cfg = CONFIGS['mlp_global'](scan_steps=4)
    ds = _data(cfg)
    runs = []
    for graphs in (True, False):
        trainer = training.Trainer(cfg, ds, device=dev)
        if not graphs:
            trainer.graphs = None
        state, means = trainer.init_state(), []
        for _, payload in trainer.iter_chunk_plans(0, 12):
            state, m = trainer.run_chunk(state, payload)
            means.append(m['loss'])
        runs.append((state, torch.cat(means)))
    (got, m_got), (want, m_want) = runs
    for a, b in zip(_state_tensors(got), _state_tensors(want)):
        assert _bit_equal(a, b)
    assert _bit_equal(m_got, m_want)


@pytest.mark.cuda
def test_host_stream_replays_as_device_placement(dev):
    cfg = CONFIGS['mlp_global'](scan_steps=3, metrics_mode='stacked')
    ds = _data(cfg)
    out = []
    for placement in ('host_stream', 'device'):
        trainer = training.Trainer(cfg.replace(data_placement=placement), ds,
                                   device=dev)
        assert trainer.graphs is not None
        state = trainer.init_state()
        for _, payload in trainer.iter_chunk_plans(0, 9):
            state, m = trainer.run_chunk(state, payload)
        out.append((state, m['loss']))
    (a, la), (b, lb) = out
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert _bit_equal(x, y)
    assert _bit_equal(la, lb)


@pytest.mark.cuda
def test_a_replayed_step_nests_its_spans(dev):
    cfg = CONFIGS['conv_per_leaf'](scan_steps=2)
    trainer = training.Trainer(cfg, _data(cfg), device=dev)
    state = trainer.init_state()
    plan = trainer.batch_plan(3)
    trainer.run_chunk(state, plan[:1])   # the capture
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run_chunk(state, plan[1:])
    events = prof.events()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in events if e.name.startswith('gmvae.')),
                   key=lambda s: s[1])

    def inside(outer, name):
        return [s for s in spans if s[0] == name and outer[1] <= s[1]
                and s[2] <= outer[2]]
    steps = [s for s in spans if s[0] == 'gmvae.step']
    assert len(steps) == 2
    for step in steps:
        assert len(inside(step, 'gmvae.data_gather')) == 1
        opt = inside(step, 'gmvae.optimizer')
        assert len(opt) == 1 and len(inside(opt[0], 'gmvae.clip')) == 1


@pytest.mark.cuda
@pytest.mark.parametrize('cfg', [
    configs.mnist_deepmix(enc_hidden=(64,), dec_hidden=(64,)),
    configs.synthetic_tiny(),
    configs.mnist_k10(enc_hidden=(64,), dec_hidden=(64,), fused_noise='xla'),
], ids=['deep', 'unfused', 'xla_noise'])
def test_trainers_that_stay_eager_on_the_card(dev, cfg):
    trainer = training.Trainer(cfg, _data(cfg, 256), device=dev)
    assert trainer.graphs is None and trainer.eager_reason
    replays = _build.REPLAYS['train_step']
    trainer.run_chunk(trainer.init_state(), trainer.batch_plan(2))
    assert _build.REPLAYS['train_step'] == replays


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def _head_inputs(b=6, k=3, d=5, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    return (t(b, k), t(b, k, d), 0.5 * t(b, k, d),
            MixturePrior(t(k), t(k, d), 0.5 * t(k, d)))


# a word over 2^31: an int32 tensor holds it negative
KEY = (3000000001, 17)


def _key_tensor(key):
    return torch.from_numpy(np.array(key, np.uint32).view(np.int32))


@pytest.mark.parametrize('hard', [False, True])
def test_plain_head_takes_key_and_tau_as_the_kernels_do(hard):
    kl, qm, qlv, prior = _head_inputs()
    tau = np.float32(0.7)
    leaves = lambda: [x.clone().requires_grad_()  # noqa: E731
                      for x in (kl, qm, qlv, *prior)]
    outs = []
    for key, t in ((KEY, float(tau)),
                   (_key_tensor(KEY), torch.tensor(tau))):
        ins = leaves()
        out = fused_elbo.fused_mixture_elbo(key, *ins[:3],
                                            MixturePrior(*ins[3:]), t, hard)
        loss = sum(x.sum() * (i + 1) for i, x in enumerate(out))
        outs.append((out, torch.autograd.grad(loss, ins)))
    (a, ga), (b, gb) = outs
    for x, y in zip(list(a) + list(ga), list(b) + list(gb)):
        assert torch.equal(x, y)
    cs, cz, cy = torch.ones(6, 8), torch.ones(6, 5), torch.ones(6, 3)
    host = fused_elbo_bwd.fused_elbo_bwd(KEY, kl, qm, qlv, *prior,
                                         float(tau), hard, cs, cz, cy)
    dev = fused_elbo_bwd.fused_elbo_bwd(_key_tensor(KEY), kl, qm, qlv,
                                        *prior, torch.tensor(tau), hard, cs,
                                        cz, cy)
    for x, y in zip(host, dev):
        assert torch.equal(x, y)


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_scalar_table_holds_what_train_step_works_out(name):
    cfg = CONFIGS[name]()
    tx = training.make_optimizer(cfg)
    base = training.prng.prng_key(cfg.seed)
    step0, count0, n = 7, 3, 25   # a state whose count is not its step
    table = training.step_scalars(cfg, tx, base, 1, step0, count0, n)
    assert table.dtype == torch.int32
    assert table.shape == (n, len(training.SCALAR_COLS))
    words = table.numpy().view(np.uint32)
    f32 = table.numpy().view(np.float32)
    col = training.SCALAR_COLS.index
    for i in range(n):
        step = step0 + i
        k_pre, k_elbo = training.prng.split(training.prng.fold_in(
            training.prng.fold_in(base, step), 1))
        assert tuple(words[i, :2]) == k_pre
        assert tuple(words[i, 2:4]) == k_elbo
        tau, beta = training.schedules(cfg, step)
        assert f32[i, col('tau')] == tau.item()
        assert f32[i, col('beta')] == beta.item()
        c = np.float32(count0 + i + 1)
        for b, name_ in ((0.9, 'inv_bc1'), (0.999, 'inv_bc2')):
            bc = float(np.float32(1.0) - np.float32(b) ** c)   # update's
            assert f32[i, col(name_)] == np.float32(1.0) / np.float32(bc)
        assert words[i, col('step')] == step
    if cfg.kl_warmup_steps:
        assert len(set(f32[:, col('beta')].tolist())) > 1


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_graph_parts_read_the_table_as_train_step_computes(name):
    """The graphs' three parts run eagerly on the CPU over a slot of the
    table give ``train_step``'s first loss exactly, and its later losses
    and its parameters within float32 roundings and what Adam makes of
    them: on the CPU a division by a host scalar divides, and on the card
    it multiplies by the reciprocal, which the parts use."""
    cfg = CONFIGS[name](scan_steps=3, metrics_mode='stacked',
                        batch_size=16)
    if cfg.arch == 'conv':
        cfg = cfg.replace(n_components=4, latent_dim=8)
    trainer = training.Trainer(cfg, _data(cfg, 64), device='cpu')
    assert trainer.graphs is None
    state = trainer.init_state()
    plan = trainer.batch_plan(3)
    want, m_want = trainer.run_chunk(state, plan)
    parts = training.StepGraphs(
        training.make_grad_fn(trainer.model, cfg), trainer.tx, trainer.flat,
        [p.numel() for p in trainer.model.parameters()],
        (trainer.b_local, *cfg.image_shape))
    trainer.bind(state)
    parts.load(state.opt_state)
    table = training.step_scalars(cfg, trainer.tx, trainer.base_key, 0, 0,
                                  0, 3)
    losses = []
    for i in range(3):
        k_pre = tuple(int(w) for w in table.numpy().view(np.uint32)[i, :2])
        preprocess.preprocess_batch(
            k_pre, trainer.x_all[plan[i]].reshape(parts.x.shape),
            cfg.binarize, out=parts.x)
        parts.slot.copy_(table[i])
        buf = parts._run(parts._parts(), lambda j, part, arg: part(arg))
        losses.append(float(buf[parts.n]))
    assert losses[0] == m_want['loss'][0].item()
    np.testing.assert_allclose(losses, m_want['loss'].numpy(), rtol=1e-6)
    got = torch.cat([p.reshape(-1) for p in trainer.model.state_dict()
                     .values()])
    ref = torch.cat([p.reshape(-1) for p in want.params.values()])
    # Adam moves a parameter by ~lr whatever its gradient's size, so a
    # rounding in a near-zero gradient moves it by up to 2 lr a step
    assert float((got - ref).abs().max()) <= 2 * cfg.lr * 3
    assert float((got - ref).abs().mean()) <= 1e-5


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_in_place_adam_half_matches_update(dtype):
    adam = training.scale_by_adam_lowmem(state_dtype=dtype)
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.normal(size=1000).astype(np.float32))
    state = adam.init(g)
    state = training.AdamState(4, state.mu + 0.01, state.nu + 0.02)
    u, want = adam.update(g, state)
    inv = [torch.tensor(v) for v in adam.inv_bias(5)]
    live = state.clone()
    u_ = adam.update_(g, live, inv)
    assert torch.equal(live.mu, want.mu) and torch.equal(live.nu, want.nu)
    torch.testing.assert_close(u_, u, rtol=1e-6, atol=0)


def test_leaf_clip_sends_its_lengths_once(monkeypatch):
    clip = training.clip_by_leaf_norm(1.0)
    g = torch.arange(10, dtype=torch.float32)
    made = []
    real = torch.tensor
    monkeypatch.setattr(torch, 'tensor',
                        lambda *a, **k: made.append(a) or real(*a, **k))
    first, second = clip(g, [4, 6]), clip(g, [4, 6])
    assert len(made) == 1 and torch.equal(first, second)
    clip(g, [5, 5])
    assert len(made) == 2


@pytest.mark.parametrize('binarize', [False, True])
def test_preprocess_into_a_buffer_is_preprocess(binarize):
    x = torch.randint(0, 256, (4, 6, 6, 1), dtype=torch.uint8)
    out = torch.full((4, 6, 6, 1), float('nan'))
    got = preprocess.preprocess_batch((1, 2), x, binarize, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(got, preprocess.preprocess_batch((1, 2), x, binarize))


@pytest.mark.parametrize('cfg, device, backend, n_dp, graphs', [
    (configs.celeba_dp16(), 'cuda', None, 1, True),
    (configs.celeba_dp16(), 'cuda', 'nccl', 1, True),
    (configs.mnist_k10(data_placement='host_stream'), 'cuda', None, 1, True),
    (configs.celeba_dp16(), 'cpu', None, 1, False),
    (configs.mnist_deepmix(), 'cuda', None, 1, False),
    (configs.synthetic_tiny(), 'cuda', None, 1, False),
    (configs.mnist_k10(fused_noise='xla'), 'cuda', None, 1, False),
    (configs.mnist_k10(), 'cuda', 'gloo', 1, False),
    (configs.mnist_k10(), 'cuda', 'gloo', 2, False),
    (configs.celeba_dp16(), 'cuda', 'nccl', 4, False),
], ids=['celeba', 'one_nccl_rank', 'host_stream', 'cpu', 'deep', 'unfused',
        'xla_noise', 'gloo', 'gloo_2', 'nccl_4'])
def test_which_trainers_replay_graphs(cfg, device, backend, n_dp, graphs):
    why = training.eager_reason(cfg, torch.device(device), backend, n_dp)
    assert (why is None) == graphs, why


def test_a_cpu_trainer_stays_eager():
    cfg = configs.synthetic_tiny()
    trainer = training.Trainer(cfg, _data(cfg, 128), device='cpu')
    assert trainer.graphs is None
    assert trainer.eager_reason == 'not a CUDA device'
