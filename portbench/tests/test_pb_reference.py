"""The reference against the port's plain path on the CPU at small sizes,
from the same weights (``make_params``) and inputs."""

import json
import math
import os

import numpy as np
import pytest
import torch

from portbench.core import inputs
from portbench.generators import common
from portbench.reference import model, optim
from portbench.reference import threefry as tf
from portbench.reference import train as reference

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name, **kw):
    with open(os.path.join(HERE, 'configs', name + '.json')) as f:
        cfg = json.load(f)
    cfg.update(compute_dtype='float32', **kw)
    return cfg


SMALL = {
    'celeba_dp16': dict(image_shape=[16, 16, 3], enc_hidden=[8, 16, 16, 32],
                        dec_hidden=[32, 16, 16, 8], latent_dim=8,
                        n_components=4, batch_size=6),
    'cifar_k20': dict(image_shape=[8, 8, 3], enc_hidden=[8, 16],
                      dec_hidden=[16, 8], latent_dim=6, n_components=5,
                      batch_size=6),
}


def port_model(cfg, seed):
    from gmvae_tpu_torch import training
    pcfg = common.port_config(cfg, seed)
    m = training.make_model(pcfg, 'cpu')
    params = model.make_params(cfg, seed, 'cpu')
    m.load_state_dict(params)
    return m, params


@pytest.mark.parametrize('name', sorted(SMALL))
def test_layout_is_the_ports(name):
    cfg = config(name)
    m, _ = port_model(cfg, 0)
    common.check_layout(cfg, m.state_dict())
    assert sum(v.numel() for v in m.state_dict().values()) == cfg['params']


@pytest.mark.parametrize('name', sorted(SMALL))
def test_nets_equal_the_ports(name):
    cfg = config(name, **SMALL[name])
    m, p = port_model(cfg, 3)
    x = torch.rand(5, *cfg['image_shape'], generator=torch.Generator()
                   .manual_seed(1))
    z = torch.randn(5, cfg['latent_dim'])
    with torch.no_grad():
        for a, b in zip(m.encode(x), model.encode(cfg, p, x)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(m.decoder(z), model.decode(cfg, p, z),
                                   rtol=1e-5, atol=1e-6)


def test_elbo_equals_the_ports():
    from gmvae_tpu_torch import prng
    cfg = config('celeba_dp16', **SMALL['celeba_dp16'])
    m, p = port_model(cfg, 5)
    x = torch.rand(6, *cfg['image_shape'])
    key = prng.fold_in(prng.prng_key(9), 4)
    with torch.no_grad():
        elbo, aux = m.elbo_terms(x, key, 1.5)
        g, eps = tf.head_noise(key, 6, cfg['n_components'],
                               cfg['latent_dim'])
        ref = model.elbo_terms(cfg, p, x, g, eps, 1.5)
    torch.testing.assert_close(elbo, ref[0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(aux['kl_cat'], ref[2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('impl,state', [('per_leaf', 'float32'),
                                        ('global', 'float32'),
                                        ('global', 'bfloat16'),
                                        ('value', 'float32')])
def test_clip_and_adam_equal_the_ports(impl, state):
    from gmvae_tpu_torch import configs, training
    pcfg = configs.celeba_dp16(grad_clip_impl=impl, opt_state_dtype=state,
                               grad_clip=0.5)
    cfg = {'grad_clip': 0.5, 'grad_clip_impl': impl, 'lr': pcfg.lr,
           'opt_state_dtype': state}
    gen = torch.Generator().manual_seed(0)
    shapes = {'a': (3, 4), 'b': (7,), 'c': (2, 2, 2)}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    tx = training.make_optimizer(pcfg)
    flat = torch.cat([v.reshape(-1) for v in params.values()])
    sizes = [v.numel() for v in params.values()]
    st_port, st_ref = tx.init(flat), optim.init(cfg, params)
    for _ in range(3):
        grads = {k: 2 * torch.randn(s, generator=gen)
                 for k, s in shapes.items()}
        u, st_port = tx.update(torch.cat([g.reshape(-1) for g in
                                          grads.values()]), st_port, sizes)
        flat = flat + u
        params, st_ref = optim.adam(cfg, params, optim.clip(cfg, grads),
                                    st_ref)
    torch.testing.assert_close(
        flat, torch.cat([v.reshape(-1) for v in params.values()]),
        rtol=1e-5, atol=1e-7)


def test_keys_plan_and_noise_equal_the_ports():
    from gmvae_tpu_torch import prng
    from gmvae_tpu_torch.data import epoch_batch_indices
    from gmvae_tpu_torch.ops.kernels.threefry import replay_noise
    key = prng.fold_in(prng.prng_key(2 ** 32 - 5), 7)
    assert tf.fold_in(tf.prng_key(2 ** 32 - 5), 7) == key
    assert tf.split(key, 3) == prng.split(key, 3)
    assert torch.equal(tf.uniform01(key, (4, 5)), prng.uniform(key, (4, 5)))
    assert torch.equal(tf.permutation(key, 1001), prng.permutation(key, 1001))
    want = epoch_batch_indices(key, 103, 8, 30, 0)
    assert torch.equal(tf.batch_rows(key, 103, 8, range(30)), want)
    for a, b in zip(tf.head_noise(key, 5, 3, 7), replay_noise(key, 5, 3, 7)):
        assert torch.equal(a, b)
    assert tf.temperature(0, 2.0, 0.5, 1e-4) == 2.0


@pytest.mark.parametrize('name', ['celeba_dp16', 'cifar_k20'])
def test_three_steps_equal_the_ports(name):
    from gmvae_tpu_torch import data as data_lib
    from gmvae_tpu_torch import training
    cfg = config(name, **SMALL[name], train_examples=40)
    seed = 2 ** 31 + 77
    u8 = inputs.images_u8(40, cfg['image_shape'], seed, 'cpu')
    y = np.zeros(40, np.int32)
    tr = training.Trainer(common.port_config(cfg, seed),
                          data_lib.Dataset(name, u8, y, u8, y), device='cpu')
    p0 = model.make_params(cfg, seed, 'cpu')
    state = tr.fresh_state({k: v.clone() for k, v in p0.items()})
    _, plan = next(tr.iter_chunk_plans(0, 100))
    losses = []
    for i in range(3):
        state, m = tr.run_chunk(state, plan[i:i + 1])
        losses.append(float(m['loss'][-1]))
    ref = reference.train_steps(cfg, p0, u8, seed % 2 ** 32, 3, 'cpu')
    assert np.allclose(losses, ref.losses, rtol=1e-5)
    for k in p0:
        torch.testing.assert_close(state.params[k], ref.params[k],
                                   rtol=1e-4, atol=1e-5)


def test_assign_artifact_equals_the_reference():
    from gmvae_tpu_torch import data as data_lib
    from gmvae_tpu_torch import serving, training
    cfg = config('cifar_k20', **SMALL['cifar_k20'])
    seed = 12
    u8 = inputs.images_u8(30, cfg['image_shape'], seed, 'cpu')
    y = np.zeros(30, np.int32)
    tr = training.Trainer(common.port_config(cfg, seed),
                          data_lib.Dataset('c', u8, y, u8, y), device='cpu')
    p = model.make_params(cfg, seed, 'cpu')
    blob = serving.export_verb(tr, tr.fresh_state(p), 'assign',
                               device='cpu')
    x = u8.astype(np.float32) / 255.0
    ids = serving.load_program(blob, device='cpu')(x)
    ref = reference.cluster_logits(cfg, p, torch.from_numpy(x), 'cpu')
    assert np.array_equal(ids, ref.argmax(1).numpy())


def test_images_repeat_for_a_seed_and_spread():
    a = inputs.images_u8(20, (16, 16, 3), 2 ** 31 + 9, 'cpu')
    b = inputs.images_u8(20, (16, 16, 3), 2 ** 31 + 9, 'cpu')
    c = inputs.images_u8(20, (16, 16, 3), 2 ** 31 + 10, 'cpu')
    assert a.dtype == np.uint8 and a.shape == (20, 16, 16, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    means = a.reshape(20, -1).mean(1)
    assert means.std() > 10      # images differ in brightness
    assert math.isfinite(float(means.mean()))


WORKER = '''
import json, sys
import numpy as np, torch
from portbench.core import inputs
from portbench.generators import common
from portbench.reference import model
from gmvae_tpu_torch import data as data_lib, training
cfg, seed, out = json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
u8 = inputs.images_u8(cfg['train_examples'], cfg['image_shape'], seed, 'cpu')
y = np.zeros(u8.shape[0], np.int32)
tr = training.Trainer(common.port_config(cfg, seed),
                      data_lib.Dataset('d', u8, y, u8, y), device='cpu')
state = tr.fresh_state(model.make_params(cfg, seed, 'cpu'))
_, plan = next(tr.iter_chunk_plans(0, 100))
losses = []
for i in range(3):
    state, m = tr.run_chunk(state, plan[i:i + 1])
    losses.append(float(m['loss'][-1]))
if tr.rank == 0:
    torch.save({'losses': losses, 'params': state.params}, out)
'''


@pytest.mark.parametrize('sharding', ['sharded', 'replicated'])
def test_three_steps_over_two_ranks_equal_the_ports(tmp_path, sharding):
    """The reference's data-parallel step (every rank's rows and noise,
    the gradients averaged) against the port over two gloo ranks."""
    from gmvae_tpu_torch.parallel.launch import launch
    cfg = config('celeba_dp16', **dict(SMALL['celeba_dp16'], batch_size=8),
                 train_examples=41, data_sharding=sharding)
    seed = 2 ** 31 + 5
    script, out = tmp_path / 'worker.py', tmp_path / 'out.pt'
    script.write_text(WORKER)
    launch(2, [str(script), json.dumps(cfg), str(seed), str(out)],
           timeout=300)
    got = torch.load(out)
    u8 = inputs.images_u8(41, cfg['image_shape'], seed, 'cpu')
    ref = reference.train_steps(cfg, model.make_params(cfg, seed, 'cpu'),
                                u8, seed % 2 ** 32, 3, 'cpu', n_dp=2)
    assert np.allclose(got['losses'], ref.losses, rtol=1e-5)
    for k, v in ref.params.items():
        torch.testing.assert_close(got['params'][k], v, rtol=1e-4,
                                   atol=1e-5)
