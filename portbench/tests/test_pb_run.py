"""Runs of the harness without a card: refusals, the JAX guard, and the
rest of a run driven on the CPU at a small size, sound and with the timed
path broken underneath (each fault a cell can have must read
``correct: false``), and the control against each cell's limits."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.core import manifest
from portbench.generators import assign, train
from portbench.reference import model, precision
from portbench.reference import train as reference

REPO = manifest.REPO
RUN = os.path.join(REPO, 'portbench', 'run.py')
SEED = 2 ** 31 + 1234
TRAIN = 'celeba_dp16.train_b1024'


def small_train(cell):
    return cell._replace(config=dict(cell.config, batch_size=8,
                                     train_examples=48, scan_steps=4),
                         traffic=dict(cell.traffic, global_batch=8))


def small_assign(cell):
    return cell._replace(config=dict(cell.config, test_examples=128),
                         traffic=dict(cell.traffic, batch=32))


def import_run():
    sys.path.insert(0, os.path.join(REPO, 'portbench'))
    try:
        import run
    finally:
        sys.path.pop(0)
    return run


def on_the_cpu(monkeypatch, adjust):
    """A run without a card: the CPU in the card's place, and the cell
    cut by ``adjust`` as the harness finds it."""
    run = import_run()
    find = manifest.find_cell
    monkeypatch.setattr(manifest, 'find_cell',
                        lambda *a, **kw: adjust(find(*a, **kw)))
    monkeypatch.setattr(run, 'card', lambda chips: 'cpu')
    monkeypatch.setattr(run, 'card_kind', lambda device: 'cpu')
    return run


def run_main(capsys, monkeypatch, workload, adjust):
    run = on_the_cpu(monkeypatch, adjust)
    rc = run.main(['--workload', workload, '--seed', str(SEED),
                   '--seconds', '0.5'])
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[-1] == 'checks'
    assert out.err.strip().splitlines()[-1].startswith('check ')
    return line


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run([sys.executable, RUN, '--workload',
                          'celeba_dp16.train_b1024', '--seed', '1',
                          '--seconds', '1', '--trace', '0'],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ''
    assert 'CUDA device' in out.stderr


def test_alone_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(REPO, 'portbench'), tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                          'celeba_dp16.assign_b1024', '--seed', '1',
                          '--seconds', '1', '--trace', '0'],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ''


def test_jax_guard_compares_whole_top_level_names(monkeypatch):
    run = import_run()
    for name in ('jax', 'jaxlib', 'flax', 'gmvae_tpu', 'jax.numpy',
                 'gmvae_tpu.training'):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, 'gmvae_tpu_torch_fake', object())
    monkeypatch.setitem(sys.modules, 'jaxtyping_fake', object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'gmvae_tpu.training', object())
    monkeypatch.setitem(sys.modules, 'flax', object())
    assert run.forbidden_modules() == ['flax', 'gmvae_tpu.training']


def test_train_sound(capsys, monkeypatch):
    line = run_main(capsys, monkeypatch, TRAIN, small_train)
    assert line['correct'] is True, line['checks']
    assert set(line['metrics']) == {'train_img_per_s', 'setup_s'}
    assert line['attempted'] > 0 and line['failed'] == 0


def test_train_fault_state_unchanged(capsys, monkeypatch):
    from gmvae_tpu_torch import training
    orig = training.Trainer.run_chunk

    def unchanged(self, state, payload):
        return state, orig(self, state, payload)[1]
    monkeypatch.setattr(training.Trainer, 'run_chunk', unchanged)
    line = run_main(capsys, monkeypatch, TRAIN, small_train)
    assert line['correct'] is False
    assert line['checks']['grad_gap']['value'] == pytest.approx(1.0)


def test_train_fault_half_batch(capsys, monkeypatch):
    from gmvae_tpu_torch import training
    orig = training.make_train_step

    def half(*a, **kw):
        step = orig(*a, **kw)
        return lambda opt, batch, key, i: step(
            opt, batch[:batch.shape[0] // 2], key, i)
    monkeypatch.setattr(training, 'make_train_step', half)
    line = run_main(capsys, monkeypatch, TRAIN, small_train)
    assert line['correct'] is False


@pytest.mark.parametrize('fault', ['loss_altered', 'nonfinite'])
def test_train_fault_in_whole_chunks_only(capsys, monkeypatch, fault):
    """A fault only where a chunk runs the configuration's whole
    ``scan_steps``, the window's length, with steps 1-3's short chunks
    sound: the first whole chunk's step-1 loss and the window's step
    losses are what catch it."""
    from gmvae_tpu_torch import training
    orig = training.Trainer.run_chunk

    def faulty(self, state, payload):
        state, m = orig(self, state, payload)
        if payload.shape[0] == self.cfg.scan_steps:
            loss = m['loss'].clone()
            if fault == 'loss_altered':
                loss *= 1.01
            else:
                loss[-1] = float('nan')
            m = dict(m, loss=loss)
        return state, m
    monkeypatch.setattr(training.Trainer, 'run_chunk', faulty)
    line = run_main(capsys, monkeypatch, TRAIN, small_train)
    assert line['correct'] is False
    bad = {k for k, c in line['checks'].items()
           if not c['value'] <= c['limit']}
    assert bad == ({'loss1_gap'} if fault == 'loss_altered'
                   else {'nonfinite_losses'}), line['checks']


@pytest.mark.parametrize('workload', ['celeba_dp16.assign_b1024'])
def test_assign_sound(capsys, monkeypatch, workload):
    line = run_main(capsys, monkeypatch, workload, small_assign)
    assert line['correct'] is True, line['checks']
    cell = manifest.find_cell(manifest.load_manifest(), workload)
    assert set(line['metrics']) == {x['name'] for x in cell.end_to_end}
    assert {'assign_img_per_s', 'setup_s'} <= set(line['metrics'])


@pytest.mark.parametrize('workload', ['celeba_dp16.assign_b1024'])
def test_assign_fault_answer_altered(capsys, monkeypatch, workload):
    from gmvae_tpu_torch import serving
    orig = serving.Program.__call__
    k = manifest.find_cell(manifest.load_manifest(),
                           workload).config['n_components']

    def altered(self, x):
        ids = orig(self, x).copy()
        ids[0] = (ids[0] + 1) % k
        return ids
    monkeypatch.setattr(serving.Program, '__call__', altered)
    line = run_main(capsys, monkeypatch, workload, small_assign)
    assert line['correct'] is False


def test_train_control_fails():
    """The control: the reference in float8 in the program's place, three
    steps at a small size, against the cell's limits."""
    cell = small_train(manifest.find_cell(manifest.load_manifest(), TRAIN))
    cfg = cell.config
    u8 = np.random.default_rng(0).integers(
        0, 256, (48, *cfg['image_shape']), dtype=np.uint8)
    p0 = model.make_params(cfg, SEED, 'cpu')
    ref = reference.train_steps(cfg, p0, u8, SEED % 2 ** 32, 3, 'cpu')
    low = reference.train_steps(cfg, p0, u8, SEED % 2 ** 32, 3, 'cpu',
                                cast=precision.fp8_e4m3)
    vals = train.numbers(cfg, p0, low.losses, low.first_grad, low.params,
                         ref)
    assert any(vals[k] > v for k, v in cell.limits.items()), vals


@pytest.mark.parametrize('workload', ['celeba_dp16.assign_b1024'])
def test_assign_control_fails(workload):
    cell = manifest.find_cell(manifest.load_manifest(), workload)
    cfg = dict(cell.config, test_examples=512)
    pool, _ = assign.pool_images(cfg, SEED, 1, 'cpu')
    x = torch.from_numpy(pool[:512])
    p0 = model.make_params(cfg, SEED, 'cpu')
    ref = reference.cluster_logits(cfg, p0, x, 'cpu')
    low = reference.cluster_logits(cfg, p0, x, 'cpu',
                                   cast=precision.fp8_e4m3)
    ids = low.argmax(1).to(torch.int32).numpy()
    vals = assign.numbers(assign.gaps(ref, [0], [ids], 512))
    assert vals['gap_max'] > cell.limits['gap_max'], vals
