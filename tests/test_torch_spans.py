"""The port's spans at its layer boundaries (``utils/profiling.span``), as
the profiler records them on the CPU: a chunk of training steps and a
call of an exported artifact, each traced, its chrome trace exported and
read back, and the spans' nesting checked by their times on one thread.
The benchmark's per-layer metrics (``portbench/metrics/``) read these
spans by name."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gmvae_tpu_torch import configs, serving, training
from gmvae_tpu_torch.data import loaders
from gmvae_tpu_torch.utils import profiling

# one intra-op thread a test process (why: tests/test_torch_hygiene.py)
torch.set_num_threads(1)

NARROW = dict(enc_hidden=(8, 16, 16), dec_hidden=(16, 16, 8),
              compute_dtype='float32', batch_size=8, scan_steps=2)


def _spans(prof, tmp_path):
    """The ``gmvae.*`` ranges of the exported trace: [(name, tid, start,
    end)] in us, in order of start."""
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())['traceEvents']
    return sorted(((e['name'], e['tid'], float(e['ts']),
                    float(e['ts']) + float(e['dur']))
                   for e in events
                   if e.get('ph') == 'X' and e.get('cat') == 'user_annotation'
                   and e['name'].startswith('gmvae.')),
                  key=lambda s: s[2])


def _inside(spans, outer, name):
    """The spans called ``name`` that lie inside ``outer`` on its thread."""
    _, tid, s, e = outer
    return [x for x in spans
            if x[0] == name and x[1] == tid and s <= x[2] and x[3] <= e]


def _named(spans, name):
    return [x for x in spans if x[0] == name]


@pytest.fixture(scope='module')
def data():
    return loaders.make_synthetic(image_shape=(32, 32, 3), n_clusters=4,
                                  n_train=32, n_test=8, seed=3)


@pytest.mark.parametrize('clip', [('per_leaf', 1.0), ('global', 1.0),
                                  ('value', 0.1), ('global', 0.0)],
                         ids=['per_leaf', 'global', 'value', 'no_clip'])
def test_a_chunk_nests_step_gather_optimizer_and_clip(data, tmp_path, clip):
    impl, max_norm = clip
    cfg = configs.svhn_conv(**NARROW, grad_clip_impl=impl,
                            grad_clip=max_norm)
    trainer = training.Trainer(cfg, dataset=data, device='cpu')
    state = trainer.init_state()
    _, payload = next(trainer.iter_chunk_plans(0, 2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run_chunk(state, payload)
    spans = _spans(prof, tmp_path)
    steps = _named(spans, 'gmvae.step')
    assert len(steps) == 2
    for step in steps:
        # the chunk's gather and train_step's preprocess_batch
        assert len(_inside(spans, step, 'gmvae.data_gather')) == 2
        opt = _inside(spans, step, 'gmvae.optimizer')
        assert len(opt) == 1
        assert len(_inside(spans, opt[0], 'gmvae.clip')) == (
            1 if max_norm > 0 else 0)
    assert len(_named(spans, 'gmvae.optimizer')) == 2
    assert len(_named(spans, 'gmvae.clip')) == (2 if max_norm > 0 else 0)
    assert len(_named(spans, 'gmvae.data_gather')) == 4


def test_a_program_call_holds_its_run(data, tmp_path):
    cfg = configs.svhn_conv(**NARROW)
    trainer = training.Trainer(cfg, dataset=data, device='cpu')
    blob = serving.export_verb(trainer, trainer.init_state(), 'assign',
                               device='cpu')
    program = serving.load_program(blob, device='cpu')
    x = data.test_x[:4].astype(np.float32) / 255.0
    program(x)   # the first call outside the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ids = program(x)
    assert ids.shape == (4,)
    spans = _spans(prof, tmp_path)
    calls = _named(spans, 'gmvae.serve.call')
    assert len(calls) == 1
    assert len(_inside(spans, calls[0], 'gmvae.serve.run')) == 1
    assert len(_named(spans, 'gmvae.serve.run')) == 1


def test_a_span_is_one_shared_object_while_the_profiler_is_off():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span('gmvae.step'), profiling.span('gmvae.clip')
    assert a is b
    with a, b:   # entered twice, nested
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span('gmvae.step') is not a
