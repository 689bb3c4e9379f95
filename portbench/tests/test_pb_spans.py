"""The readers of the program's spans (``portbench/metrics/``) on small
chrome traces written here: two training steps with the step, gather,
optimizer and clip spans; two assignment requests with the serving
call's spans inside the benchmark's own; and the same traces with a span
taken out, where a reader gives nothing rather than zero."""

import json

import pytest

from portbench.core import manifest
from portbench.core.trace import read_chrome_trace
from portbench.generators.common import LayerContext

CFG = {'n_components': 64, 'latent_dim': 256, 'image_shape': [64, 64, 3],
       'arch': 'conv', 'enc_hidden': [64, 128, 256, 512],
       'dec_hidden': [512, 256, 128, 64], 'likelihood': 'gaussian'}
HOST = ('cpu_op', 'user_annotation', 'cuda_runtime')
TRAIN = ('clip_ms_per_step', 'adam_ms_per_step', 'data_gather_ms_per_step',
         'host_copies_per_step')
ASSIGN = ('serve_model_ms_per_req', 'serve_idle_ms_per_req')


def x(name, cat, ts, dur, **args):
    host = cat in HOST
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur,
            'pid': 1 if host else 0, 'tid': 1 if host else 7, 'args': args}


def op(name, ts, dur, corr, dev_ts, dev_dur, dev_name, cat='kernel'):
    """A PyTorch operation on the host that launches one device operation
    (a kernel, or a copy through ``cudaMemcpyAsync``)."""
    call = 'cudaLaunchKernel' if cat == 'kernel' else 'cudaMemcpyAsync'
    return [x(name, 'cpu_op', ts, dur),
            x(call, 'cuda_runtime', ts + 1, 2, correlation=corr),
            x(dev_name, cat, dev_ts, dev_dur, correlation=corr)]


def train_trace():
    """Two steps of 1,000 us. A step: its span around two gathers (30 and
    10 us on the card), a conv (200), the optimizer's span around the
    clip's (a pageable copy in of 4 us, the index build 60, the multiply
    20) and Adam's two kernels (30, 10), and a copy on the card (2); the
    chunk's read back (8) after the last step, outside every step."""
    ev = []
    for s in range(2):
        t, c = 1000 * s, 100 * s
        ev += [x('gmvae.step', 'user_annotation', t, 900),
               x('gmvae.data_gather', 'user_annotation', t, 50),
               *op('aten::index', t + 5, 30, c + 1, t + 20, 30,
                   'index_elementwise_kernel'),
               x('gmvae.data_gather', 'user_annotation', t + 60, 40),
               *op('aten::mul', t + 65, 20, c + 2, t + 55, 10,
                   'vectorized_elementwise_kernel'),
               *op('aten::cudnn_convolution', t + 110, 50, c + 3, t + 100,
                   200, 'sm90_xmma_fprop_implicit_gemm'),
               x('gmvae.optimizer', 'user_annotation', t + 500, 300),
               x('gmvae.clip', 'user_annotation', t + 500, 150),
               *op('aten::copy_', t + 505, 20, c + 4, t + 510, 4,
                   'Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy'),
               *op('aten::repeat_interleave', t + 530, 30, c + 5, t + 520,
                   60, 'compute_cuda_kernel'),
               *op('aten::mul', t + 600, 20, c + 6, t + 580, 20,
                   'vectorized_elementwise_kernel'),
               *op('aten::add', t + 660, 20, c + 7, t + 660, 30,
                   'vectorized_elementwise_kernel'),
               *op('aten::add_', t + 700, 20, c + 8, t + 700, 10,
                   'vectorized_elementwise_kernel'),
               *op('aten::clone', t + 850, 20, c + 9, t + 860, 2,
                   'Memcpy DtoD (Device -> Device)', 'gpu_memcpy')]
    ev += op('aten::copy_', 1950, 20, 999, 1960, 8,
             'Memcpy DtoH (Device -> Pageable)', 'gpu_memcpy')
    return ev


def assign_trace():
    """Two requests of 1,000 us, each inside the benchmark's span: the
    serving call's span (800 us) around the pinned copy in (100 us on the
    card), the exported graph's span (a conv of 100 and a GEMM of 50 us)
    and the answer's copy out (10). Idle on the card inside a call:
    80 + 50 + 250 us; between the calls, 360 us that are not counted."""
    ev = []
    for r in range(2):
        t, c = 1000 * r, 100 * r
        ev += [x('portbench.request', 'user_annotation', t - 10, 990),
               x('gmvae.serve.call', 'user_annotation', t, 800),
               *op('aten::copy_', t + 10, 20, c + 1, t + 20, 100,
                   'Memcpy HtoD (Pinned -> Device)', 'gpu_memcpy'),
               x('gmvae.serve.run', 'user_annotation', t + 150, 450),
               *op('aten::cudnn_convolution', t + 160, 30, c + 2, t + 200,
                   100, 'sm90_xmma_fprop_implicit_gemm'),
               *op('aten::mm', t + 200, 30, c + 3, t + 350, 50,
                   'sm80_xmma_gemm_f32f32'),
               *op('aten::copy_', t + 620, 60, c + 4, t + 650, 10,
                   'Memcpy DtoH (Device -> Pageable)', 'gpu_memcpy')]
    return ev


def without(events, span):
    return [e for e in events if e['name'] != span]


def ctx(tmp_path, events, kind):
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events}))
    tr = read_chrome_trace(str(path), 0.002)
    return LayerContext(kind, CFG, 1024, tr, 2, 1.0, 40, {})


def read(metric, c):
    return manifest.reader(metric).read(c)


@pytest.mark.parametrize('metric,want', [
    ('clip_ms_per_step', 0.084),          # 4 + 60 + 20 us a step
    ('adam_ms_per_step', 0.040),          # 30 + 10
    ('data_gather_ms_per_step', 0.040),   # 30 + 10
    ('host_copies_per_step', 1.0),        # the clip's copy in; not the
                                          # copy on the card, nor the read
                                          # after the last step
])
def test_train_readers(tmp_path, metric, want):
    assert read(metric, ctx(tmp_path, train_trace(), 'train')) == (
        pytest.approx(want))


@pytest.mark.parametrize('metric,want', [
    ('serve_model_ms_per_req', 0.150),    # 100 + 50 us a request
    ('serve_idle_ms_per_req', 0.380),     # 80 + 50 + 250
])
def test_assign_readers(tmp_path, metric, want):
    assert read(metric, ctx(tmp_path, assign_trace(), 'assign')) == (
        pytest.approx(want))


def test_clip_and_adam_sum_to_the_optimizer(tmp_path):
    c = ctx(tmp_path, train_trace(), 'train')
    assert read('clip_ms_per_step', c) + read('adam_ms_per_step', c) == (
        pytest.approx(read('optimizer_ms_per_step', c)))


def test_a_gap_outside_the_call_is_not_counted(tmp_path):
    """The 360 us between the two calls lie inside the benchmark's span
    only; a gap that moves into a call is counted."""
    c = ctx(tmp_path, assign_trace(), 'assign')
    gaps = dict(c.trace.idle_gaps())
    assert gaps['portbench.request'] == pytest.approx(360e-6)
    ev = assign_trace()
    ev[1] = dict(ev[1], dur=900)   # the first call now holds that gap
    assert read('serve_idle_ms_per_req', ctx(tmp_path, ev, 'assign')) == (
        pytest.approx(0.380 + 0.180))


@pytest.mark.parametrize('metric,span', [
    *[(m, 'gmvae.step') for m in TRAIN],
    ('clip_ms_per_step', 'gmvae.clip'),
    ('adam_ms_per_step', 'gmvae.optimizer'),
    ('data_gather_ms_per_step', 'gmvae.data_gather'),
    *[(m, 'gmvae.serve.call') for m in ASSIGN],
    ('serve_model_ms_per_req', 'gmvae.serve.run'),
])
def test_a_missing_span_reads_nothing(tmp_path, metric, span):
    kind = 'train' if metric in TRAIN else 'assign'
    events = train_trace() if kind == 'train' else assign_trace()
    assert read(metric, ctx(tmp_path, without(events, span), kind)) is None


@pytest.mark.parametrize('metric', TRAIN + ASSIGN)
def test_the_other_kind_reads_nothing(tmp_path, metric):
    """Each reader gives nothing in the other kind's cell, whose trace
    holds none of its spans, nor on its own kind's trace read as the
    other kind."""
    own = 'train' if metric in TRAIN else 'assign'
    other = 'assign' if own == 'train' else 'train'
    for events in (train_trace(), assign_trace()):
        assert read(metric, ctx(tmp_path, events, other)) is None
