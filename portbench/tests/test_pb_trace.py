"""The trace reader and the per-layer metrics on small recorded chrome
traces written here: a card's trace with kernels, copies, launches, the
program's spans and PyTorch operations; and traces that must be refused."""

import json

import pytest

from portbench.core import manifest
from portbench.core.trace import Trace, TraceRefused, read_chrome_trace
from portbench.generators.common import LayerContext

CFG = {'n_components': 64, 'latent_dim': 256, 'image_shape': [64, 64, 3],
       'arch': 'conv', 'enc_hidden': [64, 128, 256, 512],
       'dec_hidden': [512, 256, 128, 64], 'likelihood': 'gaussian'}


def x(name, cat, ts, dur, tid=1, **args):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur,
            'pid': 1 if cat in ('cpu_op', 'user_annotation', 'cuda_runtime')
            else 0, 'tid': tid if cat in ('cpu_op', 'user_annotation',
                                          'cuda_runtime') else 7,
            'args': args}


def launch(ts, corr):
    return x('cudaLaunchKernel', 'cuda_runtime', ts, 2, correlation=corr)


def card_trace():
    """Two steps of 1,000 us: in each, a conv kernel, the head's two
    kernels, an optimizer kernel under the program's span, and a copy."""
    ev = []
    for s in range(2):
        t = 1000 * s
        ev += [x('gmvae.optimizer', 'user_annotation', t + 500, 100),
               x('aten::convolution', 'cpu_op', t, 50),
               launch(t + 10, 10 * s + 1),
               x('sm90_xmma_fprop_implicit_gemm', 'kernel', t + 20, 200,
                 correlation=10 * s + 1),
               x('FusedHead', 'cpu_op', t + 60, 30),
               launch(t + 70, 10 * s + 2),
               x('fused_elbo_fwd_kernel(gmvae::HeadIn)', 'kernel', t + 220,
                 100, correlation=10 * s + 2),
               launch(t + 80, 10 * s + 3),
               x('fused_elbo_bwd_kernel(gmvae::HeadIn)', 'kernel', t + 320,
                 150, correlation=10 * s + 3),
               x('aten::mul', 'cpu_op', t + 510, 20),
               launch(t + 515, 10 * s + 4),
               x('void at::native::vectorized_elementwise_kernel',
                 'kernel', t + 520, 80, correlation=10 * s + 4),
               x('aten::copy_', 'cpu_op', t + 640, 110),
               x('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', t + 710,
                 40, correlation=10 * s + 5),
               x('cudaMemcpyAsync', 'cuda_runtime', t + 705, 5,
                 correlation=10 * s + 5)]
    return ev


def write(tmp_path, events):
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events}))
    return str(path)


def test_sums_and_provenance(tmp_path):
    tr = read_chrome_trace(write(tmp_path, card_trace()), 0.002)
    assert tr.kernel('fused_elbo_bwd_kernel') == (2, 300.0)
    assert tr.under_span('gmvae.optimizer') == (2, 160.0)
    assert tr.group('matmul') == (2, 400.0)
    assert tr.copies('HtoD') == (2, 80.0)
    # busy: 200 + 100 + 150 + 80 + 40 a step (the kernels abut)
    assert tr.busy_s() == pytest.approx(2 * 570e-6)
    assert tr.top_ops(1)[0][0].startswith('sm90_xmma_fprop')
    # idle between the merged intervals [20, 470], [520, 600], [710, 750]
    # of each step: 50, 110, then 270 to the next step, 50, 110
    gaps = dict(tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(590e-6)
    assert gaps['aten::copy_'] == pytest.approx(220e-6)   # 600 -> 710


def ctx(tr, kind='train', rows=1024):
    return LayerContext(kind, CFG, rows, tr, 2, 1.0, 40,
                        {'assign_p95_ms': 4.5})


def test_readers(tmp_path):
    tr = read_chrome_trace(write(tmp_path, card_trace()), 0.002)
    c = ctx(tr)
    read = lambda m, cc=c: manifest.reader(m).read(cc)  # noqa: E731
    from portbench.yardstick import bounds
    bwd = bounds.bound_ms(bounds.head_bwd_work(1024, 64, 256, False))[0]
    assert read('head_bwd_roofline') == pytest.approx(
        100 * bwd * 1e3 / 150)
    assert read('optimizer_ms_per_step') == pytest.approx(0.08)
    assert read('conv_gemm_ms_per_step') == pytest.approx(0.2)
    # 570 us busy a step in the trace, 40 steps in a timed second
    assert read('device_idle_pct.train') == pytest.approx(
        100 * (1 - 570e-6 * 40))
    assert 0 < read('mfu_pct.train') < 100
    # an assignment cell's readers find nothing in a training trace
    assert read('h2d_ms_per_req') is None
    assert read('mfu_pct.assign') is None
    a = ctx(tr, 'assign')
    assert read('h2d_ms_per_req', a) == pytest.approx(0.04)
    assert read('head_bwd_roofline', a) is None


def test_a_trace_without_device_events_is_refused(tmp_path):
    host_only = [e for e in card_trace()
                 if e['cat'] not in ('kernel', 'gpu_memcpy')]
    with pytest.raises(TraceRefused, match='no kernel'):
        read_chrome_trace(write(tmp_path, host_only), 0.002)


def test_a_partial_trace_is_refused():
    ev = card_trace()
    kernels = [e for e in ev if e['cat'] == 'kernel']
    ev = [e for e in ev if e not in kernels[2:]]
    with pytest.raises(TraceRefused, match='partial'):
        Trace(ev, 0.002)
