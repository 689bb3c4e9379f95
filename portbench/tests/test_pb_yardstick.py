"""The frozen yardstick against the port's own formulas as they stand."""

import json
import os

import pytest

from portbench.yardstick import bounds, flops, groups

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('b,k,d', [(1024, 64, 256), (128, 10, 10),
                                   (128, 20, 128), (2, 1, 10)])
@pytest.mark.parametrize('streamed', [False, True])
def test_head_formulas_equal_the_ports(b, k, d, streamed):
    from gmvae_tpu_torch.ops.kernels import bounds as port
    for ours, theirs in ((bounds.head_fwd_work, port.head_fwd_work),
                         (bounds.head_bwd_work, port.head_bwd_work)):
        w = ours(b, k, d, streamed)
        assert tuple(w) == tuple(theirs(b, k, d, streamed))
        assert bounds.bound_ms(w) == port.bound_ms(port.Work(*w))
    assert (bounds.PEAK_BYTES, bounds.PEAK_F32_FLOPS,
            bounds.PEAK_BF16_FLOPS) == (port.PEAK_BYTES,
                                        port.PEAK_F32_FLOPS,
                                        port.PEAK_BF16_FLOPS)


@pytest.mark.parametrize('row', [
    ('fused_elbo_bwd_kernel(gmvae::HeadIn)', 'kernel', ''),
    ('void at::native::vectorized_elementwise_kernel', 'kernel',
     'gmvae.optimizer/aten::mul'),
    ('ncclDevKernel_AllReduce_Sum_f32_RING_LL', 'kernel', ''),
    ('void at::native::index_elementwise_kernel', 'kernel',
     'gmvae.data_gather/aten::index'),
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16', 'kernel', ''),
    ('void at::native::elementwise_kernel', 'kernel', 'aten::convolution'),
    ('Memcpy HtoD (Pageable -> Device)', 'gpu_memcpy', ''),
    ('void at::native::reduce_kernel', 'kernel', 'aten::sum'),
    ('aten::add', 'cpu_op', ''),
    ('mystery', 'other', ''),
])
def test_grouping_equals_profile_attr(row):
    from gmvae_tpu_torch.tools import profile_attr
    assert groups.classify(*row) == profile_attr.classify(*row)


def test_train_flops_by_hand():
    """celeba_dp16 at 1,024 rows: the convs' forward counted by hand, the
    backward twice that but the first conv's input gradient, the GEMMs,
    and the head kernels' operations."""
    with open(os.path.join(HERE, 'configs', 'celeba_dp16.json')) as f:
        cfg = json.load(f)
    b = 1024
    enc = [(3, 64, 32), (64, 128, 16), (128, 256, 8), (256, 512, 4)]
    conv = sum(2 * b * o * o * ci * co * 16 for ci, co, o in enc)
    dec = [(512, 256, 4), (256, 128, 8), (128, 64, 16), (64, 6, 32)]
    convt = sum(2 * b * i * i * ci * co * 16 for ci, co, i in dec)
    first_dx = 2 * b * 32 * 32 * 3 * 64 * 16
    fwd = conv + convt
    gemm_fwd = 2 * b * (8192 * 512 + 512 * (64 + 2 * 64 * 256)
                        + 256 * 8192)
    head = (bounds.head_fwd_work(b, 64, 256, False).flops
            + bounds.head_bwd_work(b, 64, 256, False).flops)
    assert flops.train_step_flops(cfg, b) == (3 * fwd - first_dx
                                              + 3 * gemm_fwd + head)


def test_assign_flops_by_hand():
    with open(os.path.join(HERE, 'configs', 'celeba_dp16.json')) as f:
        cfg = json.load(f)
    b = 1024
    enc = [(3, 64, 32), (64, 128, 16), (128, 256, 8), (256, 512, 4)]
    conv = sum(2 * b * o * o * ci * co * 16 for ci, co, o in enc)
    assert flops.assign_flops(cfg, b) == conv + 2 * b * (8192 * 512
                                                         + 512 * 64)
