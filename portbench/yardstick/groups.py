"""How a device operation is named to a layer: rules over the lower-cased
``name category provenance`` of a device event, first match wins. The
provenance is the program's spans around the launch and the PyTorch
operation that launched it. A frozen copy of the port's profiler grouping
(its ``tools/profile_attr.py``), owned by the benchmark."""

from __future__ import annotations

GROUP_RULES = (
    ('head_kernel', ('fused_elbo',)),
    ('optimizer', ('gmvae.optimizer',)),
    ('collectives', ('nccl',)),
    ('data_gather', ('gmvae.data_gather',)),
    ('matmul', ('gemm', 'nvjet', 'cutlass', 'fprop', 'dgrad', 'wgrad',
                'xmma', 'cudnn', 'aten::mm', 'aten::addmm', 'aten::bmm',
                'convolution')),
    ('copy_reshape', ('memcpy', 'memset', 'aten::copy_', 'aten::_to_copy',
                      'aten::cat', 'catarraybatched')),
    ('elementwise', ('kernel', 'cpu_op')),
)


def classify(name: str, category: str, provenance: str = '') -> str:
    hay = f'{name} {category} {provenance}'.lower()
    for group, needles in GROUP_RULES:
        if any(n in hay for n in needles):
            return group
    return 'other'
