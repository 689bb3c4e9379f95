"""Device ms a step of the GEMMs and convolutions (cuBLAS, cuDNN,
CUTLASS kernels and those launched by matmul and convolution operations:
``yardstick.groups``' matmul group)."""


def read(ctx):
    n, us = ctx.trace.group('matmul')
    if ctx.kind != 'train' or n == 0 or ctx.traced_units == 0:
        return None
    return us * 1e-3 / ctx.traced_units
