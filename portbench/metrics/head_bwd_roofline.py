"""The head backward kernel's share of its roofline: the least time
for its work at the cell's (B, K, D) (``yardstick.bounds``) over its
device time a launch in the traced window."""

from portbench.yardstick import bounds


def read(ctx):
    n, us = ctx.trace.kernel('fused_elbo_bwd_kernel')
    if ctx.kind != 'train' or n == 0:
        return None
    cfg = ctx.config
    work = bounds.head_bwd_work(ctx.rows, cfg['n_components'],
                                cfg['latent_dim'], streamed=False)
    return 100.0 * bounds.bound_ms(work)[0] * 1e3 / (us / n)
