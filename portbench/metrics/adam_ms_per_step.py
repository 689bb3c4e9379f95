"""Device ms a step of the operations launched under the program's
``gmvae.optimizer`` span and outside its ``gmvae.clip`` span (Adam, the
``-lr`` scale and the update of the parameters), over the traced window's
``gmvae.step`` spans. With ``clip_ms_per_step`` it sums to
``optimizer_ms_per_step``."""


def _adam(op):
    spans = op.prov.split('/')
    return 'gmvae.optimizer' in spans and 'gmvae.clip' not in spans


def read(ctx):
    if ctx.kind != 'train':
        return None
    steps = sum(1 for h in ctx.trace.host if h.name == 'gmvae.step')
    n, us = ctx.trace.ops_where(_adam)
    if steps == 0 or n == 0:
        return None
    return us * 1e-3 / steps
