"""Device ms a step of the operations launched under the program's
``gmvae.clip`` span (the gradient clip inside the optimizer), over the
traced window's ``gmvae.step`` spans."""


def read(ctx):
    if ctx.kind != 'train':
        return None
    steps = sum(1 for h in ctx.trace.host if h.name == 'gmvae.step')
    n, us = ctx.trace.under_span('gmvae.clip')
    if steps == 0 or n == 0:
        return None
    return us * 1e-3 / steps
