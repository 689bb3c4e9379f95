"""Device ms a step of the operations launched under the program's
``gmvae.optimizer`` span (the clip and Adam)."""


def read(ctx):
    n, us = ctx.trace.under_span('gmvae.optimizer')
    if ctx.kind != 'train' or n == 0 or ctx.traced_units == 0:
        return None
    return us * 1e-3 / ctx.traced_units
