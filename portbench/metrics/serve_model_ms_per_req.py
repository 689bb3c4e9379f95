"""Device ms a request of the operations launched under the program's
``gmvae.serve.run`` span (the exported graph's module), over the traced
window's ``gmvae.serve.call`` spans (one a request)."""


def read(ctx):
    if ctx.kind != 'assign':
        return None
    calls = sum(1 for h in ctx.trace.host if h.name == 'gmvae.serve.call')
    n, us = ctx.trace.under_span('gmvae.serve.run')
    if calls == 0 or n == 0:
        return None
    return us * 1e-3 / calls
