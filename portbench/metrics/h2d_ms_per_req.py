"""Device ms a request of the host-to-device copies (the images going in)
in the traced window."""


def read(ctx):
    n, us = ctx.trace.copies('HtoD')
    if ctx.kind != 'assign' or n == 0 or ctx.traced_units == 0:
        return None
    return us * 1e-3 / ctx.traced_units
