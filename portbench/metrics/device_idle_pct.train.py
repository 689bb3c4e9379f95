"""The share of the timed training window in which no kernel, copy or
memset ran on the card, in percent: one less the device-busy seconds a
step (the union of the device's operations in the traced window, over its
steps) times the timed window's steps, over the timed window. The traced
window itself runs slower, as the profiler takes host time."""


def read(ctx):
    if ctx.kind != 'train' or ctx.traced_units == 0:
        return None
    busy = ctx.trace.busy_s() / ctx.traced_units * ctx.window_units
    return 100.0 * (1.0 - busy / ctx.window_s)
