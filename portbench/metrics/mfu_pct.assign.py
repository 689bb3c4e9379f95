"""Cluster assignment's model FLOPs (``yardstick.flops``: the encoder's
forward and the cluster-logit head, counted on the reference) times the
timed window's images, over the window's time and one chip's dense bf16
peak (989 TFLOP/s), in percent."""

from portbench.yardstick import bounds, flops


def read(ctx):
    if ctx.kind != 'assign' or ctx.window_units == 0:
        return None
    work = flops.assign_flops(ctx.config, ctx.rows) * ctx.window_units
    return 100.0 * work / (ctx.window_s * bounds.PEAK_BF16_FLOPS)
