"""The training step's model FLOPs (``yardstick.flops``, counted on the
reference) times the timed window's steps, over the window's time and one
chip's dense bf16 peak (989 TFLOP/s), in percent, a chip."""

from portbench.yardstick import bounds, flops


def read(ctx):
    if ctx.kind != 'train' or ctx.window_units == 0:
        return None
    work = flops.train_step_flops(ctx.config, ctx.rows) * ctx.window_units
    return 100.0 * work / (ctx.window_s * bounds.PEAK_BF16_FLOPS)
