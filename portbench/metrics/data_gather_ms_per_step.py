"""Device ms a step of the operations launched under the program's
``gmvae.data_gather`` spans (the gather of the step's rows from the train
set on the card, and their conversion to the model's input), over the
traced window's ``gmvae.step`` spans."""


def read(ctx):
    if ctx.kind != 'train':
        return None
    steps = sum(1 for h in ctx.trace.host if h.name == 'gmvae.step')
    n, us = ctx.trace.under_span('gmvae.data_gather')
    if steps == 0 or n == 0:
        return None
    return us * 1e-3 / steps
