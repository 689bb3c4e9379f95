"""Copies between the host and the card (``gpu_memcpy`` operations whose
name holds ``HtoD`` or ``DtoH``) launched under the program's
``gmvae.step`` spans, over the number of those spans: the copies a
training step makes inside a chunk, which is to read nothing back until
its end. Copies from one place on the card to another are left out."""


def _host_copy(op):
    return (op.cat == 'gpu_memcpy' and ('HtoD' in op.name or 'DtoH' in op.name)
            and 'gmvae.step' in op.prov.split('/'))


def read(ctx):
    if ctx.kind != 'train':
        return None
    steps = sum(1 for h in ctx.trace.host if h.name == 'gmvae.step')
    if steps == 0:
        return None
    n, _ = ctx.trace.ops_where(_host_copy)
    return n / steps
