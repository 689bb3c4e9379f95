"""Device idle ms a request inside the program's serving call: the gaps
between the merged intervals of the device's operations (as
``Trace.idle_gaps`` forms them) whose middle lies inside a
``gmvae.serve.call`` span on the host, summed, over the number of those
spans. A traced window's number: the profiler adds host time to every
operation, so the gaps are wider than in an untraced run."""

import bisect


def read(ctx):
    if ctx.kind != 'assign':
        return None
    calls = sorted((h.ts, h.ts + h.dur) for h in ctx.trace.host
                   if h.name == 'gmvae.serve.call')
    if not calls:
        return None
    busy = []
    for s, e in sorted((o.ts, o.ts + o.dur) for o in ctx.trace.ops):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    starts = [s for s, _ in calls]
    idle = 0.0
    for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
        i = bisect.bisect_right(starts, 0.5 * (a + b)) - 1
        if i >= 0 and 0.5 * (a + b) <= calls[i][1]:
            idle += b - a
    return idle * 1e-3 / len(calls)
