"""Attribution of the training step's device time from a profiler trace,
the counterpart of ``tools/profile_attr.py``.

It traces a STEADY-STATE window of a named config's real training loop
(``Trainer.run_chunk``; one untraced warm-up chunk first, fenced by a host
read of its last ELBO, and the closing fence inside the trace) under
``torch.profiler`` with CPU and CUDA activities, exports the chrome trace,
parses its device events into per-op durations aggregated by name, and
rolls them up into named groups:

    python -m gmvae_tpu_torch.tools.profile_attr mnist_k10       # capture
    python -m gmvae_tpu_torch.tools.profile_attr --parse DIR --steps 100
    python -m gmvae_tpu_torch.tools.profile_attr synthetic_tiny --device cpu

The command line traces chunks of 50 steps (``--set scan_steps=N`` for
others): a trace of mnist_k10's 400-step chunks holds about a million
events a chunk.

Output: one JSON line (``total_device_us``, ``groups_pct``,
``envelope_us``, ``groups_us_per_step``, ``envelope_us_per_step``, and
``async_spans`` when there are any), then a per-op table (``--top N``) on
stderr. On the card the first line is the card's name and power limit.

Accounting, the reference's three event kinds as a CUDA trace has them:

- **body**: the kernels, copies and memsets (chrome-trace categories
  ``kernel``, ``gpu_memcpy``, ``gpu_memset``) on the compute stream, and
  those on other streams that overlap no compute-stream event; grouped
  by ``GROUP_RULES``. Each row's provenance is the aten op that launched
  it, found through the trace's correlation ids (the ``correlation`` arg,
  else the ``ac2g`` flow events), after the program's spans around it
  (``gmvae.*``: ``utils/profiling.span`` lists them).
- **async**: events on other streams that overlap compute-stream work
  (the host-stream copies of the next chunk's batches): reported as
  ``async_spans``, never summed into the groups.
- **the envelope**: the device's span over the window, from the first
  device event's start to the last one's end. Group shares are of the
  envelope, and its shortfall (envelope less the itemized body) is the
  ``unattributed`` group: the device's idle time inside the window.

For a run on the CPU the aten ops' own times (each op's duration less its
child ops') stand in for the device rows, so the tool runs end to end in
the tests. A trace of the card that holds no device event is an error,
never read with the host's times.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import json
import os
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

# op name/category/provenance -> group rules, first match wins (substrings
# of the lower-cased ``name category provenance``); 'elementwise' takes
# every kernel (and on the CPU every leaf op) no earlier rule claims.
# Checked against a real trace's leftover share (PERF.md §5).
GROUP_RULES = [
    ('head_kernel', ('fused_elbo',)),
    ('optimizer', ('gmvae.optimizer',)),
    ('collectives', ('nccl',)),
    ('data_gather', ('gmvae.data_gather',)),
    ('matmul', ('gemm', 'nvjet', 'cutlass', 'fprop', 'dgrad', 'wgrad',
                'xmma', 'cudnn', 'aten::mm', 'aten::addmm', 'aten::bmm',
                'convolution')),
    ('copy_reshape', ('memcpy', 'memset', 'aten::copy_', 'aten::_to_copy',
                      'aten::cat', 'catarraybatched')),
    ('elementwise', ('kernel', 'cpu_op')),
]

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
ASYNC_CAT = 'async'
ENVELOPE_CAT = 'envelope'
SPAN_PREFIX = 'gmvae.'

Row = Tuple[str, str, str, str, str, int, int, str]


def classify(name: str, category: str, provenance: str = '') -> str:
    hay = f'{name} {category} {provenance}'.lower()
    for group, needles in GROUP_RULES:
        if any(n in hay for n in needles):
            return group
    return 'other'


def event_kind(name: str, category: str) -> str:
    """'async' (overlapped work on another stream) / 'envelope' (the
    device's span over the window) / 'body' (device work on the step's
    critical stream)."""
    if category == ASYNC_CAT:
        return 'async'
    if category == ENVELOPE_CAT:
        return 'envelope'
    return 'body'


def _load(path: str) -> dict:
    files = ([path] if os.path.isfile(path) else
             sorted(glob.glob(os.path.join(path, '**', '*.json'),
                              recursive=True)))
    if not files:
        raise SystemExit(f'no chrome trace (*.json) under {path!r}')
    with open(files[-1]) as f:
        return json.load(f)


def _end(ev: dict) -> float:
    return float(ev['ts']) + float(ev.get('dur', 0))


def _correlation(ev: dict, flows: Dict[tuple, int]):
    """An event's correlation id: its ``correlation`` arg, else the id of
    the ``ac2g`` flow event that starts or ends at it."""
    corr = ev.get('args', {}).get('correlation')
    if corr is None:
        corr = flows.get((ev.get('pid'), ev.get('tid'), float(ev['ts'])))
    return corr


def _provenance(events: List[dict], flows: Dict[tuple, int]
                ) -> Dict[int, str]:
    """{correlation id: provenance} for every runtime launch: the
    program's spans around it and the innermost aten op, joined by '/'."""
    by_thread: Dict[tuple, List[dict]] = {}
    for ev in events:
        if ev.get('ph') != 'X':
            continue
        cat = ev.get('cat', '')
        if cat in ('cpu_op', 'user_annotation', 'cuda_runtime',
                   'cuda_driver'):
            by_thread.setdefault((ev.get('pid'), ev.get('tid')), []).append(
                ev)
    prov = {}
    for evs in by_thread.values():
        # intervals in start order, the longer first: a stack of open ones
        evs.sort(key=lambda e: (float(e['ts']), -float(e.get('dur', 0))))
        stack: List[dict] = []
        for ev in evs:
            t = float(ev['ts'])
            while stack and _end(stack[-1]) < t:
                stack.pop()
            if ev['cat'] in ('cuda_runtime', 'cuda_driver'):
                corr = _correlation(ev, flows)
                if corr is None:
                    continue
                spans = [e['name'] for e in stack
                         if e['name'].startswith(SPAN_PREFIX)]
                ops = [e['name'] for e in stack if e['cat'] == 'cpu_op']
                prov[corr] = '/'.join(spans + ops[-1:])
            else:
                stack.append(ev)
    return prov


def _overlaps(starts: List[float], ends: List[float], t0: float,
              t1: float) -> bool:
    """Whether [t0, t1) meets any of the sorted, disjoint intervals."""
    i = bisect.bisect_right(starts, t0) - 1
    for j in (i, i + 1):
        if 0 <= j < len(starts) and starts[j] < t1 and ends[j] > t0:
            return True
    return False


def parse_trace(path: str, on_card: Optional[bool] = None) -> List[Row]:
    """Rows ``(plane, line, name, category, provenance, total_ps, count,
    long)`` aggregated by (stream, name, category, provenance), from a
    chrome trace file or a directory holding one, plus one envelope row.
    Device events only: host events would double-book the dispatch time
    the device view already shows as idle gaps.

    ``on_card``: whether the traced run was on the card; by default, whether
    the trace holds device events or CUDA runtime calls. A card's trace
    with no device events (the profiler lost the device activity) raises,
    never falls back to the host's times, which only a run on the CPU
    parses (``_parse_host``)."""
    trace = _load(path)
    events = (trace.get('traceEvents', []) if isinstance(trace, dict)
              else trace)
    device = [e for e in events
              if e.get('ph') == 'X' and e.get('cat') in DEVICE_CATS]
    runtime = sum(1 for e in events if e.get('ph') == 'X'
                  and e.get('cat') in ('cuda_runtime', 'cuda_driver'))
    if on_card is None:
        on_card = bool(device) or runtime > 0
    if not on_card:
        return _parse_host(events)
    if not device:
        raise RuntimeError(
            f'{path}: a trace of the card with {runtime} CUDA runtime '
            f'calls and no kernel, gpu_memcpy or gpu_memset event: the '
            f'profiler lost the device activity')
    flows = {(e.get('pid'), e.get('tid'), float(e['ts'])): e['id']
             for e in events
             if e.get('cat') == 'ac2g' and e.get('ph') in ('s', 'f')}
    prov = _provenance(events, flows)
    # the compute stream: the one with the most device time
    busy: Dict[tuple, float] = {}
    for e in device:
        key = (e.get('pid'), e.get('tid'))
        busy[key] = busy.get(key, 0.0) + float(e.get('dur', 0))
    main = max(busy, key=busy.get)
    spans = sorted((float(e['ts']), float(e['ts']) + float(e.get('dur', 0)))
                   for e in device if (e.get('pid'), e.get('tid')) == main)
    starts, ends = [s for s, _ in spans], [t for _, t in spans]
    agg: Dict[tuple, List[int]] = {}
    t_first, t_last = float('inf'), float('-inf')
    for e in device:
        t0 = float(e['ts'])
        dur = float(e.get('dur', 0))
        t_first, t_last = min(t_first, t0), max(t_last, t0 + dur)
        key = (e.get('pid'), e.get('tid'))
        cat = e['cat']
        if key != main and _overlaps(starts, ends, t0, t0 + dur):
            cat = ASYNC_CAT
        args = e.get('args', {})
        corr = _correlation(e, flows)
        plane = f"/device:GPU:{args.get('device', e.get('pid'))}"
        line = f"stream {args.get('stream', e.get('tid'))}"
        k = (plane, line, e['name'], cat, prov.get(corr, ''))
        tot = agg.setdefault(k, [0, 0])
        tot[0] += int(round(dur * 1e6))   # us -> ps
        tot[1] += 1
    rows: List[Row] = [(*k, tot, n, '') for k, (tot, n) in agg.items()]
    rows.append(('/device:GPU', 'window', 'device window', ENVELOPE_CAT, '',
                 int(round((t_last - t_first) * 1e6)), 1, ''))
    return rows


def _parse_host(events: List[dict]) -> List[Row]:
    """The CPU's stand-in: each aten op's own time (its duration less its
    child ops'), with the training step's spans around it as provenance,
    and the ops' span as the envelope."""
    by_thread: Dict[tuple, List[dict]] = {}
    for ev in events:
        if ev.get('ph') == 'X' and ev.get('cat') in ('cpu_op',
                                                     'user_annotation'):
            by_thread.setdefault((ev.get('pid'), ev.get('tid')), []).append(
                ev)
    agg: Dict[tuple, List[int]] = {}
    t_first, t_last = float('inf'), float('-inf')
    for key, evs in by_thread.items():
        evs.sort(key=lambda e: (float(e['ts']), -float(e.get('dur', 0))))
        stack: List[dict] = []
        ops = []
        for ev in evs:
            t = float(ev['ts'])
            while stack and _end(stack[-1]) <= t:
                stack.pop()
            if ev['cat'] == 'cpu_op':
                dur = float(ev.get('dur', 0))
                outer = [op for op in stack if op['cat'] == 'cpu_op']
                if outer:
                    outer[-1]['_self'] -= dur
                else:
                    t_first, t_last = min(t_first, t), max(t_last, t + dur)
                ev['_self'] = dur
                spans = [e['name'] for e in stack
                         if e['name'].startswith(SPAN_PREFIX)]
                ops.append((ev, '/'.join(spans)))
            stack.append(ev)
        for ev, spans in ops:
            k = ('/host:CPU', f'thread {key[1]}', ev['name'], 'cpu_op',
                 spans)
            tot = agg.setdefault(k, [0, 0])
            tot[0] += int(round(max(ev['_self'], 0.0) * 1e6))
            tot[1] += 1
    rows: List[Row] = [(*k, tot, n, '') for k, (tot, n) in agg.items()]
    if agg:
        rows.append(('/host:CPU', 'window', 'host window', ENVELOPE_CAT, '',
                     int(round((t_last - t_first) * 1e6)), 1, ''))
    return rows


def attribute(rows, top: int = 25, steps: Optional[int] = None) -> dict:
    """Group rollup + stderr per-op table from ``parse_trace`` rows.

    Async spans and the envelope are split out of the group sums (module
    docstring, "Accounting"); group shares are of the envelope when one
    exists, with the itemization shortfall as 'unattributed'. With
    ``steps`` (training steps inside the traced window) each group also
    gets a per-step microsecond cost."""
    body = [r for r in rows if event_kind(r[2], r[3]) == 'body']
    envelope = sum(r[5] for r in rows
                   if event_kind(r[2], r[3]) == 'envelope')
    async_ps = sum(r[5] for r in rows if event_kind(r[2], r[3]) == 'async')
    async_n = sum(r[6] for r in rows if event_kind(r[2], r[3]) == 'async')
    body_total = sum(r[5] for r in body)
    groups: Dict[str, int] = {}
    for _, _, name, cat, prov, tot, _, _ in body:
        g = classify(name, cat, prov)
        groups[g] = groups.get(g, 0) + tot
    if envelope > body_total:
        groups['unattributed'] = envelope - body_total
    denom = max(envelope, body_total) or 1
    table = sorted(rows, key=lambda r: -r[5])[:top]
    print(f'{"op":44.44} {"kind":8.8} {"category":14.14} '
          f'{"provenance":30.30} {"us":>10} {"n":>6} {"share":>7}',
          file=sys.stderr)
    for _, _, name, cat, prov, tot, cnt, long in table:
        kind = event_kind(name, cat)
        print(f'{name:44.44} {kind:8.8} {cat:14.14} {prov[-30:]:30.30} '
              f'{tot / 1e6:10.1f} {cnt:6d} '
              f'{100 * tot / denom:6.2f}%', file=sys.stderr)
        if long and kind == 'body':
            print(f'    {long[:150]}', file=sys.stderr)
    out = {
        'total_device_us': round(body_total / 1e6, 1),
        'groups_pct': {g: round(100 * t / denom, 2)
                       for g, t in sorted(groups.items(),
                                          key=lambda kv: -kv[1])},
    }
    if envelope:
        out['envelope_us'] = round(envelope / 1e6, 1)
    if async_ps:
        out['async_spans'] = {'us': round(async_ps / 1e6, 1),
                              'events': async_n, 'overlapped': True}
    if steps:
        out['steps'] = steps
        out['groups_us_per_step'] = {
            g: round(t / 1e6 / steps, 2)
            for g, t in sorted(groups.items(), key=lambda kv: -kv[1])}
        if envelope:
            out['envelope_us_per_step'] = round(envelope / 1e6 / steps, 2)
    return out


def capture_trainer(trainer, state, logdir: str, chunks: int = 5):
    """Trace ``chunks`` steady-state chunks of ``trainer`` from ``state``:
    one untraced warm-up chunk first, fenced by a host read of its last
    ELBO; the closing fence inside the trace. Returns (the exported
    trace's path, the traced steps)."""
    from torch.profiler import ProfilerActivity, profile

    steps = trainer.cfg.scan_steps * (chunks + 1)
    it = trainer.iter_chunk_plans(int(state.step), int(state.step) + steps)
    _, idx = next(it)
    state, m = trainer.run_chunk(state, idx)
    float(m['elbo'][-1])                           # warm-up fence
    activities = [ProfilerActivity.CPU]
    if trainer.device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    traced = 0
    with profile(activities=activities) as prof:
        for s, idx in it:
            state, m = trainer.run_chunk(state, idx)
            traced += s
        float(m['elbo'][-1])                       # in-trace closing fence
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, 'trace.json')
    prof.export_chrome_trace(path)
    return path, traced


def capture(config_name: str, logdir: str, chunks: int = 5,
            overrides: Optional[dict] = None, device='cuda'):
    """Trace ``chunks`` steady-state training chunks of a named config
    (chunks of its ``scan_steps``, at least 50)."""
    from gmvae_tpu_torch import configs, training

    cfg = configs.get_config(config_name, **(overrides or {})).replace(
        eval_every=10**9, ckpt_every=0)
    if cfg.scan_steps < 50:
        cfg = cfg.replace(scan_steps=50)
    trainer = training.Trainer(cfg, device=device)
    return capture_trainer(trainer, trainer.init_state(), logdir, chunks)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('config', nargs='?', default='mnist_k10')
    ap.add_argument('--parse', metavar='PATH', default=None,
                    help='skip capture; attribute an existing trace')
    ap.add_argument('--logdir', default=None)
    ap.add_argument('--chunks', type=int, default=5)
    ap.add_argument('--top', type=int, default=25)
    ap.add_argument('--steps', type=int, default=None,
                    help='with --parse: steps inside the traced window, '
                         'for the per-step us rollup')
    ap.add_argument('--set', dest='overrides', action='append', default=[],
                    metavar='key=value')
    ap.add_argument('--device', default='cuda',
                    help="where to train: 'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    steps = args.steps
    card = on_card = None
    if args.parse:
        path = args.parse
    else:
        from gmvae_tpu_torch import configs
        from gmvae_tpu_torch.tools.reproduce_baselines import device_or_exit
        from gmvae_tpu_torch.utils.profiling import card_line
        device = device_or_exit(args.device)  # on the card: its line first
        on_card = device.type == 'cuda'
        card = card_line() if on_card else None
        overrides = configs.parse_overrides(args.overrides)
        overrides.setdefault('scan_steps', 50)
        path, steps = capture(
            args.config, args.logdir or tempfile.mkdtemp(prefix='trace_'),
            chunks=args.chunks, overrides=overrides, device=device)
        print(f'trace: {path}', file=sys.stderr)
    out = attribute(parse_trace(path, on_card), top=args.top, steps=steps)
    out['config'] = None if args.parse else args.config
    if card:
        out['card'] = card
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
