"""The device trace of a run's traced window: ``torch.profiler`` with CPU
and CUDA activity, exported as a chrome trace and read back.

Each device operation (categories ``kernel``, ``gpu_memcpy``,
``gpu_memset``) gets its provenance: the spans (``gmvae.*`` from the
program, ``portbench.*`` from the benchmark) and the innermost PyTorch
operation around the runtime call that launched it, joined through the
trace's correlation ids. A trace of the card with no device operation, or
with fewer than ``MIN_KERNEL_SHARE`` of its kernel launches' kernels, is
refused: the profiler lost device activity, and nothing is read from it.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from portbench.yardstick.groups import classify

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation')
RUNTIME_CATS = ('cuda_runtime', 'cuda_driver')
SPAN_PREFIXES = ('gmvae.', 'portbench.')
MIN_KERNEL_SHARE = 0.95
NAME_CHARS = 96   # a device operation's name as the breakdown gives it


class DevOp(NamedTuple):
    name: str
    cat: str
    ts: float      # us
    dur: float     # us
    prov: str


class HostOp(NamedTuple):
    name: str
    ts: float
    dur: float


class TraceRefused(RuntimeError):
    """The trace cannot be read: device activity is missing."""


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class Trace:
    """Device operations and host operations of one traced window of
    ``window_s`` seconds (the host's clock around it)."""

    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        dev = [e for e in events
               if e.get('ph') == 'X' and e.get('cat') in DEVICE_CATS]
        launches = [e for e in events if e.get('ph') == 'X'
                    and e.get('cat') in RUNTIME_CATS
                    and 'launchkernel' in e.get('name', '').lower()]
        if not dev:
            raise TraceRefused(
                f'no kernel, gpu_memcpy or gpu_memset event in a trace with '
                f'{len(launches)} kernel launches: the profiler lost the '
                f'device activity')
        n_kernels = sum(1 for e in dev if e['cat'] == 'kernel')
        if n_kernels < MIN_KERNEL_SHARE * len(launches):
            raise TraceRefused(
                f'{n_kernels} kernels for {len(launches)} kernel launches: '
                f'a partial trace')
        flows = {(e.get('pid'), e.get('tid'), float(e['ts'])): e['id']
                 for e in events
                 if e.get('cat') == 'ac2g' and e.get('ph') in ('s', 'f')}
        prov, self.host = _provenance(events, flows)
        self.ops = [DevOp(e['name'], e['cat'], float(e['ts']),
                          float(e.get('dur', 0)),
                          prov.get(_correlation(e, flows), ''))
                    for e in dev]

    # -- sums ---------------------------------------------------------
    def busy_s(self) -> float:
        """Seconds in which a device operation ran (the union of their
        intervals)."""
        return sum(e - s for s, e in _merge(
            [(o.ts, o.ts + o.dur) for o in self.ops])) * 1e-6

    def ops_where(self, pred: Callable[[DevOp], bool]) -> Tuple[int, float]:
        """(count, device us) of the operations ``pred`` takes."""
        hits = [o.dur for o in self.ops if pred(o)]
        return len(hits), sum(hits)

    def kernel(self, part: str) -> Tuple[int, float]:
        return self.ops_where(lambda o: o.cat == 'kernel' and part in o.name)

    def under_span(self, span: str) -> Tuple[int, float]:
        return self.ops_where(lambda o: span in o.prov.split('/'))

    def group(self, group: str) -> Tuple[int, float]:
        return self.ops_where(
            lambda o: classify(o.name, o.cat, o.prov) == group)

    def copies(self, direction: str) -> Tuple[int, float]:
        """Copies whose name holds ``direction`` ('HtoD', 'DtoH')."""
        return self.ops_where(
            lambda o: o.cat == 'gpu_memcpy' and direction in o.name)

    # -- the breakdown --------------------------------------------------
    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for o in self.ops:
            key = o.name[:NAME_CHARS]
            tot[key] = tot.get(key, 0.0) + o.dur
        return [[k, v * 1e-6] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle gaps inside the window summed by what the
        host was doing at each gap's middle: the innermost span or PyTorch
        operation there, or 'python' where none was open."""
        busy = _merge([(o.ts, o.ts + o.dur) for o in self.ops])
        gaps = [(0.5 * (a + b), b - a)
                for (_, a), (b, _) in zip(busy[:-1], busy[1:])]
        host = sorted(self.host, key=lambda h: (h.ts, -h.dur))
        tot: Dict[str, float] = {}
        stack: List[HostOp] = []
        i = 0
        for mid, gap in sorted(gaps):
            while i < len(host) and host[i].ts <= mid:
                stack.append(host[i])
                i += 1
            while stack and stack[-1].ts + stack[-1].dur < mid:
                stack.pop()
            label = (stack[-1].name if stack else 'python')[:NAME_CHARS]
            tot[label] = tot.get(label, 0.0) + gap
        return [[k, v * 1e-6] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _correlation(ev: dict, flows: Dict[tuple, int]):
    corr = ev.get('args', {}).get('correlation')
    if corr is None:
        corr = flows.get((ev.get('pid'), ev.get('tid'), float(ev['ts'])))
    return corr


def _provenance(events: List[dict], flows: Dict[tuple, int]):
    """({correlation id: 'span/.../op'} for every runtime call, the host
    operations of the threads that launched device work)."""
    by_thread: Dict[tuple, List[dict]] = {}
    for ev in events:
        if ev.get('ph') == 'X' and ev.get('cat') in HOST_CATS + RUNTIME_CATS:
            by_thread.setdefault((ev.get('pid'), ev.get('tid')),
                                 []).append(ev)
    prov: Dict[int, str] = {}
    host: List[HostOp] = []
    for evs in by_thread.values():
        if not any(e['cat'] in RUNTIME_CATS for e in evs):
            continue
        evs.sort(key=lambda e: (float(e['ts']), -float(e.get('dur', 0))))
        stack: List[dict] = []
        for ev in evs:
            t = float(ev['ts'])
            while stack and float(stack[-1]['ts']) + float(
                    stack[-1].get('dur', 0)) < t:
                stack.pop()
            if ev['cat'] in RUNTIME_CATS:
                corr = _correlation(ev, flows)
                if corr is not None:
                    spans = [e['name'] for e in stack
                             if e['name'].startswith(SPAN_PREFIXES)]
                    ops = [e['name'] for e in stack if e['cat'] == 'cpu_op']
                    prov[corr] = '/'.join(spans + ops[-1:])
            else:
                stack.append(ev)
                host.append(HostOp(ev['name'], t, float(ev.get('dur', 0))))
    return prov, host


def read_chrome_trace(path: str, window_s: float) -> Trace:
    with open(path) as f:
        trace = json.load(f)
    events = trace.get('traceEvents', []) if isinstance(trace, dict) else trace
    return Trace(events, window_s)


def capture(fn: Callable[[], object], sync: Callable[[], None],
            warmup: Callable[[], object]) -> Trace:
    """Run ``warmup`` under the profiler with its records dropped (the
    profiler's own start-up), then ``fn`` recorded, ``sync`` before and
    inside its end; read the trace (written to a temporary file, then
    removed)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    got = []

    def ready(prof):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'trace.json')
            prof.export_chrome_trace(path)
            got.append(read_chrome_trace(path, window[0]))

    window = [0.0]
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        warmup()
        sync()
        prof.step()
        t0 = time.perf_counter()
        fn()
        sync()
        window[0] = time.perf_counter() - t0
        prof.step()
    return got[0]


def span(name: str):
    """A profiler span named ``name`` around the benchmark's calls into a
    layer, recorded only while the profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
