"""Device time by kernel, from ``torch.profiler``'s trace of the card;
the program's named spans at its layer boundaries."""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import tempfile
import time
from typing import Callable, Dict, Tuple

import torch


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them
    (``NVIDIA H100 80GB HBM3, 700.00 W``): every time on the card is read
    beside them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# what ``span`` hands back while the profiler is off: one object, entered
# and left any number of times
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` span named ``name`` while the profiler records,
    else one shared null context (one flag check a call). Its ranges land
    in the profiler's trace beside the device operations they launch, on
    the same clock; ``portbench/core/trace.py`` joins the two, and
    ``tools/profile_attr.py`` groups the kernels by them. The program's
    spans, and the benchmark's metric that reads each
    (``portbench/metrics/<metric>.py``):

    - ``gmvae.step`` (``Trainer.run_chunk``, one step: the gather and
      ``train_step``): ``host_copies_per_step``, and the steps every
      ``*_per_step`` metric below divides by;
    - ``gmvae.data_gather`` (the gather, and ``train_step``'s
      ``preprocess_batch``): ``data_gather_ms_per_step``;
    - ``gmvae.optimizer`` (``train_step``: clip, Adam, the ``-lr`` scale
      and the update of the parameters): ``optimizer_ms_per_step``,
      ``adam_ms_per_step``;
    - ``gmvae.clip`` (``make_optimizer``'s clip, inside
      ``gmvae.optimizer``): ``clip_ms_per_step``;
    - ``gmvae.serve.call`` (``serving.Program.__call__``, its whole body):
      ``serve_idle_ms_per_req``, and the requests
      ``serve_model_ms_per_req`` divides by;
    - ``gmvae.serve.run`` (inside it, the exported graph's module):
      ``serve_model_ms_per_req``."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def profile_device(fn: Callable[[], object]
                   ) -> Tuple[float, float, int, Dict[str, Tuple[int, float]]]:
    """Run ``fn`` once under the profiler: (wall s, device-busy s, number of
    device operations, {kernel name: (launches, device us)}). Device-busy
    is the sum of the kernels', copies' and memsets' durations."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    by_name: Dict[str, Tuple[int, float]] = {}
    for ev in trace.get('traceEvents', []):
        if ev.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset'):
            n, us = by_name.get(ev['name'], (0, 0.0))
            by_name[ev['name']] = (n + 1, us + float(ev.get('dur', 0.0)))
    busy = sum(us for _, us in by_name.values()) * 1e-6
    return wall, busy, sum(n for n, _ in by_name.values()), by_name


def device_us(by_name: Dict[str, Tuple[int, float]], *parts: str
              ) -> Tuple[int, float]:
    """(launches, device us) summed over the kernels whose name holds any
    of ``parts``."""
    hits = [v for k, v in by_name.items() if any(p in k for p in parts)]
    return sum(n for n, _ in hits), sum(us for _, us in hits)
