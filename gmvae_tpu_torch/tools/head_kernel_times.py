"""Device time of the head kernels, this build against another, in turns.

    python -m gmvae_tpu_torch.tools.head_kernel_times [--against DIR]

For each shape (B, K, D) of ``SHAPES`` (soft y, in-kernel threefry noise),
the forward and the backward kernel, launched bare with the wrapper's
checked arguments:
- ``device_us``: the profiler's device time over ``LAUNCHES`` back-to-back
  calls, divided by the calls (every kernel a call launches: the backward
  of a build that sums the prior gradients in a second kernel counts both);
- ``event_us``: CUDA events around the same calls, over the calls (at small
  shapes this is the host's launch rate, not the device's);
- ``bound_us``: the least time for the function's bytes at 3.35 TB/s;
and ``floor_device_us``, the device time of a trivial launch on the card
(the threefry check kernel on 2,560 counters): what any launch costs.

With ``--against DIR`` (the root of another checkout, holding its own
``gmvae_tpu_torch``) each build is measured in a process of its own, in the
order this, other, other, this, on the one card; each build compiles its own
kernels into its own ``_build`` directory. Prints one JSON line per build
and turn, then the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPES = ((128, 10, 10), (128, 20, 128), (128, 64, 256))
LAUNCHES = 200
PEAK_BYTES = 3.35e12
KEY = (1394159668, 1590028285)
TAU = 0.8


def _inputs(b, k, d, seed, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    prior = (t(rng.normal(size=k)), t(rng.normal(size=(k, d))),
             t(rng.uniform(-1, 1, size=(k, d))))
    kl, qm, qlv = (t(2 * rng.normal(size=(b, k))),
                   t(rng.normal(size=(b, k, d))),
                   t(rng.uniform(-3, 1, size=(b, k, d))))
    cs = np.zeros((b, 8))
    cs[:, :5] = rng.normal(size=(b, 5))
    return kl, qm, qlv, prior, (t(cs), t(rng.normal(size=(b, d))),
                                t(rng.normal(size=(b, k))))


def _times(launch, args):
    """(device us, event us) a call over LAUNCHES bare calls."""
    import torch
    from gmvae_tpu_torch.utils.profiling import profile_device
    for _ in range(10):
        launch(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    events = []
    for _ in range(3):
        start.record()
        for _ in range(LAUNCHES):
            launch(*args)
        end.record()
        end.synchronize()
        events.append(1e3 * start.elapsed_time(end) / LAUNCHES)
    _, busy, _, _ = profile_device(
        lambda: [launch(*args) for _ in range(LAUNCHES)])
    return 1e6 * busy / LAUNCHES, statistics.median(events)


def measure():
    """One JSON object: this process's build at every shape."""
    import torch
    from gmvae_tpu_torch.elbo import MixturePrior
    from gmvae_tpu_torch.ops.kernels import _build, fused_elbo, fused_elbo_bwd
    dev = torch.device('cuda', 0)
    lib = _build.library()
    rows = []
    with torch.no_grad():
        for i, (b, k, d) in enumerate(SHAPES):
            kl, qm, qlv, prior, (cs, cz, cy) = _inputs(b, k, d, i, dev)
            fargs, _ = fused_elbo.launch_args(KEY, kl, qm, qlv,
                                              MixturePrior(*prior), TAU,
                                              False, None)
            bargs, _ = fused_elbo_bwd.launch_args(KEY, kl, qm, qlv, *prior,
                                                  TAU, False, cs, cz, cy)
            f_dev, f_ev = _times(lib.gmvae_fused_elbo_fwd, fargs)
            b_dev, b_ev = _times(lib.gmvae_fused_elbo_bwd, bargs)
            kd = k * d
            f_bytes = 4 * (b * k + 2 * b * kd + k + 2 * kd
                           + b * d + b * k + 8 * b)
            b_bytes = 4 * (b * k + 2 * b * kd + k + 2 * kd
                           + b * d + b * k + 8 * b
                           + b * k + 2 * b * kd + k + 2 * kd)
            rows.append(dict(shape=[b, k, d],
                             fwd_device_us=f_dev, fwd_event_us=f_ev,
                             fwd_bound_us=1e6 * f_bytes / PEAK_BYTES,
                             bwd_device_us=b_dev, bwd_event_us=b_ev,
                             bwd_bound_us=1e6 * b_bytes / PEAK_BYTES))
        c = torch.arange(2560, dtype=torch.int32, device=dev)
        x0, x1 = torch.empty_like(c), torch.empty_like(c)
        floor, _ = _times(lib.gmvae_threefry_grid,
                          (1, 2, c.data_ptr(), c.data_ptr(), x0.data_ptr(),
                           x1.data_ptr(), 2560,
                           torch.cuda.current_stream(dev).cuda_stream))
    return dict(source=os.path.dirname(os.path.dirname(_build.CSRC)),
                floor_device_us=floor, rows=rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--against', help='root of another checkout')
    ap.add_argument('--root', help=argparse.SUPPRESS)  # a measuring child
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
        print(json.dumps(measure()), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print('head_kernel_times: no CUDA device', file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    order = ([here, args.against, args.against, here] if args.against
             else [here])
    for turn, root in enumerate(order):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--root', root], check=True,
                             stdout=subprocess.PIPE, text=True).stdout
        result = json.loads(out.strip().splitlines()[-1])
        result['turn'] = turn
        print(json.dumps(result), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
