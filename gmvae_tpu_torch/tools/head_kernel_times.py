"""Device time of the head kernels, this build against another, in turns.

    python -m gmvae_tpu_torch.tools.head_kernel_times [--against DIR]

For each shape (B, K, D) of ``SHAPES`` (soft y, in-kernel threefry noise),
the forward and the backward kernel, and for each (H, K, D, B) of
``WIDE_SHAPES`` the wide kernel, launched bare with the wrapper's checked
arguments:
- ``device_us``: the profiler's device time over ``LAUNCHES`` back-to-back
  calls, divided by the calls (every kernel a call launches: the backward
  of a build that sums the prior gradients in a second kernel counts both);
- ``event_us``: CUDA events around the same calls, over the calls (at small
  shapes this is the host's launch rate, not the device's);
- ``bound_us``: the least time for the function's bytes at 3.35 TB/s; for
  the wide kernel ``bound_f32_us`` (its bytes against its float32
  operations at 67 TFLOP/s) and ``bound_tf32_us`` (the projections as
  three TF32 products each at 495 TFLOP/s, the head's float32 operations,
  the bytes: the largest);
the head-boundary ablation's device us a step, narrow and wide, at its
two shapes (``boundary``: ``bench_head_boundary.bench``, 100 timed steps,
20 profiled); and ``floor_device_us``, the device time of a trivial launch
on the card (the threefry check kernel on 2,560 counters): what any launch
costs.

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
# the wide kernel (H, K, D, B): the ablation's two shapes and a ragged batch
WIDE_SHAPES = ((512, 10, 10, 128), (512, 20, 128, 128), (512, 10, 10, 37))
LAUNCHES = 200
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12    # outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # dense, the tensor cores
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


def wide_bounds_us(h, k, d, b):
    """The wide head's least times: ``(f32_us, f32_by, tf32_us, tf32_by)``.
    Bytes: feats, the weights, biases and the prior read once, z, y, the
    scalars and k_logits written once. ``f32`` counts the projections'
    2*B*H*(K+2N) and the head's float32 operations at 67 TFLOP/s; ``tf32``
    the projections as three TF32 products each (3xTF32) at 495 TFLOP/s
    beside the head's float32 operations, the larger of the two."""
    n = k * d
    cols = k + 2 * n
    floats = (b * h + h * cols + cols + k + 2 * n
              + b * d + b * k + 8 * b + b * k)
    proj = 2 * b * h * cols
    head = b * (22 * k * d + 14 * d + 25 * k)
    t_bytes = 1e6 * 4 * floats / PEAK_BYTES
    t_f32 = 1e6 * (proj + head) / PEAK_F32_FLOPS
    t_tc = max(1e6 * 3 * proj / PEAK_TF32_FLOPS, 1e6 * head / PEAK_F32_FLOPS)
    return (max(t_bytes, t_f32), 'bytes' if t_bytes >= t_f32 else
            'operations', max(t_bytes, t_tc),
            'bytes' if t_bytes >= t_tc else 'operations')


def _wide_inputs(h, k, d, b, seed, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    n = k * d
    t = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (scale * rng.normal(size=s)).astype(np.float32)).to(dev)
    return [t(b, h), t(h, k, scale=0.05), t(k, scale=0.1),
            t(h, n, scale=0.05), t(n, scale=0.1), t(h, n, scale=0.02),
            t(n, scale=0.1), t(k), t(n), t(n, scale=0.5)]


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
    from gmvae_tpu_torch.ops.kernels import (_build, fused_elbo,
                                             fused_elbo_bwd, wide_head)
    from gmvae_tpu_torch.tools import bench_head_boundary as ablation
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
        wide = []
        for i, (h, k, d, b) in enumerate(WIDE_SHAPES):
            ins = _wide_inputs(h, k, d, b, 10 + i, dev)
            wargs, _ = wide_head.launch_args(KEY, TAU, *ins, k, d)
            w_dev, w_ev = _times(lib.gmvae_wide_head_fwd, wargs)
            f32, f32_by, tf32, tf32_by = wide_bounds_us(h, k, d, b)
            wide.append(dict(shape=[h, k, d, b], device_us=w_dev,
                             event_us=w_ev, bound_f32_us=f32,
                             bound_f32_by=f32_by, bound_tf32_us=tf32,
                             bound_tf32_by=tf32_by))
        c = torch.arange(2560, dtype=torch.int32, device=dev)
        x0, x1 = torch.empty_like(c), torch.empty_like(c)
        floor, _ = _times(lib.gmvae_threefry_grid,
                          (1, 2, c.data_ptr(), c.data_ptr(), x0.data_ptr(),
                           x1.data_ptr(), 2560,
                           torch.cuda.current_stream(dev).cuda_stream))
    boundary = []
    for name, h, k, d, b in ablation.SHAPES:
        row = {'shape': name}
        for variant in ('narrow', 'wide'):
            r = ablation.bench(getattr(ablation, 'head_loss_' + variant), h,
                               k, d, b, steps=100, device=dev)
            row[variant + '_device_us_per_step'] = r['device_us_per_step']
        boundary.append(row)
    return dict(source=os.path.dirname(os.path.dirname(_build.CSRC)),
                floor_device_us=floor, rows=rows, wide=wide,
                boundary=boundary)


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
