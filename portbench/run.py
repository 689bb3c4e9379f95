"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A run is one fresh process on the card(s) the cell asks for. It makes its
inputs and weights from ``--seed``, sets the program up and warms up the
cell's shapes, measures for ``--seconds`` seconds, checks what the timed
path produced against the plain reference in ``portbench/reference/``, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace 1``
its per-layer metrics, read from a further traced window), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s`` of the traced window,
and a ``breakdown``), and last ``checks``: each number compared with its
limit, which also end standard error.

Without a card, with fewer cards than the cell asks for, or when ``jax``,
``jaxlib``, ``flax`` or the JAX package is loaded once the window has
closed, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(REPO, '.portbench_cache')
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE, 'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
os.environ['CUDA_CACHE_PATH'] = os.path.join(CACHE, 'nv')
os.environ['USE_FLAX'] = '0'
sys.path.insert(0, REPO)

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'gmvae_tpu')


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``gmvae_tpu_torch`` is not ``gmvae_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.')[0] in FORBIDDEN)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line() -> str:
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'nvidia-smi: no reading'


def card(chips: int):
    """The device a run uses: 'cuda' where the host has ``chips`` cards;
    None, with the reason on standard error, where it has fewer."""
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f'error: the cell needs {chips} CUDA device(s), this host '
              f'has {have}', file=sys.stderr)
        return None
    print(f'card: {card_line()}', file=sys.stderr)
    return 'cuda'


def card_kind(device) -> str:
    import torch
    return torch.cuda.get_device_name(device)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from portbench.core import manifest

    cell = manifest.find_cell(manifest.load_manifest(), args.workload)
    device = card(cell.chips)
    if device is None:
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    generator = importlib.import_module(
        'portbench.generators.' + cell.traffic['generator'])
    out = generator.run(cell, args.seed, args.seconds, bool(args.trace),
                        device, T_START)

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            v = manifest.reader(m['name']).read(out.layers)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        for m in cell.end_to_end:
            metrics[m['name']] = {'value': out.end_to_end[m['name']],
                                  'unit': m['unit']}
    dev = {'platform': 'gpu', 'kind': card_kind(device),
           'count': cell.chips, 'memory_peak_bytes': out.memory_peak_bytes}
    result = {'correct': all(c.ok for c in out.checks),
              'attempted': out.attempted, 'failed': out.failed,
              'metrics': metrics, 'device': dev}
    if args.trace:
        tr = out.layers.trace
        dev['busy_s'] = tr.busy_s()
        dev['window_s'] = tr.window_s
        result['breakdown'] = {'device_ops': tr.top_ops(),
                               'idle_gaps': tr.idle_gaps()}
    result['checks'] = {c.name: {'value': c.value, 'limit': c.limit}
                        for c in out.checks}

    bad = forbidden_modules()
    if bad:
        print(f'error: loaded once the window closed: {bad}',
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for c in out.checks:
        print(f'check {c.name} {c.value!r} limit {c.limit!r} '
              f'{"ok" if c.ok else "FAILED"}', file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
