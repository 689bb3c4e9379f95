"""Variants of the wide kernel, timed beside it on the card.

    python -m gmvae_tpu_torch.tools.wide_variants [NAME,...] [--out DIR]
    python -m gmvae_tpu_torch.tools.wide_variants --rates [--out DIR]

A variant is ``csrc/wide_head_fwd.cu`` with a few source edits
(``VARIANTS``): a design step to try, or a phase taken out to see what it
costs. Each is built into its own copy of the package under ``--out``
(default ``runs/wide_variants``, git-ignored), all builds started together,
then measured in a process of its own, one after another, on the one card:
at each of ``SHAPES`` (H, K, D, B) the cluster size its launch takes, the
largest error of k_logits (relative to max(|plain|, 1)) and of z against
the plain version, and the profiler's device us a launch over 200 bare
launches, three times. ``kernel`` (no edits) adds the narrow path's device
us (three torch.matmul + the head kernel). A variant that takes a phase
out gives wrong outputs, and its errors say so. Prints one JSON row per
variant, then the card's name and power limit.

``--rates`` instead builds and runs ``card_rates.cu`` (this directory): the
card's mma.sync throughput and one SM's read rate from L2.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
SOURCE = os.path.join('csrc', 'wide_head_fwd.cu')
SHAPES = ((512, 20, 128, 16), (512, 20, 128, 128), (512, 10, 10, 128))
KEY = (7, 9)
TAU = 0.8

_NO_COPY = [('      if (s < n_stages) issue(s);\n', '      if (s < 0) issue(s);\n'),
            ('      if (s + kStages - 1 < n_stages) issue(s + kStages - 1);\n',
             '      if (s + kStages - 1 < 0) issue(s + kStages - 1);\n')]
_K_LOOP = '      for (int kk = 0; kk < hk; kk += 8) {'
VARIANTS = {
    'kernel': [],
    # phases taken out
    'no_copy': _NO_COPY,
    'copy_only': [(_K_LOOP,
                   '      for (int kk = 0; kk < hk && p.C < 0; kk += 8) {')],
    'no_head': [('  cluster.sync();  // every rank\'s projections are in its '
                 'shared memory\n', '  cluster.sync();\n  if (p.C > 0) return;\n')],
    'no_proj': [('  for (int pc = 0; pc < nv; pc += p.pass) {',
                 '  for (int pc = 0; pc < nv && p.C < 0; pc += p.pass) {')],
    'one_mma': [('          mma_tf32(small[f], ah, bl0, bl1);\n'
                 '          mma_tf32(small[f], al, bh0, bh1);\n', '')],
    # design steps
    'cvt_rna': [('  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n'
                 '  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;',
                 '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
                 '  const float r = x - __uint_as_float(hi);\n'
                 '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));')],
    'no_unroll': [('#pragma unroll 4\n' + _K_LOOP, _K_LOOP)],
    'three_stages': [('constexpr int kStages = 2;', 'constexpr int kStages = 3;'),
                     ('constexpr int kStageFloats = 12288;',
                      'constexpr int kStageFloats = 6144;')],
    'one_block_an_sm': [('__launch_bounds__(32 * kWideWarps, 2)',
                         '__launch_bounds__(32 * kWideWarps, 1)')],
}


def make(name: str, out: str) -> str:
    """A copy of the package with the variant's edits: its root."""
    root = os.path.join(out, name)
    if os.path.exists(root):
        shutil.rmtree(root)
    shutil.copytree(PKG, os.path.join(root, 'gmvae_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    path = os.path.join(root, 'gmvae_tpu_torch', SOURCE)
    with open(path) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f'{name}: the edit {old[:60]!r} does not match '
                             'the source once')
        src = src.replace(old, new)
    with open(path, 'w') as f:
        f.write(src)
    return root


def measure(name: str) -> dict:
    """One JSON row: this process's build of the variant at every shape."""
    import numpy as np
    import torch
    from gmvae_tpu_torch.elbo import MixturePrior
    from gmvae_tpu_torch.ops.kernels import _build, fused_elbo, wide_head
    from gmvae_tpu_torch.utils.profiling import profile_device
    dev = torch.device('cuda', 0)
    lib = _build.library()
    row = {'variant': name}
    for h, k, d, b in SHAPES:
        rng = np.random.default_rng(0)
        n = k * d
        t = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
            (scale * rng.normal(size=s)).astype(np.float32)).to(dev)
        ins = [t(b, h), t(h, k, scale=0.05), t(k, scale=0.1),
               t(h, n, scale=0.05), t(n, scale=0.1), t(h, n, scale=0.02),
               t(n, scale=0.1), t(k), t(n), t(n, scale=0.5)]
        args, got = wide_head.launch_args(KEY, TAU, *ins, k, d)
        with torch.no_grad():
            ref = wide_head.wide_head_plain(KEY, TAU, *ins, k, d)
        _build.check(lib.gmvae_wide_head_fwd(*args), name)
        torch.cuda.synchronize()
        key = f'{h},{k},{d},{b}'
        row[key + ' cluster'] = lib.gmvae_wide_head_cluster(b, h, k, d)
        row[key + ' k_logits_rel_err'] = float(
            ((got[3] - ref[3]).abs() / ref[3].abs().clamp_min(1)).max())
        row[key + ' z_abs_err'] = float((got[0] - ref[0]).abs().max())
        for _ in range(10):
            lib.gmvae_wide_head_fwd(*args)
        row[key + ' device_us'] = [
            1e6 * profile_device(lambda: [lib.gmvae_wide_head_fwd(*args)
                                          for _ in range(200)])[1] / 200
            for _ in range(3)]
        if name == 'kernel':
            def narrow():
                kl, qm, qlv = wide_head.project(*ins[:7], k, d)
                return fused_elbo.fused_mixture_elbo(
                    KEY, kl, qm, qlv, MixturePrior(
                        ins[7], ins[8].reshape(k, d), ins[9].reshape(k, d)),
                    TAU)
            with torch.no_grad():
                narrow()
                busy = profile_device(
                    lambda: [narrow() for _ in range(50)])[1]
            row[key + ' narrow_device_us'] = 1e6 * busy / 50
    return row


def rates(out: str) -> int:
    """Build and run card_rates.cu; its exit code."""
    from gmvae_tpu_torch.ops.kernels import _build
    os.makedirs(out, exist_ok=True)
    exe = os.path.join(out, 'card_rates')
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS[:2], '-O3', '-o', exe,
                    os.path.join(os.path.dirname(__file__), 'card_rates.cu')],
                   check=True)
    return subprocess.run([exe]).returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('names', nargs='?', default=','.join(VARIANTS),
                    help='comma-separated variants (default: all)')
    ap.add_argument('--out', default=os.path.join(ROOT, 'runs',
                                                  'wide_variants'))
    ap.add_argument('--rates', action='store_true')
    ap.add_argument('--measure', help=argparse.SUPPRESS)  # a measuring child
    args = ap.parse_args(argv)
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print('wide_variants: no CUDA device', file=sys.stderr)
        return 2
    if args.rates:
        return rates(args.out)
    names = args.names.split(',')
    roots = {name: make(name, args.out) for name in names}
    build = ('import sys; sys.path.insert(0, sys.argv[1]); from '
             'gmvae_tpu_torch.ops.kernels import _build; _build.library()')
    procs = [subprocess.Popen([sys.executable, '-c', build, roots[name]])
             for name in names]
    if any(p.wait() for p in procs):
        raise RuntimeError('a variant failed to build')
    for name in names:
        env = dict(os.environ, PYTHONPATH=roots[name])
        out = subprocess.run(
            [sys.executable, '-m', 'gmvae_tpu_torch.tools.wide_variants',
             '--measure', name], cwd=roots[name], env=env, check=True,
            stdout=subprocess.PIPE, text=True).stdout
        print(out.strip().splitlines()[-1], flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
