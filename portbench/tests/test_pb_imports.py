"""What the benchmark loads: no module whose top-level name is jax,
jaxlib or the JAX package (``gmvae_tpu``, compared whole:
``gmvae_tpu_torch`` is the port), and the reference loads nothing of the
port."""

import glob
import json
import os
import subprocess
import sys

from portbench.core import manifest

REPO = manifest.REPO
HARNESS = os.path.join(REPO, 'portbench')


def modules(pattern):
    out = []
    for path in sorted(glob.glob(os.path.join(HARNESS, pattern),
                                 recursive=True)):
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, '.')
        if '.tests.' not in rel and not rel.endswith('__init__'):
            out.append(rel)
    return out


def loaded_after(code):
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys, json\n'
         'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))'],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = [m for m in modules('**/*.py') if not m.startswith(
        'portbench.metrics.')]
    assert 'portbench.run' in mods and 'portbench.generators.train' in mods
    code = '\n'.join(['import importlib, sys', 'sys.path.insert(0, ".")',
                      'sys.path.insert(0, "portbench")']
                     + [f'importlib.import_module({m!r})' for m in mods]
                     + ['from portbench.core import manifest',
                        'm = manifest.load_manifest()']
                     + ['[manifest.reader(x["name"]) for x in '
                        'm["per_layer"]]'])
    top = loaded_after(code)
    assert not top & {'jax', 'jaxlib', 'flax', 'gmvae_tpu'}, top


def test_generators_load_the_port_without_jax():
    top = loaded_after('import sys; sys.path.insert(0, ".")\n'
                       'import gmvae_tpu_torch, gmvae_tpu_torch.serving, '
                       'gmvae_tpu_torch.training')
    assert 'gmvae_tpu_torch' in top
    assert not top & {'jax', 'jaxlib', 'flax', 'gmvae_tpu'}, top


def test_reference_loads_nothing_of_the_port():
    mods = modules('reference/*.py') + modules('yardstick/*.py')
    code = '\n'.join(['import importlib, sys', 'sys.path.insert(0, ".")']
                     + [f'importlib.import_module({m!r})' for m in mods])
    top = loaded_after(code)
    assert not top & {'jax', 'jaxlib', 'flax', 'gmvae_tpu',
                      'gmvae_tpu_torch'}, top
