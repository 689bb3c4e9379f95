"""The manifest against the contract's rules, lookups by name, and a cell
added by files and manifest entries alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.core import manifest

REPO = manifest.REPO
TEXT = 200


def load():
    return manifest.load_manifest()


def test_top_level_keys():
    m = load()
    assert set(m) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert m['command'] == ['python3', 'portbench/run.py']
    assert m['paths'] == ['portbench']
    assert 1 <= m['run_seconds'] <= 51
    assert os.path.getsize(os.path.join(REPO, 'BENCHMARK.json')) <= 65536


def test_names_units_and_keys():
    m = load()
    names = []
    for c in m['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert 0 < len(c['why']) <= TEXT and 0 < len(c['source']) <= TEXT
        assert '\n' not in c['why'] and '\t' not in c['why']
        assert c['file'].startswith('portbench/')
        assert os.path.isfile(os.path.join(REPO, c['file']))
        assert all(manifest.NAME.match(k) for k in c['reduced'])
        names.append(c['name'])
    for w in m['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and 0 < len(w['why']) <= TEXT
        assert '\n' not in w['why'] and '\t' not in w['why']
        for k in ('name', 'config', 'traffic'):
            assert manifest.NAME.match(w[k]), w[k]
        names.append(w['name'])
    e2e = {x['name'] for x in m['end_to_end']}
    assert 'setup_s' in e2e
    for x in m['end_to_end'] + m['per_layer']:
        assert manifest.NAME.match(x['name']) and manifest.UNIT.match(
            x['unit'])
        assert x['better'] in ('lower', 'higher')
        names.append(x['name'])
    for x in m['end_to_end']:
        assert set(x) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert x['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= x['bound'] <= 0.25
    for x in m['per_layer']:
        assert set(x) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert x['moves'] in e2e and x['layer'] and '\n' not in x['layer']
        assert x['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
    assert len(names) == len(set(names))


def test_every_cell_reports_what_it_must():
    m = load()
    for w in m['workloads']:
        cell = manifest.find_cell(m, w['name'])
        e2e = {x['name'] for x in cell.end_to_end}
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert cell.per_layer
        for x in cell.per_layer:
            assert x['moves'] in e2e
            assert callable(manifest.reader(x['name']).read)
        # a count compared exactly has the limit 0
        assert cell.limits and all(v >= 0 for v in cell.limits.values())


def test_find_by_name():
    cell = manifest.find_cell(load(), 'celeba_dp16.train_b1024')
    assert cell.config['name'] == 'celeba_dp16'
    assert cell.traffic['generator'] == 'train'
    assert cell.chips == 1
    with pytest.raises(KeyError):
        manifest.find_cell(load(), 'no_such_cell')


def test_a_cell_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric, as
    new files and manifest entries in a copy of the benchmark; no file
    that is there changes, and the harness finds and reads them."""
    root = tmp_path / 'checkout'
    shutil.copytree(os.path.join(REPO, 'portbench'), root / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    m = load()
    before = {p: p.read_bytes() for p in (root / 'portbench').rglob('*')
              if p.is_file()}
    cfg = json.loads((root / 'portbench/configs/cifar_k20.json')
                     .read_text())
    cfg.update(name='cifar_k20_b64', batch_size=64)
    (root / 'portbench/configs/cifar_k20_b64.json').write_text(
        json.dumps(cfg))
    (root / 'portbench/traffic/assign_b64.json').write_text(json.dumps(
        {'generator': 'assign', 'batch': 64, 'trace_seconds': 1}))
    (root / 'portbench/limits/cifar_k20_b64.assign_b64.json').write_text(
        json.dumps({'gap_max': 0.025}))
    (root / 'portbench/metrics/requests_traced.py').write_text(
        'def read(ctx):\n    return float(ctx.traced_units)\n')
    m['configs'].append({'name': 'cifar_k20_b64', 'source': 'x',
                         'file': 'portbench/configs/cifar_k20_b64.json',
                         'reduced': ['batch_size'], 'why': 'a test'})
    m['workloads'].append({'name': 'cifar_k20_b64.assign_b64',
                           'config': 'cifar_k20_b64', 'traffic': 'assign_b64',
                           'chips': 1, 'why': 'a test'})
    m['per_layer'].append({'name': 'requests_traced', 'unit': 'req',
                           'better': 'higher', 'source': 'program_counter',
                           'layer': 'serving', 'moves': 'assign_img_per_s',
                           'workloads': ['cifar_k20_b64.assign_b64']})
    for x in m['end_to_end'] + m['per_layer']:
        if x['name'] in ('assign_img_per_s', 'h2d_ms_per_req'):
            x['workloads'].append('cifar_k20_b64.assign_b64')
    (root / 'BENCHMARK.json').write_text(json.dumps(m))
    for p, data in before.items():
        assert p.read_bytes() == data
    cell = manifest.find_cell(manifest.load_manifest(str(root)),
                              'cifar_k20_b64.assign_b64', root=str(root))
    assert cell.config['batch_size'] == 64 and cell.traffic['batch'] == 64
    assert {x['name'] for x in cell.per_layer} >= {'requests_traced',
                                                   'h2d_ms_per_req'}
    assert cell.limits == {'gap_max': 0.025}
    from portbench.generators.common import LayerContext
    ctx = LayerContext('assign', cell.config, 64, None, 9, 1.0, 30, {})
    assert manifest.reader('requests_traced', str(root)).read(ctx) == 9.0
    # the copy's own harness drives the new cell (on the CPU, a pool of 200)
    code = (
        'import sys; sys.path.insert(0, sys.argv[1]); import run\n'
        'from portbench.core import manifest\n'
        'find = manifest.find_cell\n'
        'def small(*a, **kw):\n'
        '    c = find(*a, **kw)\n'
        '    return c._replace(config=dict(c.config, test_examples=200))\n'
        'manifest.find_cell = small\n'
        'run.card = lambda chips: "cpu"\n'
        'run.card_kind = lambda device: "cpu"\n'
        'sys.exit(run.main(sys.argv[2:]))\n')
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='2')
    out = subprocess.run(
        [sys.executable, '-c', code, str(root / 'portbench'), '--workload',
         'cifar_k20_b64.assign_b64', '--seed', str(2 ** 31 + 3),
         '--seconds', '1'], capture_output=True, text=True, env=env,
        cwd=str(root), timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'] is True
    assert set(line['metrics']) == {'assign_img_per_s', 'setup_s'}
    assert list(line)[-1] == 'checks'
