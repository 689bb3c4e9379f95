"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file is
``configs/<config>.json``, and a traffic mix, ``traffic/<traffic>.json``,
whose ``generator`` names the general generator in ``generators/`` that plays
it. Its limits are ``limits/<cell>.json``. A per-layer metric is read by
``metrics/<metric>.py``'s ``read(ctx)``. Adding any of these is adding
files and manifest entries."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import List, NamedTuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: str = REPO) -> dict:
    return _json(os.path.join(root, 'BENCHMARK.json'))


def _applies(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def find_cell(manifest: dict, name: str, root: str = REPO) -> Cell:
    """The cell ``name`` with everything it names; ``KeyError`` for a cell
    the manifest does not hold."""
    work = {w['name']: w for w in manifest['workloads']}
    if name not in work:
        raise KeyError(f'no workload {name!r}; have {sorted(work)}')
    w = work[name]
    cfg = {c['name']: c for c in manifest['configs']}[w['config']]
    own = os.path.join(root, os.path.basename(HERE))
    return Cell(
        name=name, chips=int(w['chips']),
        config=_json(os.path.join(root, cfg['file'])),
        traffic=_json(os.path.join(own, 'traffic', w['traffic'] + '.json')),
        limits=_json(os.path.join(own, 'limits', name + '.json')),
        end_to_end=[m for m in manifest['end_to_end'] if _applies(m, name)],
        per_layer=[m for m in manifest['per_layer'] if _applies(m, name)])


def reader(metric: str, root: str = REPO) -> ModuleType:
    """``metrics/<metric>.py`` as a module (metric names may hold dots,
    so it is loaded by path)."""
    path = os.path.join(root, os.path.basename(HERE), 'metrics',
                        metric + '.py')
    spec = importlib.util.spec_from_file_location(
        'portbench.metrics.' + metric.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
