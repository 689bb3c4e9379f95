"""The benchmark's own tests: the reference against the port on the CPU
at small sizes, the yardstick, the trace readers, the manifest, and runs
driven without a card. Tests that need a card carry the ``cuda`` marker
and skip without one (deciding inside a fixture)."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA GPU; skips without one')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    return torch.device('cuda')


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
