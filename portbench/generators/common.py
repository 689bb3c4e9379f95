"""What the generators share: the port's configuration as the configuration
file states it, the weights from the seed, and the device's readings."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from portbench.core.compare import Check
from portbench.core.trace import Trace
from portbench.reference import model


class LayerContext(NamedTuple):
    """What a per-layer metric's reader gets (``metrics/*.py``)."""
    kind: str                  # the generator: 'train', 'assign'
    config: dict               # the configuration file
    rows: int                  # rows a step or a request, on one chip
    trace: Trace               # the traced window
    traced_units: int          # steps or requests in the traced window
    window_s: float            # the timed window (untraced)
    window_units: int          # steps or requests in the timed window
    end_to_end: Dict[str, float]   # the timed window's end-to-end readings


class Outcome(NamedTuple):
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    readings: Dict[str, float]   # every number worked out, compared or not
    layers: Optional[LayerContext]
    memory_peak_bytes: int


def port_config(cfg: dict, seed: int):
    """The port's named configuration with every field the file gives set
    as the file states it, the seed's low 32 bits as its seed, and no
    evaluation or checkpoint during a run."""
    from gmvae_tpu_torch import configs
    fields = {f.name for f in dataclasses.fields(configs.Config)}
    given = {k: tuple(v) if isinstance(v, list) else v
             for k, v in cfg.items() if k in fields and k != 'name'}
    return configs.get_config(cfg['port_config']).replace(
        seed=seed % 2 ** 32, eval_every=10 ** 9, ckpt_every=0, **given)


def check_layout(cfg: dict, state_dict: Dict[str, torch.Tensor]) -> None:
    """The program's parameters must be the reference's, name for name
    and shape for shape."""
    want = {k: tuple(s) for k, s, _ in model.layout(cfg)}
    have = {k: tuple(v.shape) for k, v in state_dict.items()}
    if want != have:
        raise RuntimeError(
            f'the program\'s parameters differ from the configuration\'s: '
            f'{sorted(set(want.items()) ^ set(have.items()))[:6]}')


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    if torch.device(device).type != 'cuda':
        return 0
    return max(torch.cuda.max_memory_allocated(i)
               for i in range(torch.cuda.device_count()))


def free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()


def stage(t_start: float, what: str) -> None:
    """Progress on standard error: seconds since ``t_start``."""
    print(f'{what}: {time.perf_counter() - t_start:.3f} s', file=sys.stderr)
