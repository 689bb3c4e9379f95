"""Offline cluster assignment: one closed-loop client over the port's
exported ``assign`` artifact.

The mix's file gives ``batch`` (rows a request) and ``trace_seconds``.
The configuration gives the model and the test split's size: the request
pool, float32 NHWC images in [0, 1] from the seed, held as numpy arrays
over page-locked host memory, as a loader that pins its batches hands
them over (so the copy in is the pinned one; ``Program.__call__`` pins
nothing itself). Request ``r`` is the pool's rows ``r * batch ..``,
wrapping around.

Set-up builds a ``Trainer`` (given the pool's first rows as its data
set; nothing is trained), hands it the weights from the seed, exports
the verb to bytes (``serving.export_verb``), loads them once
(``serving.load_program``) and warms the request's shape up. The
client sends each request when the last one's answer is back; a
request's time runs from the call until its int32 answer is in host
memory. ``assign_img_per_s`` is the window's images over its time,
``assign_p95_ms`` the 95th percentile of every request's time. Once the
window has closed and the program is freed, the reference works out
every pool image's cluster logits, and every answer of the window is
judged by its gap, the reference's best logit less the logit of the
cluster the program chose (0 where they agree); ``gap_max``, the widest
gap of any answer, is compared.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench.core import compare, inputs
from portbench.core.trace import capture, span
from portbench.generators import common
from portbench.reference import model
from portbench.reference import train as reference


def pool_images(cfg: dict, seed: int, batch: int, device):
    """(the pool as float32 in [0, 1], with its first ``batch`` rows
    repeated at its end so that every request is one contiguous slice,
    in page-locked host memory when ``device`` is a card; the uint8
    images)."""
    u8 = inputs.images_u8(cfg['test_examples'], cfg['image_shape'], seed,
                          device)
    n = u8.shape[0]
    pool = torch.empty((n + batch, *u8.shape[1:]), dtype=torch.float32,
                       pin_memory=torch.device(device).type == 'cuda')
    pool[:n] = torch.from_numpy(u8).to(torch.float32) * (1.0 / 255.0)
    pool[n:] = pool[:batch]
    return pool.numpy(), u8


def gaps(ref_logits: torch.Tensor, offsets, answers, batch: int):
    """Each answer's gap below the reference's best, flat."""
    n = ref_logits.shape[0]
    best = ref_logits.max(dim=1).values
    out = []
    for off, ids in zip(offsets, answers):
        rows = (off + torch.arange(batch)) % n
        got = ref_logits[rows, torch.from_numpy(ids).long()]
        out.append(best[rows] - got)
    return torch.cat(out)


def numbers(g: torch.Tensor):
    """``gap_max``, which is compared; the mean gap and the answers that
    differ from the reference's choice (``flips``), which are not: how
    many answers sit near a tie changes from seed to seed."""
    return {'gap_max': float(g.max()), 'gap_mean': float(g.double().mean()),
            'flips': int((g > 0).sum()), 'answers': int(g.numel())}


def serve(program, pool: np.ndarray, n: int, batch: int, seconds: float,
          start: int = 0):
    """The closed loop for ``seconds``: (request times s, offsets,
    answers, the window's length)."""
    lat, offs, answers = [], [], []
    t0 = time.perf_counter()
    r = start
    while True:
        off = (r * batch) % n
        x = pool[off:off + batch]
        t = time.perf_counter()
        with span('portbench.request'):
            ids = program(x)
        t1 = time.perf_counter()
        lat.append(t1 - t)
        offs.append(off)
        answers.append(ids)
        r += 1
        if t1 - t0 >= seconds:
            return lat, offs, answers, t1 - t0


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> common.Outcome:
    from gmvae_tpu_torch import data as data_lib
    from gmvae_tpu_torch import serving, training

    cfg, mix = cell.config, cell.traffic
    batch = int(mix['batch'])
    n = cfg['test_examples']
    if n < batch:
        raise ValueError(f'a pool of {n} images is smaller than a request')
    pcfg = common.port_config(cfg, seed)
    common.stage(t_start, 'set-up, import')
    pool, u8 = pool_images(cfg, seed, batch, device)
    common.stage(t_start, 'set-up, images')
    rows = u8[:pcfg.batch_size]
    labels = np.zeros(rows.shape[0], np.int32)
    trainer = training.Trainer(
        pcfg, data_lib.Dataset(cfg['name'], rows, labels, rows, labels),
        device=device)
    params = model.make_params(cfg, seed, device)
    common.check_layout(cfg, trainer.model.state_dict())
    state = trainer.fresh_state({k: v.clone() for k, v in params.items()})
    common.stage(t_start, 'set-up, trainer and weights')
    blob = serving.export_verb(trainer, state, 'assign', device=device)
    del trainer, state
    common.stage(t_start, 'set-up, export')
    program = serving.load_program(blob, device=device)
    common.stage(t_start, 'set-up, load')
    for _ in range(3):
        program(pool[:batch])
    common.sync(device)

    setup_s = time.perf_counter() - t_start
    lat, offs, answers, window = serve(program, pool, n, batch, seconds)
    requests = len(lat)
    e2e = {'assign_img_per_s': requests * batch / window,
           'assign_p95_ms': 1e3 * statistics.quantiles(lat, n=20)[18],
           'setup_s': setup_s}
    layers = None
    if trace:
        got = []
        tr = capture(lambda: got.append(serve(
            program, pool, n, batch, float(mix['trace_seconds']),
            start=requests)), lambda: common.sync(device),
            lambda: serve(program, pool, n, batch, 0.0))
        layers = common.LayerContext('assign', cfg, batch, tr,
                                     len(got[0][0]), window, requests, e2e)
        offs += got[0][1]
        answers += got[0][2]
    peak = common.memory_peak(device)
    del program
    common.free(device)

    t_check = time.perf_counter()
    ref = reference.cluster_logits(cfg, params, torch.from_numpy(pool[:n]),
                                   device).cpu()
    vals = numbers(gaps(ref, offs, answers, batch))
    common.stage(t_check, 'the check')
    return common.Outcome(
        end_to_end=e2e,
        attempted=requests, failed=0,
        checks=compare.checks(vals, cell.limits), readings=vals,
        layers=layers, memory_peak_bytes=peak)
