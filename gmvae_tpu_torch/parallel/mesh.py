"""Process group and data-sharding helpers: the port of
``gmvae_tpu/parallel/mesh.py``.

The reference runs data parallelism as ``shard_map`` over a 1-D
``('data',)`` mesh with one ``pmean`` a step. The port uses PyTorch's own
idiom: one process for each device, joined in a ``torch.distributed``
group (NCCL on cards, gloo on the CPU). The rank of a process is its
shard index on the reference's data axis, and the group's size its data
axis.

Without a group (no torchrun variables, nothing initialized) every helper
here is the one-process case: ``world()`` is ``(0, 1)`` and the
collectives do nothing, so a single-device run never touches the
distributed stack. A one-rank group takes the same path as a larger one.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

def group_up() -> bool:
    """True when this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    """The process group's backend ('nccl', 'gloo'); None without one."""
    return dist.get_backend() if group_up() else None


def world() -> Tuple[int, int]:
    """``(rank, size)`` of the process group; ``(0, 1)`` without one."""
    if not group_up():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def device_for_rank(device) -> torch.device:
    """``device`` as a torch.device; a bare ``'cuda'`` becomes
    ``cuda:LOCAL_RANK`` when torchrun's ``LOCAL_RANK`` is set (one device a
    process). An explicit index is kept: two ranks may share one card."""
    dev = torch.device(device)
    if (dev.type == 'cuda' and dev.index is None
            and 'LOCAL_RANK' in os.environ):
        dev = torch.device('cuda', int(os.environ['LOCAL_RANK']))
    return dev


def init_distributed(device=None, backend: Optional[str] = None) -> bool:
    """Start the default process group from the variables torchrun (and
    ``parallel/launch.py``) set for each rank: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; returns whether a
    group is up. Without
    ``RANK``/``WORLD_SIZE`` it does nothing, as the reference gates on its
    coordinator variable, and a group that already exists is kept. The
    backend is ``backend`` when given, else NCCL for a CUDA ``device`` and
    gloo otherwise."""
    if group_up():
        return True
    if 'RANK' not in os.environ or 'WORLD_SIZE' not in os.environ:
        return False
    dev = device_for_rank(device if device is not None else 'cpu')
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method='env://',
                            rank=int(os.environ['RANK']),
                            world_size=int(os.environ['WORLD_SIZE']))
    return True


def _comm_buffer(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the backend moves its memory, else a copy where
    it does: a CUDA tensor goes through pinned host memory under gloo, every
    time, and a host tensor through the current card under NCCL."""
    if dist.get_backend() == 'gloo':
        if not t.is_cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)
    return t if t.is_cuda else t.to('cuda')


def all_reduce_mean_(flat: torch.Tensor) -> torch.Tensor:
    """Average ``flat`` over the group, in place, in one collective: the
    reference's ``pmean`` (a sum, then a division by the size). Every rank
    ends with the same bits: gloo's and NCCL's all-reduce hand one result
    to all ranks. Without a group, ``flat`` is returned as it is."""
    if not group_up():
        return flat
    buf = _comm_buffer(flat)
    dist.all_reduce(buf)
    if buf is not flat:
        flat.copy_(buf)
    return flat.div_(dist.get_world_size())


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` from rank ``src`` on every rank, in place."""
    if not group_up():
        return t
    buf = _comm_buffer(t)
    dist.broadcast(buf, src)
    if buf is not t:
        t.copy_(buf)
    return t


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each), concatenated along the
    leading axis in rank order, on every rank."""
    if not group_up():
        return t
    buf = _comm_buffer(t.contiguous())
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, buf)
    return torch.cat(parts).to(t.device)


def barrier() -> None:
    if group_up():
        dist.barrier()


def process_shard(n: int) -> slice:
    """This rank's contiguous shard of ``n`` examples: rank ``r`` of ``p``
    owns ``[r*n//p, (r+1)*n//p)``."""
    r, p = world()
    return slice(r * n // p, (r + 1) * n // p)


def pad_to_multiple(x: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis to a multiple by tiling ``x`` (a single
    ``x[:rem]`` falls short when ``multiple > 2n``). Returns (padded, n)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem:
        reps = -(-rem // n)
        pad = np.concatenate([x] * reps, axis=0)[:rem]
        x = np.concatenate([x, pad], axis=0)
    return x, n


def shard_rows(x: np.ndarray, rank: int, size: int) -> np.ndarray:
    """Rank ``rank``'s rows of ``x`` split over ``size`` ranks, as the
    reference's ``put_sharded`` lays them out: the leading axis padded by
    wraparound to a multiple of ``size``, then one contiguous block a
    rank."""
    xs, _ = pad_to_multiple(np.asarray(x), size)
    n_local = xs.shape[0] // size
    return xs[rank * n_local:(rank + 1) * n_local]
