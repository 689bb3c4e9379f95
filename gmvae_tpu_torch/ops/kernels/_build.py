"""Build the port's CUDA sources with nvcc and bind them with ctypes.

The sources under ``gmvae_tpu_torch/csrc/`` have a plain C interface (no
PyTorch headers), so each builds in seconds: one ``nvcc`` per source, all
started together, then one link. The shared library lands in
``gmvae_tpu_torch/_build/`` (git-ignored), named by a hash of the sources
and flags, and is built at first use in a process: a changed source
rebuilds, an unchanged one reloads. Nothing is built or imported at
module import time, so the CPU tests import every module without ``nvcc``.

``LAUNCHES`` counts kernel launches by kernel name: each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels. ``fused_elbo_bwd_persistent`` counts
the backward's launches whose blocks each took several rows, as the launch
reports (B > P: a subset of ``fused_elbo_bwd``'s, not launches of their
own). A launch captured in a CUDA graph is counted at each replay of the
graph, not at its capture (``training.StepGraphs``); ``REPLAYS`` counts the
replays of the training step's graphs, one a step.

The head kernels read the threefry key and tau from device memory
(``head_scalars``), so a captured launch takes each replay's values.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
SOURCES = ('fused_elbo_fwd.cu', 'fused_elbo_bwd.cu', 'wide_head_fwd.cu')
HEADERS = ('threefry.cuh', 'head_row.cuh')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

LAUNCHES: Dict[str, int] = {'fused_elbo_fwd': 0, 'fused_elbo_bwd': 0,
                            'fused_elbo_bwd_persistent': 0,
                            'wide_head_fwd': 0, 'threefry_grid': 0}
REPLAYS: Dict[str, int] = {'train_step': 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ''   # nvcc's output (ptxas register and spill report)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_SIGNATURES = {
    'gmvae_fused_elbo_fwd': (_I, [_P] * 11 + [_I, _I, _I, _P, _P, _I, _P]),
    'gmvae_fused_elbo_bwd': (_I, [_P] * 19 + [_I, _I, _I, _P, _P, _I, _P,
                                              _P]),
    'gmvae_fused_elbo_bwd_scratch': (ctypes.c_size_t, [_I, _I, _I]),
    'gmvae_fused_elbo_bwd_resident': (_I, [_I, _I]),
    'gmvae_wide_head_fwd': (_I, [_P] * 14 + [_I] * 4 + [_P, _P, _P]),
    'gmvae_wide_head_smem': (ctypes.c_size_t, [_I] * 4),
    'gmvae_wide_head_cluster': (_I, [_I] * 4),
    'gmvae_threefry_grid': (_I, [_U, _U, _P, _P, _P, _P, _I, _P]),
    'gmvae_cuda_error_string': (ctypes.c_char_p, [_I]),
}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on '
                           'PATH to build the CUDA kernels')
    return found


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        out = BUILD_DIR / f'gmvae_kernels_{_digest()}.so'
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build under a temporary name, then rename: a concurrent
            # process never loads a half-written library
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                objs = [os.path.join(tmp, s + '.o') for s in SOURCES]
                lib = os.path.join(tmp, 'lib.so')
                steps = [[nvcc(), *NVCC_FLAGS, '-c', '-o', o, str(CSRC / s)]
                         for s, o in zip(SOURCES, objs)]
                link = [nvcc(), '-shared', *NVCC_FLAGS[:2], '-o', lib, *objs]
                build_log = ''
                for batch in (steps, [link]):   # compiles in parallel
                    procs = [subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True) for cmd in batch]
                    build_log += ''.join(p.communicate()[0] for p in procs)
                    if any(p.returncode for p in procs):
                        raise RuntimeError(f'nvcc failed:\n{build_log}')
                os.replace(lib, out)
        lib = ctypes.CDLL(str(out))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def check_inputs(inputs: Mapping[str, Tuple[Optional[torch.Tensor], tuple]],
                 device: torch.device) -> None:
    """Raise unless every given tensor (``None`` entries are skipped) has
    its expected shape, is contiguous float32 and lies on ``device``."""
    for name, (t, shape) in inputs.items():
        if t is None:
            continue
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f'{name}: shape {tuple(t.shape)}, expected '
                             f'{tuple(shape)}')
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f'{name}: the kernel takes contiguous float32, '
                             f'got {t.dtype} (contiguous={t.is_contiguous()})')
        if t.device != device:
            raise ValueError(f'{name}: on {t.device}, not {device}')


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().gmvae_cuda_error_string(rc).decode()
        raise RuntimeError(f'{what}: CUDA error {rc} ({msg})')


class Args(tuple):
    """A launch's C arguments, holding the tensors that its pointers point
    into (``keep``) for as long as the arguments are kept."""

    def __new__(cls, args: tuple, keep: tuple):
        out = super().__new__(cls, args)
        out.keep = keep
        return out


def head_scalars(key_u32, tau, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry key and tau where the head kernels read them: ``(key
    int32 [2], tau float32 [])`` on ``device``, the key's words bit for bit.
    Tensors already there (the training step's graphs pass views of their
    per-step slot) are used as they are; host values (a ``(k0, k1)`` pair, a
    number or a CPU tensor) go over in one copy from pinned memory, which
    does not wait for the card."""
    def here(t):
        return torch.is_tensor(t) and t.device == device

    if here(key_u32) and here(tau):
        if key_u32.dtype != torch.int32 or tuple(key_u32.shape) != (2,):
            raise ValueError(f'key: int32 [2] on the device, got '
                             f'{key_u32.dtype} {tuple(key_u32.shape)}')
        if tau.dtype != torch.float32 or tau.dim() != 0:
            raise ValueError(f'tau: a float32 scalar on the device, got '
                             f'{tau.dtype} {tuple(tau.shape)}')
        return key_u32, tau
    words = np.zeros(3, np.uint32)
    words[:2] = [int(w) & 0xFFFFFFFF for w in key_u32]
    words[2:] = np.float32(float(tau)).view(np.uint32)
    staged = torch.from_numpy(words.view(np.int32)).pin_memory().to(
        device, non_blocking=True)
    return staged[:2], staged[2:].view(torch.float32)[0]
