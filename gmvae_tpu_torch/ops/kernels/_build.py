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
main path went through the kernels.
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

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
SOURCES = ('fused_elbo_fwd.cu', 'fused_elbo_bwd.cu', 'wide_head_fwd.cu')
HEADERS = ('threefry.cuh', 'head_row.cuh')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

LAUNCHES: Dict[str, int] = {'fused_elbo_fwd': 0, 'fused_elbo_bwd': 0,
                            'wide_head_fwd': 0, 'threefry_grid': 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ''   # nvcc's output (ptxas register and spill report)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_SIGNATURES = {
    'gmvae_fused_elbo_fwd': (_I, [_P] * 11 + [_I, _I, _I, _U, _U,
                                              ctypes.c_float, _I, _P]),
    'gmvae_fused_elbo_bwd': (_I, [_P] * 19 + [_I, _I, _I, _U, _U,
                                              ctypes.c_float, _I, _P]),
    'gmvae_fused_elbo_bwd_scratch': (ctypes.c_size_t, [_I, _I, _I]),
    'gmvae_wide_head_fwd': (_I, [_P] * 14 + [_I] * 4 + [_U, _U,
                                                        ctypes.c_float, _P]),
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
