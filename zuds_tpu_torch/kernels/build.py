"""Build the CUDA C++ kernels of this package and load them with ctypes.

The ``.cu`` sources beside this file are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, at first use,
into ``_build/<hash of sources and flags>/`` next to the sources (git
ignores it). No ninja, no PyTorch headers: a build takes seconds. Every
launcher returns ``cudaGetLastError()`` and :func:`check` raises on it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ['library', 'check']

_HERE = Path(__file__).resolve().parent
SOURCES = ('warp.cu', 'background.cu', 'apply.cu')
FLAGS = ('-O3', '-std=c++17', '-gencode', 'arch=compute_90a,code=sm_90a',
         '-shared', '-Xcompiler', '-fPIC', '-lineinfo')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: (name, argtypes); every launcher returns int (cudaError_t)
SIGNATURES = {
    # ref, mask, u, v, covb, refw, refm, cov, H, W, window, stream
    'zuds_warp': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # img, valid(u8), back, sigma, n, H, W, box, iters, stream
    'zuds_background_cells': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # ref, kd, bg, cx, cy, model, H, W, K, Nm, nreg, pexp, qexp, wx, wy,
    # stream
    'zuds_apply': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                   _F, _F, _P),
}



def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = Path(cuda_home) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin and '
                           'PATH); the CUDA kernels need the CUDA toolkit')
    return found


def _digest():
    h = hashlib.sha256()
    for name in SOURCES + ('common.cuh',):
        h.update(name.encode())
        h.update((_HERE / name).read_bytes())
    h.update(' '.join(FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_so = Path(tmp) / out.name
        cmd = [_nvcc(), *FLAGS, '-o', str(tmp_so),
               *[str(_HERE / s) for s in SOURCES]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                               f'{" ".join(cmd)}\n{proc.stdout}\n'
                               f'{proc.stderr}')
        os.replace(tmp_so, out)     # atomic: a concurrent loader sees all


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built on first call."""
    out = _HERE / '_build' / _digest() / 'libzuds_kernels.so'
    if not out.exists():
        _compile(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err, name):
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} at launch')
