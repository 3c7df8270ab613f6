"""Python wrappers of the CUDA C++ kernels (H1 warp, H2 background cells,
H3 model convolution).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises
if the launch reported an error, and adds one to its ``launches`` count.
Nothing here synchronises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ['warp', 'background_cells', 'apply_model', 'WRAPPERS']


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _require(name, t, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    if t.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')


def warp(ref, mask, u, v, covb, window):
    """H1 (kernels/warp.cu): (refw f32, refm i32, cov f32), each (H, W)."""
    H, W = ref.shape
    _require('ref', ref, torch.float32)
    _require('ref_mask', mask, torch.int32, (H, W))
    _require('u', u, torch.float32, (H, W))
    _require('v', v, torch.float32, (H, W))
    _require('cov_bounds', covb, torch.float32, (4,))
    refw = torch.empty_like(ref)
    refm = torch.empty_like(mask)
    cov = torch.empty_like(ref)
    err = build.library().zuds_warp(
        _ptr(ref), _ptr(mask), _ptr(u), _ptr(v), _ptr(covb), _ptr(refw),
        _ptr(refm), _ptr(cov), H, W, int(window), _stream())
    build.check(err, 'zuds_warp')
    warp.launches += 1
    return refw, refm, cov


def background_cells(img, valid, box, iters):
    """H2 (kernels/background.cu): per-cell clipped background, sigma and
    kept-pixel count, each (ncy, ncx); cells past the frame edge are padded
    invalid."""
    H, W = img.shape
    _require('img', img, torch.float32)
    _require('valid', valid, torch.bool, (H, W))
    if box * box % 512 != 0 or box * box > 512 * 32:
        raise ValueError(f'background_cells: box={box} unsupported '
                         '(box^2 must be a multiple of 512, at most 16384)')
    ncy, ncx = -(-H // box), -(-W // box)
    back = torch.empty((ncy, ncx), dtype=torch.float32, device=img.device)
    sigma = torch.empty_like(back)
    n = torch.empty((ncy, ncx), dtype=torch.int32, device=img.device)
    err = build.library().zuds_background_cells(
        _ptr(img), _ptr(valid), _ptr(back), _ptr(sigma), _ptr(n), H, W,
        int(box), int(iters), _stream())
    build.check(err, 'zuds_background_cells')
    background_cells.launches += 1
    return back, sigma, n


def apply_model(ref, kd, bg, cx, cy, pexp, qexp, wx, wy, nreg):
    """H3 (kernels/apply.cu): the spatially varying model convolution
    ``bg[r] + sum_m T_m(xn, yn) (kd[r, m] * ref)`` with zero padding.

    kd (R2, Nm, K, K) f32; bg, cx, cy (R2,) f32 (region centres as the
    reference rounds them to f32); pexp/qexp (Nm,) int32 exponents."""
    H, W = ref.shape
    R2, Nm, K, _ = kd.shape
    _require('ref', ref, torch.float32)
    _require('kd', kd, torch.float32, (nreg * nreg, Nm, K, K))
    for name, t in (('bg', bg), ('cx', cx), ('cy', cy)):
        _require(name, t, torch.float32, (R2,))
    _require('pexp', pexp, torch.int32, (Nm,))
    _require('qexp', qexp, torch.int32, (Nm,))
    if K > 15 or Nm > 15 or K % 2 != 1:
        raise ValueError(f'apply_model: K={K}, Nm={Nm} unsupported '
                         '(odd K <= 15, Nm <= 15)')
    if H < 32 * nreg or W < 32 * nreg:
        raise ValueError('apply_model: regions must be at least 32 px')
    model = torch.empty_like(ref)
    err = build.library().zuds_apply(
        _ptr(ref), _ptr(kd), _ptr(bg), _ptr(cx), _ptr(cy), _ptr(model), H,
        W, K, Nm, int(nreg), _ptr(pexp), _ptr(qexp), float(wx), float(wy),
        _stream())
    build.check(err, 'zuds_apply')
    apply_model.launches += 1
    return model


warp.launches = 0
background_cells.launches = 0
apply_model.launches = 0
WRAPPERS = {'warp': warp, 'background_cells': background_cells,
            'apply_model': apply_model}
