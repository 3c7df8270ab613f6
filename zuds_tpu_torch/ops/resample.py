"""Lanczos-3 reference warp (twin of ``zuds_tpu/ops/resample.py``).

Plain PyTorch versions of the main path's warp functions, and
:func:`warp_reference` and :func:`warp_epoch`, which run the fused hand
kernel H1 (``kernels/warp.cu``) on a CUDA tensor and the plain composition
on a CPU tensor: one float plane and a mask for the subtraction's
reference, two float planes (pixels and weight) and a mask for a coadd's
epoch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import launch

__all__ = ['SUPPORT', 'lanczos3', 'upsample_mapping', 'warp_shift_image',
           'warp_shift_mask', 'coverage_gate', 'warp_reference',
           'warp_reference_plain', 'warp_epoch', 'warp_epoch_plain']

SUPPORT = 3

# |lanczos3(t)| > sqrt(5e-3) as interval tests (resample.py:189-209)
_SIG_A = np.float32(0.9226250948801125)
_SIG_B = np.float32(1.099650902956955)
_SIG_C = np.float32(1.7405705334521984)


def lanczos3(t):
    """Lanczos-3 kernel: sinc(t)·sinc(t/3) on |t|<3, else 0."""
    return torch.where(t.abs() < SUPPORT,
                       torch.sinc(t) * torch.sinc(t / 3.0),
                       torch.zeros((), dtype=t.dtype, device=t.device))


def _sig_lanczos(t):
    a = t.abs()
    return (a < float(_SIG_A)) | ((a > float(_SIG_B)) & (a < float(_SIG_C)))


def upsample_mapping(u_coarse, v_coarse, shape, step):
    """Bilinearly upsample a coarse mapping grid (GH, GW) to per-pixel
    source coordinates (u, v), each (H, W) float32 (resample.py:38)."""
    H, W = shape

    def interp(g):
        g = torch.cat([g, 2 * g[-1:] - g[-2:-1]], dim=0)
        g = torch.cat([g, 2 * g[:, -1:] - g[:, -2:-1]], dim=1)
        gh, gw = g.shape
        a = g[:-1, :-1][:, None, :, None]
        b = g[:-1, 1:][:, None, :, None]
        c = g[1:, :-1][:, None, :, None]
        d = g[1:, 1:][:, None, :, None]
        f = torch.arange(step, dtype=torch.float32, device=g.device) / step
        fy = f[None, :, None, None]
        fx = f[None, None, None, :]
        full = (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
                + c * fy * (1 - fx) + d * fy * fx)
        full = full.reshape((gh - 1) * step, (gw - 1) * step)
        return full[:H, :W].contiguous()

    return interp(u_coarse), interp(v_coarse)


def _offsets(u, v):
    H, W = u.shape
    yy = torch.arange(H, dtype=u.dtype, device=u.device)[:, None]
    xx = torch.arange(W, dtype=u.dtype, device=u.device)[None, :]
    inb = ((u >= SUPPORT - 1) & (u <= W - SUPPORT)
           & (v >= SUPPORT - 1) & (v <= H - SUPPORT))
    return u - xx, v - yy, inb


def warp_shift_image(img, u, v, window=4):
    """Windowed Lanczos-3 warp with unit-sum weights (resample.py:275).
    Taps beyond ``window + 3`` px are dropped; source reads wrap around.
    Returns (warped, coverage)."""
    du, dv, inb = _offsets(u, v)
    lo, hi = -(window + SUPPORT), window + SUPPORT
    wx = torch.stack([lanczos3(du - dx) for dx in range(lo, hi + 1)])
    wxsum = wx.sum(0)
    acc = torch.zeros_like(img)
    wacc = torch.zeros_like(img)
    for dy in range(lo, hi + 1):
        wy = lanczos3(dv - dy)
        srow = torch.roll(img, -dy, dims=0)
        for j, dx in enumerate(range(lo, hi + 1)):
            acc = acc + torch.roll(srow, -dx, dims=1) * (wx[j] * wy)
        wacc = wacc + wxsum * wy
    out = acc / torch.where(wacc == 0, torch.ones_like(wacc), wacc)
    cov = inb.to(torch.float32)
    return out * cov, cov


def warp_shift_mask(mask, u, v, window=4):
    """Separable significant-weight OR mask warp (resample.py:213): bits
    reach a pixel iff the column weight (evaluated at the intermediate
    row) and the row weight each pass ``_sig_lanczos``."""
    du, dv, inb = _offsets(u, v)
    lo, hi = -(window + SUPPORT), window + SUPPORT
    zero = torch.zeros((), dtype=mask.dtype, device=mask.device)
    inner = torch.zeros_like(mask)
    for dx in range(lo, hi + 1):
        inner = inner | torch.where(_sig_lanczos(du - dx),
                                    torch.roll(mask, -dx, dims=1), zero)
    out = torch.zeros_like(mask)
    for dy in range(lo, hi + 1):
        out = out | torch.where(_sig_lanczos(dv - dy),
                                torch.roll(inner, -dy, dims=0), zero)
    return torch.where(inb, out, zero)


def coverage_gate(u, v, covb, refw, refm, cov):
    """one_frame's original-frame coverage gate (pipeline.py:176-180)."""
    covo = ((u >= covb[0]) & (u <= covb[1])
            & (v >= covb[2]) & (v <= covb[3]))
    cov = cov * covo.to(torch.float32)
    refw = refw * cov
    refm = torch.where(cov > 0, refm, torch.zeros_like(refm))
    return refw, refm, cov


def warp_reference_plain(ref, ref_mask, u, v, covb, window):
    """Plain version of H1: warp + mask warp + coverage gate."""
    refw, cov = warp_shift_image(ref, u, v, window=window)
    refm = warp_shift_mask(ref_mask, u, v, window=window)
    return coverage_gate(u, v, covb, refw, refm, cov)


def warp_reference(ref, ref_mask, u, v, covb, window):
    """Warped reference, its mask and coverage, as one_frame leaves them
    (pipeline.py:162-180). ``ref_mask`` is int32. A CUDA tensor runs hand
    kernel H1; a CPU tensor runs the plain version."""
    if ref.is_cuda:
        return launch.warp(ref, ref_mask, u, v, covb, window)
    return warp_reference_plain(ref, ref_mask, u, v, covb, window)


def warp_epoch_plain(img, wgt, mask, u, v, covb, window):
    """Plain version of the two-plane H1, with the coadd's gate
    (pipeline.py:482-491 at ``valid = 1``): the warped pixels, weight and
    mask of one epoch and its coverage (bool). Pixels and mask are 0 where
    the epoch does not cover (a ``where``: a non-finite tap does not leak),
    the weight is clamped at 0."""
    iw, cov = warp_shift_image(img, u, v, window=window)
    ww, _ = warp_shift_image(wgt, u, v, window=window)
    mw = warp_shift_mask(mask, u, v, window=window)
    covo = ((u >= covb[0]) & (u <= covb[1])
            & (v >= covb[2]) & (v <= covb[3]))
    cov = cov * covo.to(torch.float32)
    covered = cov > 0
    return (torch.where(covered, iw, 0.0), torch.clamp(ww, min=0.0) * cov,
            torch.where(covered, mw, 0), covered)


def warp_epoch(img, wgt, mask, u, v, covb, window):
    """One coadd epoch on the output canvas: (pixels f32, weight f32, mask
    int32, coverage bool), each (H, W), as ``warp_epoch`` of the reference
    leaves them for a valid epoch (pipeline.py:482-491). A CUDA tensor runs
    hand kernel H1 once with the weight map as its second plane; a CPU
    tensor runs :func:`warp_epoch_plain`."""
    if img.is_cuda:
        iw, ww, mw, cov = launch.warp(img, mask, u, v, covb, window,
                                      ref2=wgt)
        # H1 writes 0 outside the coverage on every plane
        return iw, torch.clamp(ww, min=0.0), mw, cov > 0
    return warp_epoch_plain(img, wgt, mask, u, v, covb, window)
