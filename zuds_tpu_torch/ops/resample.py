"""Lanczos-3 reference warp (twin of ``zuds_tpu/ops/resample.py``).

Plain PyTorch versions of the main path's warp functions, and
:func:`warp_reference` and :func:`warp_epoch`, which run the fused hand
kernel H1 (``kernels/warp.cu``) on a CUDA tensor and the plain composition
on a CPU tensor: one float plane and a mask for the subtraction's
reference, two float planes (pixels and weight) and a mask for a coadd's
epoch.

The per-pair align's gather warps :func:`warp_image`, :func:`warp_mask`
and :func:`warp_image_mask` (any mapping, a source of any shape) run hand
kernel H10 (the second kernel of ``kernels/warp.cu``) on a CUDA tensor and
their ``*_plain`` versions on a CPU tensor; :func:`plan_warp` is the host's
integer pre-shift plan and :func:`warp_planned` its windowed execution
(H1 on the rolled canvas).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import launch

__all__ = ['SUPPORT', 'lanczos3', 'upsample_mapping', 'warp_shift_image',
           'warp_shift_mask', 'coverage_gate', 'warp_reference',
           'warp_reference_plain', 'warp_epoch', 'warp_epoch_plain',
           'warp_image', 'warp_mask', 'warp_image_mask', 'warp_image_plain',
           'warp_mask_plain', 'warp_image_mask_plain', 'warp_gather',
           'box_mask_or', 'plan_warp', 'warp_planned']

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


def _shift_or(m, k, dim):
    """m | m shifted by +-k along ``dim``, the edges padded with 0
    (resample.py:141)."""
    n = m.shape[dim]
    z = torch.zeros_like(m.narrow(dim, 0, k))
    up = torch.cat([m.narrow(dim, k, n - k), z], dim)
    dn = torch.cat([z, m.narrow(dim, 0, n - k)], dim)
    return m | up | dn


def box_mask_or(mask, reach=7):
    """(2 reach + 1)^2 sliding bitwise-OR dilation of an integer mask by
    log-doubling shifts, edges padded with 0 (resample.py:154): each pixel
    gets the OR of every mask pixel within ``reach`` of it. No path of the
    pipeline runs it; plain torch, bit-equal to the reference."""
    out = mask
    covered, step = 0, 1
    while covered < reach:
        k = min(step, reach - covered)
        for dim in (0, 1):
            out = _shift_or(out, k, dim)
        covered += k
        step = covered + 1
    return out


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


def _tap_indices(u, v, src_shape):
    """Integer tap origin, phase and full-support coverage of a gather
    warp (resample.py:73). The floor is kept inside what an int32 holds; a
    mapping that far out is uncovered either way."""
    Hs, Ws = src_shape
    fiu = torch.floor(u).clamp(-2.0 ** 30, 2.0 ** 30)
    fiv = torch.floor(v).clamp(-2.0 ** 30, 2.0 ** 30)
    iu = fiu.to(torch.int64)
    iv = fiv.to(torch.int64)
    inb = ((iu - (SUPPORT - 1) >= 0) & (iu + SUPPORT <= Ws - 1)
           & (iv - (SUPPORT - 1) >= 0) & (iv + SUPPORT <= Hs - 1))
    return iu, iv, u - fiu, v - fiv, inb


def _gather_plain(planes, mask, u, v):
    """The 36-tap gather of the reference's three warps on any device:
    weights ``lanczos3(fu - dx) * lanczos3(fv - dy)`` summed in tap order
    (rows outer) as the normaliser, indices clamped to the frame, the mask
    OR over the taps whose two weights pass the interval test. Returns
    (warped planes, warped mask or None, coverage f32)."""
    src = planes[0] if planes else mask
    Hs, Ws = src.shape
    iu, iv, fu, fv, inb = _tap_indices(u, v, (Hs, Ws))
    iu_c = iu.clamp(SUPPORT - 1, Ws - 1 - SUPPORT)
    iv_c = iv.clamp(SUPPORT - 1, Hs - 1 - SUPPORT)
    accs = [torch.zeros(u.shape, dtype=torch.float32, device=u.device)
            for _ in planes]
    wacc = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    macc = None if mask is None else torch.zeros(u.shape, dtype=mask.dtype,
                                                 device=u.device)
    taps = range(-SUPPORT + 1, SUPPORT + 1)
    wxs = [lanczos3(fu - dx) for dx in taps] if planes else None
    sxs = [_sig_lanczos(fu - dx) for dx in taps] if mask is not None else None
    for dy in taps:
        rows = iv_c + dy
        wy = lanczos3(fv - dy) if planes else None
        takey = _sig_lanczos(fv - dy) if mask is not None else None
        for j, dx in enumerate(taps):
            cols = iu_c + dx
            if planes:
                w = wxs[j] * wy
                for k, img in enumerate(planes):
                    accs[k] = accs[k] + img[rows, cols] * w
                wacc = wacc + w
            if mask is not None:
                macc = macc | torch.where(takey & sxs[j], mask[rows, cols],
                                          torch.zeros_like(macc))
    cov = inb.to(torch.float32)
    norm = torch.where(wacc == 0, torch.ones_like(wacc), wacc)
    # out * cov in the reference, which XLA folds into this select
    outs = [torch.where(inb, acc / norm, 0.0) for acc in accs]
    if mask is not None:
        macc = torch.where(inb, macc, torch.zeros_like(macc))
    return outs, macc, cov


def warp_image_plain(img, u, v):
    """Plain version of :func:`warp_image`."""
    (out,), _, cov = _gather_plain([img], None, u, v)
    return out, cov


def warp_mask_plain(mask, u, v):
    """Plain version of :func:`warp_mask`."""
    return _gather_plain([], mask, u, v)[1]


def warp_image_mask_plain(img, mask, u, v):
    """Plain version of :func:`warp_image_mask`. The reference thresholds
    the computed weights (``abs(w) > sqrt(5e-3)``, resample.py:496, :505)
    where :func:`warp_mask` tests the intervals they were solved into; the
    two agree except within a rounding of an interval edge. This takes the
    interval test, as hand kernel H10 does, so the three gather warps give
    one mask."""
    (out,), m, cov = _gather_plain([img], mask, u, v)
    return out, m, cov


def warp_gather(img, mask, u, v, img2=None):
    """The gather warp of up to two float planes and a mask that share one
    mapping: (warped ``img``, warped ``img2``, warped ``mask``, coverage),
    None where the input was None. A CUDA tensor runs hand kernel H10 once;
    a CPU tensor runs the plain version."""
    if u.is_cuda:
        return launch.warp_gather(
            None if img is None else img.contiguous(),
            None if mask is None else mask.contiguous(),
            u.contiguous(), v.contiguous(),
            img2=None if img2 is None else img2.contiguous())
    planes = [p for p in (img, img2) if p is not None]
    outs, m, cov = _gather_plain(planes, mask, u, v)
    outs = outs + [None] * (2 - len(outs))
    return outs[0], outs[1], m, cov


def warp_image(img, u, v):
    """Lanczos-3 gather warp of ``img`` (Hs, Ws) to the grid of the source
    coordinates ``u``, ``v`` (resample.py:86). Returns (warped, coverage):
    coverage is 1.0 where the full 6x6 support lay inside the source, and
    the warped pixels are 0 outside it. The reference writes the product
    ``out * cov``, which XLA folds into a select on the coverage test, so
    a non-finite source pixel in a clamped window outside the coverage
    gives 0 there, and here. A CUDA tensor runs hand kernel H10."""
    out, _, _, cov = warp_gather(img, None, u, v)
    return out, cov


def warp_mask(mask, u, v):
    """Conservative bitmask gather warp (resample.py:116): the OR of the
    source mask (int32) over the taps whose column and row weights each
    exceed sqrt(5e-3) in magnitude, 0 outside the coverage. A CUDA tensor
    runs hand kernel H10."""
    return warp_gather(None, mask, u, v)[2]


def warp_image_mask(img, mask, u, v):
    """Pixels and mask in one gather warp (resample.py:484). Returns (img,
    mask, cov). A CUDA tensor runs hand kernel H10 once. See
    :func:`warp_image_mask_plain` for the mask's significance test."""
    out, _, m, cov = warp_gather(img, mask, u, v)
    return out, m, cov


def plan_warp(grid, out_shape, src_shape, max_window=8):
    """Host-side warp plan (resample.py:512): the mapping as an integer
    median offset plus a small residual displacement. Returns (du0, dv0,
    window), or None when the residual exceeds ``max_window`` or the rolled
    reads would leave the canvas (callers fall back to the gather warp)."""
    import math
    Hs, Ws = src_shape
    Ho, Wo = out_shape
    step = grid.step
    gx = np.arange(grid.u.shape[1], dtype=float) * step
    gy = np.arange(grid.v.shape[0], dtype=float) * step
    u = np.asarray(grid.u, float)
    v = np.asarray(grid.v, float)
    val = ((u >= SUPPORT - 1) & (u <= Ws - SUPPORT)
           & (v >= SUPPORT - 1) & (v <= Hs - SUPPORT))
    if not val.any():
        return None
    du = u - gx[None, :]
    dv = v - gy[:, None]
    du0 = int(round(float(np.median(du[val]))))
    dv0 = int(round(float(np.median(dv[val]))))
    resid = max(np.abs(du[val] - du0).max(), np.abs(dv[val] - dv0).max())
    if resid > max_window:
        return None
    window = max(2, 2 * math.ceil(resid / 2))
    pad = window + SUPPORT
    us = u[val] - du0
    vs = v[val] - dv0
    if (us.min() < pad or us.max() > Wo - pad - 1
            or vs.min() < pad or vs.max() > Ho - pad - 1):
        return None
    return du0, dv0, window


def warp_planned(img, mask, u, v, plan, out_shape, img2=None):
    """Execute a :func:`plan_warp` plan (resample.py:556): embed the source
    in an output-shaped canvas, remove the integer offset with a roll, warp
    the residual within the plan's window, and gate by the original frame's
    coverage rule. Returns (warped, warped mask, coverage); the coverage is
    the original-frame rule alone, as the reference returns it, while the
    pixels and mask are gated by that and the canvas rule. With a second
    plane ``img2``: (warped, warped img2, warped mask, coverage). A CUDA
    tensor runs hand kernel H1 on the rolled canvas with the coverage
    bounds shifted by the offset; a CPU tensor the plain composition."""
    du0, dv0, window = plan
    Ho, Wo = out_shape
    Hs, Ws = img.shape
    h, w = min(Hs, Ho), min(Ws, Wo)

    def canvas(src):
        c = torch.zeros((Ho, Wo), dtype=src.dtype, device=src.device)
        c[:h, :w] = src[:h, :w]
        return torch.roll(c, (-dv0, -du0), dims=(0, 1))

    us, vs = u - du0, v - dv0
    cov = ((u >= SUPPORT - 1) & (u <= Ws - SUPPORT)
           & (v >= SUPPORT - 1) & (v <= Hs - SUPPORT)).to(torch.float32)
    if img.is_cuda:
        covb = torch.tensor([SUPPORT - 1 - du0, Ws - SUPPORT - du0,
                             SUPPORT - 1 - dv0, Hs - SUPPORT - dv0],
                            dtype=torch.float32, device=img.device)
        res = launch.warp(canvas(img.to(torch.float32)), canvas(mask),
                          us.contiguous(), vs.contiguous(), covb, window,
                          ref2=None if img2 is None
                          else canvas(img2.to(torch.float32)))
        # H1 wrote 0 where either rule fails
        return res[:-1] + (cov,)
    zero = torch.zeros((), dtype=mask.dtype)
    outs = [warp_shift_image(canvas(p.to(torch.float32)), us, vs,
                             window=window)[0] * cov
            for p in (img, img2) if p is not None]
    mw = torch.where(cov > 0, warp_shift_mask(canvas(mask), us, vs,
                                              window=window), zero)
    return (*outs, mw, cov)
