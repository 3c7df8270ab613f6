"""Aperture photometry (twin of ``zuds_tpu/ops/photometry.py``).

Every source of a frame is measured at once. A wrapper launches the hand
kernel H22 (``kernels/photometry.cu``: one warp per source) on a CUDA
tensor and runs the plain version, which gathers fixed-size cutouts into
an (N, cut, cut) stack, on a CPU tensor.
"""
from __future__ import annotations

import math

import torch

from ..constants import APERTURE_RADIUS_PX
from ..kernels import launch
from .ordered import sum_last2

__all__ = ['circle_pixel_overlap', 'aperture_cut', 'aperture_corners',
           'aperture_weights', 'aperture_photometry_batched',
           'aperture_photometry_batched_plain', 'aperture_sums',
           'aperture_sums_plain', 'cutouts']


def _quad_area(x, y, r):
    """Area of {u in [0,x], v in [0,y], u^2+v^2 <= r^2} for x, y >= 0
    (photometry.py:26)."""
    x = torch.minimum(x, r)
    y = torch.minimum(y, r)
    xc = torch.sqrt(torch.clamp(r * r - y * y, min=0.0))
    x1 = torch.minimum(x, xc)
    x2 = x

    def arc_int(t):
        t = torch.minimum(torch.clamp(t, min=0.0), r)
        return 0.5 * (t * torch.sqrt(torch.clamp(r * r - t * t, min=0.0))
                      + r * r * torch.asin(torch.clamp(
                          t / torch.clamp(r, min=1e-30), -1.0, 1.0)))

    rect = y * x1
    arc = torch.where(x2 > x1, arc_int(x2) - arc_int(x1), 0.0)
    return rect + arc


def circle_pixel_overlap(dx, dy, r):
    """Exact overlap area of the unit pixel centred at (dx, dy) from the
    circle centre with a circle of radius ``r`` (photometry.py:45)."""
    r = torch.as_tensor(r, dtype=dx.dtype, device=dx.device)
    x0, x1 = dx - 0.5, dx + 0.5
    y0, y1 = dy - 0.5, dy + 0.5

    def signed(x, y):
        return torch.sign(x) * torch.sign(y) * _quad_area(x.abs(), y.abs(), r)

    return signed(x1, y1) - signed(x0, y1) - signed(x1, y0) + signed(x0, y0)


def cutouts(planes, x0, y0, cut):
    """(k, N, cut, cut) stack of the ``cut`` x ``cut`` windows at corners
    (x0, y0) of each (H, W) plane in ``planes`` (a (k, H, W) tensor)."""
    W = planes.shape[-1]
    ar = torch.arange(cut, device=planes.device)
    flat = ((y0[:, None, None] + ar[None, :, None]) * W
            + x0[:, None, None] + ar[None, None, :])
    return planes.reshape(planes.shape[0], -1)[:, flat]


def aperture_cut(r):
    """The window side of a radius-``r`` aperture: 2 ceil(r) + 3
    (photometry.py:82)."""
    return 2 * int(math.ceil(r)) + 3


def aperture_corners(xs, ys, H, W, cut):
    """int64 corners of the ``cut`` windows about the rounded positions
    (half to even, as ``jnp.round``), clamped into the frame, and ``oob``
    where the window about the rounded position leaves it."""
    half = cut // 2
    xi = torch.round(xs).to(torch.int64)
    yi = torch.round(ys).to(torch.int64)
    oob = ((xi - half < 0) | (xi + half >= W)
           | (yi - half < 0) | (yi + half >= H))
    return (torch.clamp(xi - half, 0, W - cut),
            torch.clamp(yi - half, 0, H - cut), oob)


def aperture_weights(xs, ys, x0, y0, r, cut):
    """(N, cut, cut) overlaps, clamped to [0, 1], of the pixels of the
    windows at corners ``x0``, ``y0`` with the radius-``r`` circles about
    ``xs``, ``ys``."""
    ar = torch.arange(cut, dtype=torch.float32, device=xs.device)
    yy = y0.to(torch.float32)[:, None, None] + ar[None, :, None]
    xx = x0.to(torch.float32)[:, None, None] + ar[None, None, :]
    return circle_pixel_overlap(xx - xs[:, None, None], yy - ys[:, None, None],
                                float(r)).clamp(0.0, 1.0)


def aperture_photometry_batched_plain(img, rms, mask, xs, ys,
                                      r=APERTURE_RADIUS_PX, cut=None):
    """Plain version of H22: circular-aperture photometry at (xs, ys)
    (photometry.py:64). ``rms`` (None: zeros) is the per-pixel sigma,
    ``mask`` an int32 bitmask (None: zeros). Returns a dict of (N,)
    tensors ``flux``, ``fluxerr``, ``area``, ``flags`` (OR of the 18 mask
    bits under the aperture) and ``oob``."""
    H, W = img.shape
    cut = cut or aperture_cut(r)
    if rms is None:
        rms = torch.zeros_like(img)
    if mask is None:
        mask = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    x0, y0, oob = aperture_corners(xs, ys, H, W, cut)
    sub, sub_r = cutouts(torch.stack([img, rms]), x0, y0, cut)
    sub_m = cutouts(mask[None], x0, y0, cut)[0]
    w = aperture_weights(xs, ys, x0, y0, r, cut)
    inap = w > 0
    flags = torch.zeros_like(x0, dtype=torch.int32)
    for bit in range(18):
        has = (inap & (((sub_m >> bit) & 1) > 0)).flatten(1).any(1)
        flags = flags | (has.to(torch.int32) << bit)
    return {'flux': sum_last2(sub * w),
            'fluxerr': torch.sqrt(sum_last2(sub_r * sub_r * w)),
            'area': sum_last2(w), 'flags': flags, 'oob': oob}


def aperture_photometry_batched(img, rms, mask, xs, ys,
                                r=APERTURE_RADIUS_PX, cut=None):
    """The photometry of :func:`aperture_photometry_batched_plain`: H22 on
    a CUDA tensor, the plain version on a CPU tensor."""
    if img.is_cuda:
        return launch.aperture_photometry(
            img.contiguous(), None if rms is None else rms.contiguous(),
            None if mask is None else mask.contiguous(), xs.contiguous(),
            ys.contiguous(), r, cut or aperture_cut(r))
    return aperture_photometry_batched_plain(img, rms, mask, xs, ys, r, cut)


def aperture_sums_plain(planes, xs, ys, r=6.0, cut=None):
    """Plain version of H22's two-plane mode: (sum a w, sum b w) over the
    radius-``r`` apertures at (xs, ys) of the two (H, W) planes
    ``planes = (a, b)``: the pipeline's r=6 rms and bad-pixel sums
    (pipeline.py:306-328), no flags."""
    a, b = planes
    H, W = a.shape
    cut = cut or aperture_cut(r)
    x0, y0, _ = aperture_corners(xs, ys, H, W, cut)
    sa, sb = cutouts(torch.stack([a, b]), x0, y0, cut)
    w = aperture_weights(xs, ys, x0, y0, r, cut)
    return sum_last2(sa * w), sum_last2(sb * w)


def aperture_sums(planes, xs, ys, r=6.0, cut=None):
    """The sums of :func:`aperture_sums_plain`: H22 on CUDA tensors, the
    plain version on CPU tensors."""
    a, b = planes
    if a.is_cuda:
        return launch.aperture_sums(a.contiguous(), b.contiguous(),
                                    xs.contiguous(), ys.contiguous(), r,
                                    cut or aperture_cut(r))
    return aperture_sums_plain(planes, xs, ys, r, cut)
