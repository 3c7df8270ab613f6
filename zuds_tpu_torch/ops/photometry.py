"""Aperture photometry (twin of ``zuds_tpu/ops/photometry.py``).

Every source of a frame is measured at once from fixed-size cutouts
gathered into an (N, cut, cut) stack; plain PyTorch on either device.
"""
from __future__ import annotations

import math

import torch

from ..constants import APERTURE_RADIUS_PX
from .ordered import sum_last2

__all__ = ['circle_pixel_overlap', 'aperture_photometry_batched',
           'cutouts']


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


def aperture_photometry_batched(img, rms, mask, xs, ys,
                                r=APERTURE_RADIUS_PX, cut=None):
    """Circular-aperture photometry at (xs, ys) (photometry.py:64).
    ``mask`` is an int32 bitmask. Returns dict of (N,) arrays ``flux``,
    ``fluxerr``, ``area``, ``flags`` (OR of the mask bits under the
    aperture) and ``oob``."""
    H, W = img.shape
    if cut is None:
        cut = 2 * int(math.ceil(r)) + 3
    half = cut // 2
    xi = torch.round(xs).to(torch.int64)
    yi = torch.round(ys).to(torch.int64)
    oob = ((xi - half < 0) | (xi + half >= W)
           | (yi - half < 0) | (yi + half >= H))
    x0 = torch.clamp(xi - half, 0, W - cut)
    y0 = torch.clamp(yi - half, 0, H - cut)
    sub, sub_r = cutouts(torch.stack([img, rms]), x0, y0, cut)
    sub_m = cutouts(mask[None], x0, y0, cut)[0]
    ar = torch.arange(cut, dtype=torch.float32, device=img.device)
    yy = y0.to(torch.float32)[:, None, None] + ar[None, :, None]
    xx = x0.to(torch.float32)[:, None, None] + ar[None, None, :]
    w = circle_pixel_overlap(xx - xs[:, None, None], yy - ys[:, None, None],
                             float(r)).clamp(0.0, 1.0)
    inap = w > 0
    flags = torch.zeros_like(xi, dtype=torch.int32)
    for bit in range(18):
        has = (inap & (((sub_m >> bit) & 1) > 0)).flatten(1).any(1)
        flags = flags | (has.to(torch.int32) << bit)
    return {'flux': sum_last2(sub * w),
            'fluxerr': torch.sqrt(sum_last2(sub_r * sub_r * w)),
            'area': sum_last2(w), 'flags': flags, 'oob': oob}
