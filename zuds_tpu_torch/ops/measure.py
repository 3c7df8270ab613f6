"""Windowed centroids and Kron photometry at detections (twin of
``zuds_tpu/ops/measure.py:refine_detections``); plain PyTorch on either
device, all detections of a frame at once."""
from __future__ import annotations

import torch

from .ordered import sum_last2
from .photometry import cutouts

__all__ = ['refine_detections']

KRON_FACT = 2.5          # PHOT_AUTOPARAMS[0]
KRON_MIN_RADIUS = 3.5    # PHOT_AUTOPARAMS[1]
KRON_INT_RADIUS = 6.0    # integration ellipse for the Kron radius moment


def _sqrt0(x, floor):
    return torch.sqrt(torch.clamp(x, min=floor))


def refine_detections(img, rms, xs, ys, a, b, theta, fwhm, cut=33):
    """Windowed centroids, windowed shapes and errors, Kron radius and AUTO
    flux at each detection (measure.py:139-244). Returns dict of (N,)
    arrays: xwin, ywin, kron_radius, flux_auto, fluxerr_auto, awin, bwin,
    thetawin, errawin, errbwin, errthetawin."""
    H, W = img.shape
    half = cut // 2
    x0 = torch.clamp(torch.round(xs).to(torch.int64) - half, 0, W - cut)
    y0 = torch.clamp(torch.round(ys).to(torch.int64) - half, 0, H - cut)
    sub, sub_r = cutouts(torch.stack([img, rms]), x0, y0, cut)
    ar = torch.arange(cut, dtype=torch.float32, device=img.device)
    yy = y0.to(torch.float32)[:, None, None] + ar[None, :, None]
    xx = x0.to(torch.float32)[:, None, None] + ar[None, None, :]
    pos = torch.clamp(sub, min=0.0)

    def col(v):
        return v[:, None, None]

    swin = col(torch.clamp(fwhm / 2.355 * 2.0, min=1.0))
    two_s2 = 2 * swin * swin
    xwin, ywin = xs, ys
    for _ in range(4):
        w = torch.exp(-((xx - col(xwin)) ** 2 + (yy - col(ywin)) ** 2)
                      / two_s2) * pos
        tot = torch.clamp(sum_last2(w), min=1e-20)
        xwin, ywin = sum_last2(w * xx) / tot, sum_last2(w * yy) / tot

    dxw, dyw = xx - col(xwin), yy - col(ywin)
    g = torch.exp(-(dxw ** 2 + dyw ** 2) / two_s2)
    wI = g * pos
    wsum = torch.clamp(sum_last2(wI), min=1e-20)
    x2w = torch.clamp(sum_last2(wI * dxw * dxw) / wsum, min=1.0 / 12.0)
    y2w = torch.clamp(sum_last2(wI * dyw * dyw) / wsum, min=1.0 / 12.0)
    xyw = sum_last2(wI * dxw * dyw) / wsum
    t1w = (x2w + y2w) / 2.0
    t2w = _sqrt0(((x2w - y2w) / 2.0) ** 2 + xyw * xyw, 0.0)
    g2v = g * g * sub_r * sub_r
    w2 = wsum * wsum
    ex2 = sum_last2(g2v * dxw * dxw) / w2
    ey2 = sum_last2(g2v * dyw * dyw) / w2
    exy = sum_last2(g2v * dxw * dyw) / w2
    et1 = (ex2 + ey2) / 2.0
    et2 = _sqrt0(((ex2 - ey2) / 2.0) ** 2 + exy * exy, 0.0)

    # Kron radius inside the KRON_INT_RADIUS ellipse, then the AUTO flux
    ct, st = col(torch.cos(theta)), col(torch.sin(theta))
    xr = dxw * ct + dyw * st
    yr = -dxw * st + dyw * ct
    ai_s = torch.clamp(a, min=0.5)
    bi_s = torch.clamp(b, min=0.5)
    r_ell = torch.sqrt((xr / col(ai_s)) ** 2 + (yr / col(bi_s)) ** 2)
    wflux = torch.where(r_ell <= KRON_INT_RADIUS, pos, 0.0)
    rkron = sum_last2(wflux * r_ell) / torch.clamp(sum_last2(wflux),
                                                   min=1e-20)
    rkron = torch.maximum(rkron, KRON_MIN_RADIUS / KRON_FACT / ai_s)
    ap = r_ell <= col(KRON_FACT * rkron)
    return {
        'xwin': xwin, 'ywin': ywin, 'kron_radius': rkron,
        'flux_auto': sum_last2(torch.where(ap, sub, 0.0)),
        'fluxerr_auto': torch.sqrt(sum_last2(torch.where(ap, sub_r * sub_r,
                                                         0.0))),
        'awin': _sqrt0(t1w + t2w, 1e-12), 'bwin': _sqrt0(t1w - t2w, 1e-12),
        'thetawin': 0.5 * torch.atan2(2.0 * xyw, x2w - y2w),
        'errawin': _sqrt0(et1 + et2, 1e-20),
        'errbwin': _sqrt0(et1 - et2, 1e-20),
        'errthetawin': 0.5 * torch.atan2(2.0 * exy, ex2 - ey2),
    }
