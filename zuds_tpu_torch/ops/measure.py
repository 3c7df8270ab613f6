"""Per-frame measurements (twin of ``zuds_tpu/ops/measure.py``): the
kernel-fit stamp selector with its hand kernel H7 (``kernels/stamps.cu``),
the stamp-moment seeing, and the windowed centroids and Kron photometry at
all detections of a frame at once with their hand kernel H23
(``kernels/measure.cu``). A wrapper launches its kernel on a CUDA tensor
and runs the plain version on a CPU tensor."""
from __future__ import annotations

import math

import torch

from ..kernels import launch
from .background import frame_median, masked_median
from .compact import compact_indices
from .convolve import DEFAULT_FILTER, conv2_same, dilate_max
from .ordered import fma, sum_last, sum_last2
from .photometry import cutouts

__all__ = ['stamp_candidates', 'stamp_candidates_plain',
           'select_stamps_device', 'seeing_from_stamps', 'refine_detections',
           'refine_detections_plain', 'refine_windows', 'ellipse_radius']

# candidate capacity of the stamp selector (measure.py:67)
STAMP_CAP = 4096


def stamp_candidates_plain(img, med, sigma, sat_level, margin):
    """Plain version of H7: (filt, cand), each (H, W): the 3x3 pyramid
    filter of ``img`` and its 9x9 local maxima above ``med + 10 sigma``
    (one FMA, as XLA's CPU backend contracts it), below ``sat_level`` and
    ``margin`` px inside the frame (measure.py:37-65)."""
    H, W = img.shape
    filt = conv2_same(img, DEFAULT_FILTER)
    mx = dilate_max(filt, 4)
    thr = fma(torch.tensor(10.0, device=img.device), sigma, med)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    cand = ((filt >= mx) & (filt > thr) & (img < sat_level)
            & (xx >= margin) & (xx < W - margin)
            & (yy >= margin) & (yy < H - margin))
    return filt, cand


def stamp_candidates(img, med, sigma, sat_level, margin):
    """(filt, cand) of :func:`stamp_candidates_plain`, ``filt`` defined
    only where ``cand`` is set: H7 on a CUDA tensor (``med`` and ``sigma``
    stay on the card; ``filt`` is written at the candidates only), the
    plain version on a CPU tensor."""
    if img.is_cuda:
        return launch.stamp_candidates(img, med, sigma, sat_level, margin)
    return stamp_candidates_plain(img, med, sigma, sat_level, margin)


def select_stamps_device(img, smax=384, nreg=3, sat_level=5e3, margin=32):
    """Kernel-fit star stamps with no catalog (measure.py:22-96): 9x9 local
    maxima of the 3x3-filtered frame above med + 10 sigma (H8 medians),
    below ``sat_level`` (H7), compacted in raster order into 4096 slots
    (H6), and the brightest ``smax // nreg**2`` of each of the nreg x nreg
    regions. Returns (xs, ys, valid) fixed-size (smax,) tensors on
    ``img``'s device; the host does not wait for the card.

    Ties keep ``jax.lax.top_k``'s order, lower index first (a stable sort),
    so the invalid slots get the x, y of the same padding entries."""
    H, W = img.shape
    med = frame_median(img)
    sigma = 1.4826 * frame_median(img, center=med)
    filt, cand = stamp_candidates(img, med, sigma, sat_level, margin)
    cidx, nc = compact_indices(cand.reshape(-1), STAMP_CAP, 0)
    dev = img.device
    cok = torch.arange(STAMP_CAP, device=dev) < torch.clamp(nc, max=STAMP_CAP)
    cx = (cidx % W).to(torch.int32)
    cy = (cidx // W).to(torch.int32)
    cf = torch.where(cok, filt.reshape(-1)[cidx], -math.inf)
    R2 = nreg * nreg
    per = smax // R2
    rid = (torch.clamp(cy * nreg // H, 0, nreg - 1) * nreg
           + torch.clamp(cx * nreg // W, 0, nreg - 1))
    fr = torch.where(rid[None, :] == torch.arange(R2, device=dev)[:, None],
                     cf[None, :], -math.inf)
    top, ti = torch.sort(fr, dim=1, descending=True, stable=True)
    top, ti = top[:, :per], ti[:, :per]
    xs = cx[ti].to(torch.float32).reshape(-1)
    ys = cy[ti].to(torch.float32).reshape(-1)
    valid = torch.isfinite(top).reshape(-1)
    pad = smax - R2 * per
    if pad:
        xs = torch.cat([xs, torch.zeros(pad, device=dev)])
        ys = torch.cat([ys, torch.zeros(pad, device=dev)])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool,
                                              device=dev)])
    return xs, ys, valid


def _sum(x, dims):
    """Sum over trailing ``dims`` (1 or 2): the reference's order on the
    CPU (see :mod:`.ordered`), ``torch.sum`` on the card."""
    if x.is_cuda:
        return x.sum(tuple(range(-dims, 0)))
    return sum_last(x) if dims == 1 else sum_last2(x)


def seeing_from_stamps(img, xs, ys, valid, cut=25, nuse=64):
    """Median stamp-moment FWHM over the first ``nuse`` stamps, 2.0 when
    none is valid (measure.py:99-131). An even count averages the two
    middle values, as ``jnp.nanmedian`` does (``torch.nanmedian`` takes the
    lower one). Returns a 0-d f32 tensor on ``img``'s device."""
    H, W = img.shape
    half = cut // 2
    xs, ys, valid = xs[:nuse], ys[:nuse], valid[:nuse]
    xi = torch.clamp(torch.round(xs).to(torch.int64) - half, 0, W - cut)
    yi = torch.clamp(torch.round(ys).to(torch.int64) - half, 0, H - cut)
    sub = cutouts(img[None], xi, yi, cut)[0]
    edge = (_sum(sub[:, 0], 1) + _sum(sub[:, -1], 1) + _sum(sub[:, :, 0], 1)
            + _sum(sub[:, :, -1], 1)) / (4 * cut)
    pos = torch.clamp(sub - edge[:, None, None], min=0.0)
    ar = torch.arange(cut, dtype=torch.float32, device=img.device)
    yy, xx = ar[:, None], ar[None, :]
    tot = torch.clamp(_sum(pos, 2), min=1e-20)
    cx = _sum(pos * xx, 2) / tot
    cy = _sum(pos * yy, 2) / tot
    x2 = _sum(pos * (xx - cx[:, None, None]) ** 2, 2) / tot
    y2 = _sum(pos * (yy - cy[:, None, None]) ** 2, 2) / tot
    fw = 2.0 * torch.sqrt(math.log(2.0) * (x2 + y2))
    ok = valid & ~torch.isnan(fw)
    med = masked_median(fw, ok, dim=0)
    return torch.where(ok.any(), med, torch.tensor(2.0, device=img.device))

KRON_FACT = 2.5          # PHOT_AUTOPARAMS[0]
KRON_MIN_RADIUS = 3.5    # PHOT_AUTOPARAMS[1]
KRON_INT_RADIUS = 6.0    # integration ellipse for the Kron radius moment


def _sqrt0(x, floor):
    return torch.sqrt(torch.clamp(x, min=floor))


def _col(v):
    return v[:, None, None]


def refine_windows(img, rms, xs, ys, cut=33):
    """The (N, cut, cut) windows of ``img`` and ``rms`` at the clamped
    rounded corners about (xs, ys), and their pixels' x and y."""
    H, W = img.shape
    half = cut // 2
    x0 = torch.clamp(torch.round(xs).to(torch.int64) - half, 0, W - cut)
    y0 = torch.clamp(torch.round(ys).to(torch.int64) - half, 0, H - cut)
    sub, sub_r = cutouts(torch.stack([img, rms]), x0, y0, cut)
    ar = torch.arange(cut, dtype=torch.float32, device=img.device)
    yy = y0.to(torch.float32)[:, None, None] + ar[None, :, None]
    xx = x0.to(torch.float32)[:, None, None] + ar[None, None, :]
    return sub, sub_r, xx, yy


def ellipse_radius(xx, yy, xwin, ywin, a, b, theta):
    """r_ell of the window pixels ``xx``, ``yy`` about (xwin, ywin) in the
    ellipse (a, b, theta), a and b floored at 0.5 (measure.py:219-227)."""
    ct, st = _col(torch.cos(theta)), _col(torch.sin(theta))
    dxw, dyw = xx - _col(xwin), yy - _col(ywin)
    xr = dxw * ct + dyw * st
    yr = -dxw * st + dyw * ct
    return torch.sqrt((xr / _col(torch.clamp(a, min=0.5))) ** 2
                      + (yr / _col(torch.clamp(b, min=0.5))) ** 2)


def refine_detections_plain(img, rms, xs, ys, a, b, theta, fwhm, cut=33):
    """Plain version of H23: windowed centroids, windowed shapes and
    errors, Kron radius and AUTO flux at each detection
    (measure.py:139-244). Returns dict of (N,) arrays: xwin, ywin,
    kron_radius, flux_auto, fluxerr_auto, awin, bwin, thetawin, errawin,
    errbwin, errthetawin."""
    sub, sub_r, xx, yy = refine_windows(img, rms, xs, ys, cut)
    pos = torch.clamp(sub, min=0.0)
    two_s2 = _two_s2(fwhm)
    xwin, ywin = xs, ys
    for _ in range(4):
        w = torch.exp(-((xx - _col(xwin)) ** 2 + (yy - _col(ywin)) ** 2)
                      / two_s2) * pos
        tot = torch.clamp(sum_last2(w), min=1e-20)
        xwin, ywin = sum_last2(w * xx) / tot, sum_last2(w * yy) / tot
    return _refine_at(sub, sub_r, xx, yy, pos, two_s2, xwin, ywin, a, b,
                      theta)


def _two_s2(fwhm):
    """2 s^2 of the centroid's Gaussian window, s = max(2 fwhm / 2.355,
    1), as an (N, 1, 1) column."""
    swin = _col(torch.clamp(fwhm / 2.355 * 2.0, min=1.0))
    return 2 * swin * swin


def _refine_at(sub, sub_r, xx, yy, pos, two_s2, xwin, ywin, a, b, theta):
    """The windowed moments and their errors, the Kron radius and the
    AUTO sums about (xwin, ywin) of the windows ``sub``, ``sub_r`` (pixels
    ``xx``, ``yy``, ``pos`` = max(sub, 0)) (measure.py:185-244)."""
    col = _col
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
    r_ell = ellipse_radius(xx, yy, xwin, ywin, a, b, theta)
    wflux = torch.where(r_ell <= KRON_INT_RADIUS, pos, 0.0)
    rkron = sum_last2(wflux * r_ell) / torch.clamp(sum_last2(wflux),
                                                   min=1e-20)
    rkron = torch.maximum(rkron, KRON_MIN_RADIUS / KRON_FACT
                          / torch.clamp(a, min=0.5))
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


def refine_detections(img, rms, xs, ys, a, b, theta, fwhm, cut=33):
    """The measurements of :func:`refine_detections_plain`: H23 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if img.is_cuda:
        return launch.refine_detections(
            img.contiguous(), rms.contiguous(),
            *(t.contiguous() for t in (xs, ys, a, b, theta, fwhm)), cut)
    return refine_detections_plain(img, rms, xs, ys, a, b, theta, fwhm, cut)
