"""The checks that hold H22 and H23 against their plain versions on the
same tensors, shared by ``chip_smoke.py`` and the card tests
(``tests/test_torch_kernels_cuda.py``). Each raises AssertionError at a
gap past its stated tolerance."""
from __future__ import annotations

import math

import torch

from . import launch
from ..ops import measure as ms
from ..ops import photometry as ph

__all__ = ['REFINE_RTOL', 'sum_gap_bound', 'aperture_check', 'refine_check']

# H23 against its plain version: the relative gap of its sums (another
# order over 1089 pixels, carried through four centroid iterations)
REFINE_RTOL = 1e-5


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def _close(name, got, want, rtol, atol):
    """Max abs error of ``got`` against ``want``; fail past rtol/atol."""
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    _check(bad == 0, f'{name}: {bad} elements past rtol={rtol} atol={atol}'
           f' (max abs err {float(err.max()) if err.numel() else 0:.3g})')
    return float(err.max()) if err.numel() else 0.0


def sum_gap_bound(n):
    """Relative bound of the gap between two f32 sums of the same n
    terms in two orders: each lies within (n - 1) u of the sum of the
    terms' magnitudes (u = 2^-24), and a square root rounds once more."""
    return 2 * (n - 1) * 2.0 ** -24 + 4 * 2.0 ** -24


def aperture_check(img, rms, mask, xs, ys, r, tag):
    """H22 at (xs, ys) against its plain version on the same tensors:
    ``oob``, ``flags`` and every pixel's overlap ``w`` bit-equal; ``flux``
    within sum_gap_bound(cut^2) of sum |img| w, ``fluxerr^2`` and ``area``
    within it relative (their terms are all positive). Returns the largest
    absolute gap of flux, fluxerr and area."""
    cut = ph.aperture_cut(r)
    k = launch.aperture_photometry(img, rms, mask, xs, ys, r, cut,
                                   weights=True)
    p = ph.aperture_photometry_batched_plain(img, rms, mask, xs, ys, r)
    H, W = img.shape
    x0, y0, _ = ph.aperture_corners(xs, ys, H, W, cut)
    w = ph.aperture_weights(xs, ys, x0, y0, r, cut)
    _check(torch.equal(k['w'].isnan(), w.isnan())
           and torch.equal(k['w'].nan_to_num(7.0), w.nan_to_num(7.0)),
           f'{tag}: H22 overlaps differ from the plain version\'s')
    _check(torch.equal(k['oob'], p['oob']), f'{tag}: H22 oob differs')
    _check(torch.equal(k['flags'], p['flags']), f'{tag}: H22 flags differ')
    rel = sum_gap_bound(cut * cut)
    scale = ph.aperture_photometry_batched_plain(img.abs(), None, None, xs,
                                                 ys, r)['flux']
    gap = (k['flux'] - p['flux']).abs()
    bad = int((gap > rel * scale).sum())
    _check(bad == 0, f'{tag}: H22 flux past {rel:.3g} sum |img| w at '
           f'{bad} rows')
    err = max(float(gap.max()) if len(gap) else 0.0,
              _close(f'{tag}: H22 fluxerr^2', k['fluxerr'] ** 2,
                     p['fluxerr'] ** 2, rel, 0.0),
              _close(f'{tag}: H22 area', k['area'], p['area'], rel, 0.0))
    return err


def refine_check(img, rms, args, k, p, cut=33):
    """H23's outputs ``k`` against the plain version's ``p`` on the same
    detections ``args`` = (xs, ys, a, b, theta, fwhm), NaN at the same
    rows, in two stages, each within R = REFINE_RTOL of its scale:
    - the windowed centroid xwin, ywin against ``p``'s, within R (|x| + 1)
      px (four iterations of sums in another order);
    - every other output against the plain formulas taken at H23's own
      centroid (``_plain_at_centroid``; the moments move to first order
      with the centroid, which is checked above): awin^2, bwin^2 within
      R awin^2 (errawin^2, errbwin^2 within R errawin^2); thetawin
      (errthetawin), mod pi, within R (a^2 + b^2) / (a^2 - b^2) + 1e-6
      rad, the angle's condition; kron_radius within R rkron (r_ell is
      then bit-equal, so no pixel crosses r_ell = 6); flux_auto within
      R sum |img| over either aperture plus the |img| of the pixels that
      lie between the two AUTO edges 2.5 rkron (fluxerr_auto^2 likewise
      with rms^2).
    Returns (each output's largest gap against ``p``, the rows with
    a pixel within 1e-5 of an ellipse edge, the rows where a pixel lies
    between the two AUTO edges)."""
    xs, ys, a, b, theta, fwhm = args
    R = REFINE_RTOL
    q = _plain_at_centroid(img, rms, args, k['xwin'], k['ywin'], cut)
    for key in k:
        _check(torch.equal(k[key].isnan(), p[key].isnan())
               and torch.equal(k[key].isnan(), q[key].isnan()),
               f'refine_detections {key}: NaN at other rows')

    def within(key, got, want, tol):
        d = (got.double() - want.double()).abs()
        bad = ~(d <= tol) & ~(got.isnan() & want.isnan())
        _check(not bool(bad.any()), f'refine_detections {key}: '
               f'{int(bad.sum())} rows past the tolerance (gap '
               f'{float(d[bad].max()) if bad.any() else 0:.3g})')

    def tot(x):
        return x.double().flatten(1).sum(1)

    for key in ('xwin', 'ywin'):
        within(key, k[key], p[key], R * (p[key].double().abs() + 1))
    f64 = {key: v.double() for key, v in q.items()}
    for big, key in (('awin', 'awin'), ('awin', 'bwin'),
                     ('errawin', 'errawin'), ('errawin', 'errbwin')):
        within(key, k[key] ** 2, q[key] ** 2, R * f64[big] ** 2 + 1e-12)
    for key, (ka, kb) in (('thetawin', ('awin', 'bwin')),
                          ('errthetawin', ('errawin', 'errbwin'))):
        a2, b2 = f64[ka] ** 2, f64[kb] ** 2
        d = (k[key].double() - f64[key]).abs() % math.pi
        d = torch.minimum(d, math.pi - d)
        within(key, d, torch.where(d.isnan(), d, 0.0),
               R * (a2 + b2) / (a2 - b2).clamp(min=1e-300) + 1e-6)
    within('kron_radius', k['kron_radius'], q['kron_radius'],
           R * f64['kron_radius'])
    sub, sub_r, xx, yy = ms.refine_windows(img, rms, xs, ys, cut)
    r_ell = ms.ellipse_radius(xx, yy, k['xwin'], k['ywin'], a, b, theta)
    apk = r_ell <= (ms.KRON_FACT * k['kron_radius'])[:, None, None]
    apq = r_ell <= (ms.KRON_FACT * q['kron_radius'])[:, None, None]
    either, flip = apk | apq, apk != apq
    within('flux_auto', k['flux_auto'], q['flux_auto'],
           R * tot(torch.where(either, sub.abs(), 0.0))
           + tot(torch.where(flip, sub.abs(), 0.0)))
    within('fluxerr_auto^2', k['fluxerr_auto'] ** 2, q['fluxerr_auto'] ** 2,
           R * tot(torch.where(either, sub_r ** 2, 0.0))
           + tot(torch.where(flip, sub_r ** 2, 0.0)))
    edge = (ms.KRON_FACT * q['kron_radius'])[:, None, None]
    near = (((r_ell - ms.KRON_INT_RADIUS).abs() <= 1e-5)
            | ((r_ell - edge).abs() <= 1e-5)).flatten(1).any(1)
    gaps = {}
    for key in k:
        d = (k[key] - p[key]).abs()
        if key in ('thetawin', 'errthetawin'):
            d = torch.minimum(d % math.pi, math.pi - d % math.pi)
        gaps[key] = float(torch.nan_to_num(d, 0.0).max()) if d.numel() \
            else 0.0
    return gaps, int(near.sum()), int(flip.flatten(1).any(1).sum())


def _plain_at_centroid(img, rms, args, xwin, ywin, cut):
    """The outputs of ``refine_detections_plain`` past its centroid
    iterations, taken at the given windowed centroid (xwin, ywin): the
    plain formulas that follow the centroid, on their own."""
    xs, ys, a, b, theta, fwhm = args
    sub, sub_r, xx, yy = ms.refine_windows(img, rms, xs, ys, cut)
    return ms._refine_at(sub, sub_r, xx, yy, torch.clamp(sub, min=0.0),
                         ms._two_s2(fwhm), xwin, ywin, a, b, theta)
