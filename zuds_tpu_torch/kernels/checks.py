"""The checks that hold H22-H27 against their plain versions on the
same tensors, shared by ``chip_smoke.py`` and the card tests
(``tests/test_torch_kernels_cuda.py``). Each raises AssertionError at a
gap past its stated tolerance."""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import launch
from ..constants import CLEAN_PARAM
from ..ops import detect as dt
from ..ops import measure as ms
from ..ops import photometry as ph

__all__ = ['REFINE_RTOL', 'THETA_ATOL', 'sum_gap_bound', 'aperture_check',
           'refine_check', 'plain_detect', 'seeds_check', 'ccl_check',
           'stats_check', 'clean_check', 'detect_check']

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


def refine_check(img, rms, args, k, p, cut=33, counts=None):
    """H23's outputs ``k`` against the plain version's ``p`` on the same
    detections ``args`` = (xs, ys, a, b, theta, fwhm), NaN at the same
    rows, in two stages, each within R = REFINE_RTOL of its scale:
    - the windowed centroid xwin, ywin against ``p``'s, within R (|x| + 1)
      px (four iterations of sums in another order); a row past that (a
      window of noise alone about 0, where the centroid of max(noise, 0)
      amplifies the order of the sums, or a window clamped at the frame's
      edge, whose coordinates reach cut - 1 where |x| is near 0) is held
      instead to the plain version run in float64: H23 no further from it
      than ``p``, plus R (c + 1), c the window's largest coordinate on
      that axis, the scale of its sums; ``counts`` (a dict), when given,
      gets the number of such rows as ``'centroid_rows_f64'``;
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

    far = torch.zeros_like(xs, dtype=torch.bool)
    for key in ('xwin', 'ywin'):
        d = (k[key].double() - p[key].double()).abs()
        far |= ~(d <= R * (p[key].double().abs() + 1)) \
            & ~(k[key].isnan() & p[key].isnan())
    if bool(far.any()):
        rows = torch.nonzero(far).reshape(-1)
        p64 = ms.refine_detections_plain(
            img.double(), rms.double(), *(v[rows].double() for v in args),
            cut=cut)
        for key, pos, n in (('xwin', xs, img.shape[1]),
                            ('ywin', ys, img.shape[0])):
            ref = p64[key]
            # the sums' scale: the window's largest coordinate, which at
            # a clamped corner by the frame's edge far exceeds |x|
            top = (torch.round(pos[rows]).to(torch.int64) - cut // 2).clamp(
                0, n - cut) + (cut - 1)
            within(f'{key} (float64 centroid)', k[key][rows],
                   ref, (p[key][rows].double() - ref).abs()
                   + R * (top.double() + 1))
    for key in ('xwin', 'ywin'):
        within(key, k[key][~far], p[key][~far],
               R * (p[key][~far].double().abs() + 1))
    if counts is not None:
        counts['centroid_rows_f64'] = int(far.sum())
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


# H26's theta against its plain version's: atan2f of the toolkit that
# builds the kernels against the one PyTorch was built with (each within 2
# ulp of the true angle, 2 ulp of pi/2 = 2.4e-7 rad; halved by theta's 0.5
# and doubled for the two); bit-equal where the two libraries agree
THETA_ATOL = 2.4e-7
# the detect outputs held bit-equal between H24-H27 and their plain versions
DETECT_EXACT = ('labels', 'n', 'valid', 'npix', 'xmin', 'xmax', 'ymin',
                'ymax', 'imaflags', 'flags', 'pix_overflow',
                'deblend_overflow', 'obj_overflow')
DETECT_FLOATS = ('x', 'y', 'x2', 'y2', 'xy', 'a', 'b', 'elongation', 'fwhm',
                 'peak', 'thresh')


@contextlib.contextmanager
def plain_detect():
    """``ops.detect.detect_sources`` with H24-H27's plain versions on a
    CUDA tensor: the module's four dispatchers swapped for them, restored
    on exit."""
    names = ('seed_labels', 'label_compact', 'object_stats', '_clean')
    saved = [getattr(dt, n) for n in names]
    for n, f in zip(names, (dt.seed_labels_plain, dt.label_compact_plain,
                            dt.object_stats_plain, dt._clean_plain)):
        setattr(dt, n, f)
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(dt, n, f)


def _same(a, b):
    """Bit-equal, NaN where the other is NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)))


def _gap(a, b):
    d = (a.double() - b.double()).abs()
    d = d[a.isfinite() & b.isfinite()]
    return float(d.max()) if d.numel() else 0.0


def seeds_check(det, pidx, count, sweeps=12):
    """H24 on the bool mask ``det`` and its compact list ``pidx`` with
    ``count`` detected pixels: bit-equal to seed_labels_plain, two calls
    bit-identical."""
    k = launch.seed_sweeps(det, pidx, count, sweeps)
    _check(_same(k, dt.seed_labels_plain(det, pidx, count, sweeps)),
           'H24 seeds differ from the plain version\'s')
    _check(_same(k, launch.seed_sweeps(det, pidx, count, sweeps)),
           'two H24 calls differ')


def ccl_check(nbr_pos, okb, lab0):
    """H25 on one compact list: bit-equal to label_compact_plain."""
    k = launch.ccl_fixpoint(nbr_pos, okb, lab0)
    _check(_same(k, dt.label_compact_plain(nbr_pos, okb, lab0)),
           'H25 labels differ from the plain version\'s')


def stats_check(args):
    """H26 on ``object_stats``' arguments ``args``: every row field
    bit-equal to object_stats_plain's (NaN at the same rows), ``theta``
    within THETA_ATOL. Returns the largest gap of the float fields."""
    k = launch.object_stats(*args)
    p = dt.object_stats_plain(*args)
    for key in p:
        if key == 'theta':
            _check(torch.equal(k[key].isnan(), p[key].isnan())
                   and _gap(k[key], p[key]) <= THETA_ATOL,
                   f'H26 theta past {THETA_ATOL} rad')
        else:
            _check(_same(k[key], p[key]), f'H26 {key} differs from the '
                   'plain version\'s')
    return max(_gap(k[key], p[key]) for key in p if k[key].is_floating_point())


def clean_check(args):
    """H27 on CLEAN's row fields ``args`` (ops.detect.CLEAN_FIELDS) against
    _clean_plain on the same tensors: which rows are cleaned and where they
    merge, ``valid``, ``flags`` and ``npix`` bit-equal; ``flux`` bit-equal
    where nothing merged, else within sum_gap_bound(merged + 1) of the
    magnitudes added (the plain version's index_add adds in atomic order on
    the card, the kernel in ascending row order). Returns (the largest
    flux gap, the largest contribution gap relative to the row's peak: the
    kernel's powf, cosf and sinf against PyTorch's, the rows cleaned, the
    valid rows within one ulp of the CLEAN threshold)."""
    x, y, a, b, theta, peak, thr, flux, npix, flags, valid = args
    inv = float(np.float32(1.0) / np.float32(2.0 * CLEAN_PARAM ** 2))
    kf, kn, kfl, kv, kc, kt = launch.clean(*args, inv)
    pf, pn, pfl, pv = dt._clean_plain(*args)
    contrib, best_j = dt.clean_pass(x, y, a, b, theta, peak, valid)
    cleaned = valid & (peak - contrib <= thr)
    nseg = x.shape[0]
    _check(torch.equal(kv, pv) and torch.equal(valid & ~kv, cleaned),
           'H27 cleans other rows than the plain version')
    _check(torch.equal(kt.long(), torch.where(cleaned, best_j, nseg - 1)),
           'H27 merges into other rows than the plain version')
    _check(torch.equal(kfl, pfl), 'H27 flags differ')
    _check(torch.equal(kn, pn), 'H27 npix differs')
    nmerged = torch.zeros(nseg, dtype=torch.int64, device=x.device)
    nmerged = nmerged.index_add(0, kt.long(), cleaned.long())
    mag = torch.zeros_like(flux).index_add(
        0, kt.long(), torch.where(cleaned, flux.abs(), 0.0)) + flux.abs()
    tol = torch.where(nmerged > 0, mag * torch.as_tensor(
        [sum_gap_bound(int(m) + 1) for m in nmerged.tolist()],
        device=x.device), 0.0)
    gap = (kf - pf).abs()
    _check(bool((gap <= tol).all()), 'H27 flux past the merge-order bound')
    rel = ((kc - contrib).abs() / peak.abs().clamp(min=1e-30))[valid]
    ulp = (torch.nextafter(thr, torch.full_like(thr, math.inf)) - thr).abs()
    near = valid & ((peak - contrib - thr).abs() <= ulp)
    return (float(gap.max()), float(rel.max()) if rel.numel() else 0.0,
            int(cleaned.sum()), int(near.sum()))


def detect_check(k, p, clean_args):
    """detect_sources through H24-H27 (``k``) against the same call with
    their plain versions (``p``, :func:`plain_detect`): DETECT_EXACT
    bit-equal; DETECT_FLOATS bit-equal; ``theta`` within THETA_ATOL;
    ``flux`` bit-equal on rows without FLAGS bit 2, within
    sum_gap_bound(cleaned + 1) of |flux| plus the valid rows' |flux| before
    CLEAN (``clean_args``) on rows with it (the merge's order). Returns
    the largest gap of the float fields."""
    for key in DETECT_EXACT:
        if key in p:
            _check(_same(k[key], p[key]), f'detect_sources {key}: H24-H27 '
                   'against their plain versions differ')
    for key in DETECT_FLOATS:
        _check(_same(k[key], p[key]), f'detect_sources {key} differs')
    _check(_gap(k['theta'], p['theta']) <= THETA_ATOL,
           f'detect_sources theta past {THETA_ATOL} rad')
    merged = (p['flags'] & 2) != 0
    _check(_same(k['flux'][~merged], p['flux'][~merged]),
           'detect_sources flux differs on a row nothing merged into')
    if bool(merged.any()):
        valid0, flux0 = clean_args[10], clean_args[7]
        ncleaned = int(valid0.sum()) - int(p['n'])
        tol = sum_gap_bound(ncleaned + 1) * (
            p['flux'][merged].abs() + flux0[valid0].abs().sum())
        _check(bool(((k['flux'][merged] - p['flux'][merged]).abs()
                     <= tol).all()), 'detect_sources flux past the merge '
               'order\'s bound')
    return max(_gap(k[key], p[key]) for key in DETECT_FLOATS
               + ('theta', 'flux'))
