"""Astrometric refinement (twin of ``zuds_tpu/scamp.py``; the reference is
zuds/scamp.py, which forks SCAMP against GAIA-DR2 LDAC catalogs at
DISTORT_DEGREES 3).

The same catalog-space operation on the host, in float64 numpy as there:
a few hundred stars an epoch need no kernel. Each image's stars (its
catalog, detected on the image's device by
``PipelineFITSCatalog.from_image``) are matched to an astrometric reference
(a Gaia cache file, else the first image's stars) by a grid-hash nearest
neighbour within 2 arcsec, and the TPV polynomial is refit to
``distort_degree`` (3, as SCAMP) by sigma-clipped weighted least squares;
below twice its parameter count in matches the linear CD/CRPIX refit runs
instead. The formulas and their order are the reference's, so that on the
same catalogs the refit WCS is bit-equal (``tests/test_torch_scamp.py``).
"""
from __future__ import annotations

import copy
import os

import numpy as np

from .secrets import get_secret

__all__ = ['calibrate_astrometry', 'match_catalogs', 'fit_wcs_correction',
           'fit_tpv_correction']


def match_catalogs(ra1, dec1, ra2, dec2, radius_arcsec=2.0):
    """Nearest-neighbour sky match within ``radius_arcsec``
    (scamp.py:25-72): a grid hash of cell ``radius_arcsec`` on a local flat
    projection, RA offsets wrapped at 0/360. Returns (idx1, idx2), the
    rows of the first catalog that matched and their partners; of equally
    near partners the last one in the cell scan wins."""
    ra1 = np.atleast_1d(np.asarray(ra1, float))
    dec1 = np.atleast_1d(np.asarray(dec1, float))
    ra2 = np.atleast_1d(np.asarray(ra2, float))
    dec2 = np.atleast_1d(np.asarray(dec2, float))
    if len(ra1) == 0 or len(ra2) == 0:
        return np.array([], int), np.array([], int)

    # local flat projection around the joint centre (fields are <~2 deg)
    dec0 = 0.5 * (np.median(dec1) + np.median(dec2))
    cosd = np.cos(np.radians(dec0))
    ra0 = np.median(ra2)
    u1 = (np.mod(ra1 - ra0 + 180.0, 360.0) - 180.0) * cosd * 3600.0
    u2 = (np.mod(ra2 - ra0 + 180.0, 360.0) - 180.0) * cosd * 3600.0
    v1 = dec1 * 3600.0
    v2 = dec2 * 3600.0

    cell = radius_arcsec
    buckets = {}
    for j in range(len(u2)):
        key = (int(np.floor(u2[j] / cell)), int(np.floor(v2[j] / cell)))
        buckets.setdefault(key, []).append(j)

    idx1, idx2 = [], []
    r2 = radius_arcsec * radius_arcsec
    for i in range(len(u1)):
        ci = int(np.floor(u1[i] / cell))
        cj = int(np.floor(v1[i] / cell))
        best, bestd = -1, r2
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for j in buckets.get((ci + di, cj + dj), ()):
                    du = u1[i] - u2[j]
                    dv = v1[i] - v2[j]
                    d = du * du + dv * dv
                    if d <= bestd:
                        best, bestd = j, d
        if best >= 0:
            idx1.append(i)
            idx2.append(best)
    return np.asarray(idx1, int), np.asarray(idx2, int)


def fit_wcs_correction(wcs, x, y, ra_true, dec_true):
    """A copy of ``wcs`` with CD and CRPIX refit by linear least squares
    so that the 1-based pixels (x, y) map onto (ra_true, dec_true)
    (scamp.py:75-100). CRVAL and the PV polynomials are kept."""
    from .wcs.tpv import _tan_project
    wcs = copy.deepcopy(wcs)
    dx = np.asarray(x, float) - wcs.crpix[0]
    dy = np.asarray(y, float) - wcs.crpix[1]
    xi_t, eta_t = _tan_project(ra_true, dec_true, wcs.crval[0], wcs.crval[1])
    # [xi eta] = A [dx dy 1]
    A = np.stack([dx, dy, np.ones_like(dx)], axis=1)
    cx, *_ = np.linalg.lstsq(A, xi_t, rcond=None)
    cy, *_ = np.linalg.lstsq(A, eta_t, rcond=None)
    wcs.cd = np.array([[cx[0], cx[1]], [cy[0], cy[1]]])
    # the constant terms go into CRPIX (CRVAL stays the tangent point)
    cdinv = np.linalg.inv(wcs.cd)
    off = cdinv @ np.array([cx[2], cy[2]])
    wcs.crpix = wcs.crpix - off
    return wcs


# TPV term indices by total degree (the radial |r| terms are left out:
# SCAMP's distortion is a polynomial in (xi, eta) alone)
_TPV_DEG_IDX = {0: [0], 1: [1, 2], 2: [4, 5, 6], 3: [7, 8, 9, 10]}


def fit_tpv_correction(wcs, x, y, ra_true, dec_true, degree=3,
                       clip_sigma=3.0, clip_iters=2, weights=None):
    """A copy of ``wcs`` whose PV polynomials are refit to ``degree``
    against the matched standards, SCAMP's DISTORT_DEGREES
    (scamp.py:107-165): CD, CRPIX and CRVAL kept, the PV terms (constant
    and linear ones among them) solved on the tangent plane by linear
    least squares with ``clip_iters`` rounds of a ``clip_sigma`` clip of
    the residuals about their median (a MAD sigma). ``weights``: optional
    (N,) inverse variances (SCAMP's 1/ERRAWIN_IMAGE^2); each row is scaled
    by sqrt(w) in the solve."""
    from .wcs.tpv import NUM_PV, _tan_project, tpv_terms
    wcs = copy.deepcopy(wcs)
    idx = []
    for d in range(degree + 1):
        idx.extend(_TPV_DEG_IDX[d])
    idx = np.asarray(idx, int)

    dx = np.asarray(x, float) - wcs.crpix[0]
    dy = np.asarray(y, float) - wcs.crpix[1]
    xi = wcs.cd[0, 0] * dx + wcs.cd[0, 1] * dy
    eta = wcs.cd[1, 0] * dx + wcs.cd[1, 1] * dy
    xi_t, eta_t = _tan_project(ra_true, dec_true, wcs.crval[0], wcs.crval[1])

    if weights is None:
        sw = np.ones(len(dx))
    else:
        sw = np.sqrt(np.clip(np.asarray(weights, float), 0.0, None))
        if not np.any(sw > 0):
            sw = np.ones(len(dx))

    M1 = tpv_terms(xi, eta)[:, idx]
    M2 = tpv_terms(eta, xi)[:, idx]
    keep = np.ones(len(dx), bool)
    for _ in range(clip_iters + 1):
        k = keep & (sw > 0)
        c1, *_ = np.linalg.lstsq(M1[k] * sw[k, None], xi_t[k] * sw[k],
                                 rcond=None)
        c2, *_ = np.linalg.lstsq(M2[k] * sw[k, None], eta_t[k] * sw[k],
                                 rcond=None)
        r = np.hypot(M1 @ c1 - xi_t, M2 @ c2 - eta_t)
        sig = 1.4826 * np.median(np.abs(r[keep] - np.median(r[keep]))) \
            + 1e-12
        new_keep = r <= np.median(r[keep]) + clip_sigma * sig
        if new_keep.sum() < len(idx) * 2:
            break
        keep = new_keep
    pv1 = np.zeros(NUM_PV)
    pv2 = np.zeros(NUM_PV)
    pv1[idx] = c1
    pv2[idx] = c2
    wcs.pv1 = pv1
    wcs.pv2 = pv2
    return wcs


def _gaia_cache(ra, dec):
    """(ra, dec) of the cached astrometric standards near (ra, dec): the
    file ``gaia_{int(ra)}_{int(dec)}.npz`` under the config's
    ``gaia_cache_directory`` (scamp.py:168-176), or None."""
    cache_dir = os.path.expanduser(str(
        get_secret('gaia_cache_directory', '~/.zuds-tpu-gaia')))
    path = os.path.join(cache_dir, f'gaia_{int(ra)}_{int(dec)}.npz')
    if os.path.exists(path):
        d = np.load(path)
        return d['ra'], d['dec']
    return None


def calibrate_astrometry(images, scamp_kws=None, inplace=False,
                         tmpdir='/tmp', reference_catalog=None,
                         distort_degree=3):
    """Refit the WCS of each image against an astrometric catalog
    (scamp.py:179-245). Returns the refit WCS objects, in order.

    ``reference_catalog``: optional (ra, dec) arrays; else the Gaia cache
    near the first image's centre, else the first image's own stars. Each
    image's stars come from ``image.catalog`` (``seeing.select_stars``):
    built by ``PipelineFITSCatalog.from_image`` on ``image.device`` (the
    card unless ``'cpu'``) when the image has none. An image with fewer
    than 5 stars or 5 matches keeps its WCS. With at least twice the
    polynomial's parameters in matches the PV terms are refit to
    ``distort_degree`` (weighted by 1/ERRAWIN_IMAGE^2, the errors floored
    at their 5th percentile), else CD and CRPIX. ``inplace``: the image
    takes its refit WCS (its header cards with it) and, when mapped to a
    file, is saved. ``scamp_kws`` and ``tmpdir`` are the reference's and
    unused, as there."""
    from .seeing import select_stars

    images = list(images)
    if reference_catalog is None:
        first = images[0]
        cached = _gaia_cache(first.ra, first.dec)
        if cached is not None:
            ref_ra, ref_dec = cached
        else:
            stars = select_stars(images[0].catalog)
            ref_ra = stars['X_WORLD']
            ref_dec = stars['Y_WORLD']
    else:
        ref_ra, ref_dec = reference_catalog

    corrected = []
    for im in images:
        stars = select_stars(im.catalog)
        if len(stars) < 5:
            corrected.append(im.wcs)
            continue
        i1, i2 = match_catalogs(stars['X_WORLD'], stars['Y_WORLD'],
                                ref_ra, ref_dec)
        if len(i1) < 5:
            corrected.append(im.wcs)
            continue
        nparams = sum(len(_TPV_DEG_IDX[d]) for d in range(distort_degree + 1))
        # inverse-variance weights from the windowed positional errors
        wts = None
        names = getattr(stars.dtype, 'names', None) or ()
        if 'ERRAWIN_IMAGE' in names:
            err = np.asarray(stars['ERRAWIN_IMAGE'][i1], float)
            good = np.isfinite(err) & (err > 0)
            if good.any():
                floor = max(np.percentile(err[good], 5), 1e-4)
                wts = np.where(good, 1.0 / np.maximum(err, floor) ** 2, 0.0)
        if distort_degree >= 2 and len(i1) >= 2 * nparams:
            new_wcs = fit_tpv_correction(
                im.wcs, stars['X_IMAGE'][i1], stars['Y_IMAGE'][i1],
                np.asarray(ref_ra)[i2], np.asarray(ref_dec)[i2],
                degree=distort_degree, weights=wts)
        else:
            new_wcs = fit_wcs_correction(
                im.wcs, stars['X_IMAGE'][i1], stars['Y_IMAGE'][i1],
                np.asarray(ref_ra)[i2], np.asarray(ref_dec)[i2])
        corrected.append(new_wcs)
        if inplace:
            im.wcs = new_wcs
            if im.ismapped:
                im.save()
    return corrected
