"""Candidate quality cuts (twin of ``zuds_tpu/filterobjects.py:37-252``):
the reference's cut chain and printed funnel over a subtraction catalog.

A catalog from the fused pipeline carries the r=6 px aperture sums and
the negative-pixel veto as columns, so the cuts read columns only. A
catalog without them takes the frames from its image: the port's
``aperture_photometry_batched`` and :func:`_negpix_veto` on CPU tensors.
The real/bogus score (``ml=True``, braai) is ROADMAP queue 1, K19.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .constants import BAD_SUM

__all__ = ['filter_sexcat']

CUTSIZE = 11  # negpix veto box, px


def _median(x):
    """Exact median of all of ``x``, the two middle values averaged for
    an even count (``jnp.median``)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def _negpix_veto(image_data, xs, ys):
    """Negative-pixel veto (filterobjects.py:37-61): True where a < -5 sigma
    pixel sits next to a > +5 sigma one in the 11x11 box at a candidate."""
    data = torch.as_tensor(np.ascontiguousarray(image_data)
                           .astype(np.float32))
    med = _median(data)
    sig = 1.48 * _median((data - med).abs())
    H, W = data.shape
    big = CUTSIZE + 2
    xs = torch.as_tensor(np.asarray(xs, np.float32))
    ys = torch.as_tensor(np.asarray(ys, np.float32))
    x0 = torch.clamp(torch.round(xs).to(torch.int64) - big // 2, 0, W - big)
    y0 = torch.clamp(torch.round(ys).to(torch.int64) - big // 2, 0, H - big)
    ar = torch.arange(big)
    cut = data[(y0[:, None, None] + ar[None, :, None]),
               (x0[:, None, None] + ar[None, None, :])]
    s = (cut - med) / torch.clamp(sig, min=1e-12)
    # 3x3 neighbour max ('SAME', -inf padding), then the central 11x11
    m = F.max_pool2d(F.pad(s[:, None], (1, 1, 1, 1), value=-float('inf')),
                     3, 1)[:, 0]
    inner = (slice(None), slice(1, 1 + CUTSIZE), slice(1, 1 + CUTSIZE))
    return ((s[inner] < -5.0) & (m[inner] > 5.0)).flatten(1).any(1).numpy()


def filter_sexcat(cat, ml=False):
    """Quality-cut filter of a subtraction catalog, in place
    (filterobjects.py:102-252): sets GOODCUT (and RB = -99), prints the
    per-cut candidate funnel, marks the header FILTERED, saves the
    catalog if mapped, and returns it."""
    if ml:
        raise NotImplementedError(
            'filter_sexcat(ml=True), the braai real/bogus score, is not '
            'ported yet (ROADMAP queue 1: braai, K19)')
    from .ops.photometry import aperture_photometry_batched

    data = cat.data
    hdr = getattr(cat, 'header', None)
    if hdr is not None and hdr.get('FILTERED'):
        return cat
    if 'GOODCUT' in data.dtype.names and (data['GOODCUT'] != 0).any():
        return cat

    def mark_done():
        if hdr is not None:
            hdr.set('FILTERED', True, 'filter_sexcat completed')

    image = cat.image

    n = len(data)
    print('Total number of candidates: ', n, flush=True)
    if n == 0:
        mark_done()
        if cat.ismapped:
            cat.save()
        return cat

    xs = data['X_IMAGE'] - 1.0
    ys = data['Y_IMAGE'] - 1.0
    area = np.pi * 6.0 ** 2

    pre = (hdr is not None and 'RMSMED' in hdr
           and 'NEGPIX' in data.dtype.names
           and (data['NEGPIX'] >= 0).all()
           and np.isfinite(data['BPMCUT']).all())
    if pre:
        bpmcut = data['BPMCUT']
        rmscut = data['RMSCUT']
        medcut = float(hdr['RMSMED']) * 1.1
        negpix_pre = data['NEGPIX'].astype(bool)
    else:
        rms = np.asarray(image.rms_image.data)
        bpm = np.asarray(image.mask_image.boolean.data).astype(bool) \
            if image.mask_image is not None else np.zeros(rms.shape, bool)
        med = float(np.median(rms[~bpm])) if (~bpm).any() else float(
            np.median(rms))
        medcut = med * 1.1
        negpix_pre = None
        txs = torch.as_tensor(xs.astype('f4'))
        tys = torch.as_tensor(ys.astype('f4'))
        zeros_m = torch.zeros(rms.shape, dtype=torch.int32)
        rms_t = torch.as_tensor(rms.astype(np.float32))
        rms_ap = aperture_photometry_batched(
            rms_t, torch.zeros_like(rms_t), zeros_m, txs, tys, r=6.0)
        bpm_ap = aperture_photometry_batched(
            torch.as_tensor(bpm.astype(np.float32)), torch.zeros_like(rms_t),
            zeros_m, txs, tys, r=6.0)
        bpmcut = bpm_ap['flux'].numpy()
        rmscut = rms_ap['flux'].numpy() / area

    if 'SEEING' not in image.header:
        from .seeing import estimate_seeing
        estimate_seeing(image)
    see = image.header['SEEING']

    good = np.ones(n, dtype=bool)

    def funnel(label):
        print(f'Number of candidates after {label}: ', good.sum(),
              flush=True)

    good &= (data['IMAFLAGS_ISO'] & BAD_SUM) == 0
    funnel('external flag cut')
    good &= data['FLAGS'] <= 2
    funnel('internal flag cut')
    with np.errstate(divide='ignore', invalid='ignore'):
        good &= (data['A_IMAGE'] / np.maximum(data['B_IMAGE'], 1e-6)) <= 2.0
    funnel('elipticity cuts')
    good &= (data['FWHM_IMAGE'] / see) <= 2.0
    funnel('fwhm cuts')
    good &= data['FWHM_IMAGE'] >= 0.8 * see
    funnel('sharp cuts')
    good &= bpmcut <= 0
    funnel('bpm cuts')
    good &= rmscut <= medcut
    funnel('rms cuts')
    with np.errstate(divide='ignore', invalid='ignore'):
        snr = data['FLUX_APER'] / np.where(data['FLUXERR_APER'] > 0,
                                           data['FLUXERR_APER'], np.inf)
    good &= snr >= 5.0
    funnel('s/n > 5 cut')

    if good.any():
        if negpix_pre is not None:
            good &= ~negpix_pre
        else:
            veto = _negpix_veto(image.data, xs[good], ys[good])
            gidx = np.nonzero(good)[0]
            good[gidx[veto]] = False
    funnel('negpix cut')
    funnel('ML cut')

    out = data.copy()
    out['GOODCUT'] = good.astype('i2')
    out['RB'] = np.full(n, -99.0, dtype='f4')
    if not pre and 'BPMCUT' in out.dtype.names:
        out['BPMCUT'] = bpmcut
        out['RMSCUT'] = rmscut
    cat.data = out
    mark_done()
    if cat.ismapped:
        cat.save()
    return cat
