"""Candidate filtering and the real/bogus score (twin of
``zuds_tpu/filterobjects.py``): the reference's cut chain and printed
funnel over a subtraction catalog, then braai on the survivors.

A catalog from the fused pipeline carries the r=6 px aperture sums and
the negative-pixel veto as columns, so the cuts read columns only. A
catalog without them takes the frames from its image, on the card unless
the caller asks for the CPU: the r=6 sums of ``aperture_sums`` (H22) and
:func:`_negpix_veto` (two library sorts for the medians, then the stencil
H14). At ``ml=True`` the survivors' 63x63x3 triplets (H12) are
scored by braai (``models/braai.py``, H13) and those below
``RB_CUT[fid]`` dropped.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .constants import BAD_SUM, BRAAI_MODEL, CUTOUT_SIZE, RB_CUT
from .ops.cutouts import (NEGPIX_BOX, clamped_corners, frame_median_exact,
                          negpix_veto, triplet_cut)

__all__ = ['filter_sexcat', 'make_triplet_for_braai', 'make_triplets_batch',
           'load_model_helper']

# (weights path, its mtime and size, device) -> (model, params)
_MODELS = {}


def _device(device):
    from .inputs import resolve_device
    return resolve_device(device)


def load_model_helper(path=None, model_base_name=BRAAI_MODEL, device=None):
    """braai's (model, params) on ``device`` (the card unless ``'cpu'``):
    ``<path>/<model_base_name>.npz`` if it exists, else the fresh seed-0
    init (filterobjects.py:27-34: no pretrained weights ship, so without
    that file every score comes from an untrained network). Built once per
    file state and device; a cached model gives the same scores as a new
    one."""
    from .models.braai import load_braai
    device = _device(device)
    weights = None
    key = (None, str(device))
    if path is not None:
        weights = os.path.join(path, f'{model_base_name}.npz')
        if os.path.exists(weights):
            st = os.stat(weights)
            key = (weights, st.st_mtime_ns, st.st_size, str(device))
    if key not in _MODELS:
        model, _ = load_braai(weights, device=device)
        _MODELS[key] = (model, model.params())
    return _MODELS[key]


def _upload(a, device):
    from .inputs import upload
    return upload(np.ascontiguousarray(a).astype(np.float32), device)


def _positions(xs, ys, device):
    """f32 tensors of the positions, rounded to f32 first as the
    reference's ``jnp.asarray`` of float64 does."""
    return (torch.as_tensor(np.asarray(xs, np.float32)).to(device),
            torch.as_tensor(np.asarray(ys, np.float32)).to(device))


def _negpix_veto(image_data, xs, ys, device=None):
    """Negative-pixel veto (filterobjects.py:37-61): True where a < -5 sigma
    pixel sits next to a > +5 sigma one in the 11x11 box at a candidate.
    The frame's median and 1.48 MAD are sorts on ``device`` (the card
    unless ``'cpu'``) that stay there; the per-candidate stencil is H14 on
    the card. A frame that holds a NaN has a NaN median, as jnp.median
    gives it, and then no candidate is vetoed."""
    device = _device(device)
    data = _upload(image_data, device)
    med = torch.where(data.isnan().any(), torch.nan,
                      frame_median_exact(data))
    sig = 1.48 * frame_median_exact((data - med).abs())
    H, W = data.shape
    x0, y0 = clamped_corners(*_positions(xs, ys, device), NEGPIX_BOX, H, W)
    return negpix_veto(data, med, sig, x0, y0).cpu().numpy()


def make_triplets_batch(xs, ys, new_aligned, ref_aligned, sub_aligned,
                        device=None):
    """(N, 63, 63, 3) f32 NHWC tensor on ``device`` (the card unless
    ``'cpu'``) of the L2-normalised new/ref/sub cutouts at the 0-based
    pixel positions ``xs``, ``ys`` (filterobjects.py:64-90): each window's
    corner is ``round(x) - 31`` clamped into the frame. The three frames
    share the reference frame's grid. H12 on the card."""
    device = _device(device)
    frames = [_upload(f.data, device)
              for f in (new_aligned, ref_aligned, sub_aligned)]
    H, W = frames[0].shape
    x0, y0 = clamped_corners(*_positions(xs, ys, device), CUTOUT_SIZE, H, W)
    return triplet_cut(*frames, x0, y0)


def make_triplet_for_braai(ra, dec, new_aligned, ref_aligned, sub_aligned,
                           old_norm=False, device=None):
    """One (63, 63, 3) triplet at (ra, dec) in the reference frame's grid
    (filterobjects.py:93-99)."""
    x, y = ref_aligned.wcs.sky2pix_0(ra, dec)
    return make_triplets_batch(np.atleast_1d(x), np.atleast_1d(y),
                               new_aligned, ref_aligned, sub_aligned,
                               device=device)[0]


def filter_sexcat(cat, ml=True, ml_frames=None, device=None, stats=None):
    """Quality-cut and real/bogus filter of a subtraction catalog, in place
    (filterobjects.py:102-252): sets GOODCUT and RB (-99 where unscored),
    prints the per-cut candidate funnel, marks the header FILTERED, saves
    the catalog if mapped, and returns it.

    ``ml_frames``: optional (new_aligned, ref_aligned, sub_aligned);
    otherwise aligned from ``cat.image``'s target and reference images.
    ``device``: where the frames branch and the score run, the image's
    own when None (the card unless ``'cpu'``). ``stats`` (dict, optional)
    gains ``ml_s`` (host seconds of the ML step: frames, triplets, scores)
    and ``scored`` (candidates scored)."""
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
    if device is None:
        device = getattr(image, 'device', None)

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
        from .ops.photometry import aperture_sums
        device = _device(device)
        rms = np.asarray(image.rms_image.data)
        bpm = np.asarray(image.mask_image.boolean.data).astype(bool) \
            if image.mask_image is not None else np.zeros(rms.shape, bool)
        med = float(np.median(rms[~bpm])) if (~bpm).any() else float(
            np.median(rms))
        medcut = med * 1.1
        negpix_pre = None
        txs, tys = _positions(xs, ys, device)
        # the r=6 rms and bad-pixel sums in one two-plane pass (H22)
        rms_ap, bpm_ap = aperture_sums((_upload(rms, device),
                                        _upload(bpm, device)), txs, tys,
                                       r=6.0)
        bpmcut = bpm_ap.cpu().numpy()
        rmscut = rms_ap.cpu().numpy() / area

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
            veto = _negpix_veto(image.data, xs[good], ys[good], device)
            gidx = np.nonzero(good)[0]
            good[gidx[veto]] = False
    funnel('negpix cut')

    rb = np.full(n, -99.0, dtype='f4')
    if ml and good.any():
        t0 = time.perf_counter()
        device = _device(device)
        frames = ml_frames or _ml_frames_for(image, device)
        if frames is None:
            print('filter: no aligned frames for ML; skipping rb cut',
                  flush=True)
        else:
            from .models.braai import rb_scores
            new_a, ref_a, sub_a = frames
            gidx = np.nonzero(good)[0]
            # positions in the reference frame's pixel grid
            ra = data['X_WORLD'][gidx]
            dec = data['Y_WORLD'][gidx]
            x, y = ref_a.wcs.sky2pix_0(ra, dec)
            triplets = make_triplets_batch(x, y, new_a, ref_a, sub_a,
                                           device=device)
            model, _ = load_model_helper(device=device)
            scores = rb_scores(model, triplets).cpu().numpy()
            rb[gidx] = scores
            fid = getattr(image, 'fid', None)
            cut = RB_CUT.get(fid, 0.5) if fid is not None else 0.5
            good[gidx[scores < cut]] = False
            if stats is not None:
                stats['scored'] = stats.get('scored', 0) + len(gidx)
        if stats is not None:
            stats['ml_s'] = stats.get('ml_s', 0.0) \
                + time.perf_counter() - t0
    funnel('ML cut')

    out = data.copy()
    out['GOODCUT'] = good.astype('i2')
    out['RB'] = rb
    if not pre and 'BPMCUT' in out.dtype.names:
        out['BPMCUT'] = bpmcut
        out['RMSCUT'] = rmscut
    cat.data = out
    mark_done()
    if cat.ismapped:
        cat.save()
    return cat


def _ml_frames_for(image, device=None):
    """(new, ref, sub) on the reference's grid from a subtraction object
    (filterobjects.py:255-267): its science frame and itself aligned to its
    reference, on ``device``. A deferred subtraction fetches its frames
    from the card here."""
    target = getattr(image, 'target_image', None)
    ref = getattr(image, 'reference_image', None)
    if target is None or ref is None:
        return None
    try:
        new_aligned = target.aligned_to(ref, device=device)
        sub_aligned = image.aligned_to(ref, device=device)
    except Exception as e:
        print(f'filter: alignment for ML failed ({e}); skipping', flush=True)
        return None
    return new_aligned, ref, sub_aligned
