"""Source detection (twin of ``zuds_tpu/ops/detect.py``).

The matched filter and threshold run in hand kernel H4
(``kernels/detect_filter.py``, Triton), the compactions in H6
(``kernels/compact.cu``) and the deblend tree's level labels in H5
(``kernels/deblend.cu``) on a CUDA tensor; on a CPU tensor each runs its
plain version. Connected components, the ascent cells, the rest of the
deblend (``ops/deblend.py``), per-object statistics and CLEAN are plain
PyTorch on either device. ``deblend`` takes the reference's three modes:
True (the exact 32-level tree), ``'watershed'`` and False.

Float sums that cancel (second moments about a centroid) are added in the
reference's order (:func:`.ordered.segmented_scan`), so the port agrees
with the JAX package to the last bit where the summands agree.

Writes that the reference makes through padded slots (duplicate indices,
where XLA:CPU keeps the last write) go to a discard slot here, and the
value the reference leaves at the padded index is written once after, so
the result does not depend on which duplicate a device writes last.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import (CLEAN_PARAM, DEBLEND_MINCONT, DEBLEND_NTHRESH,
                         DETECT_NPIX, DETECT_NSIGMA, MAX_DETECTIONS)
from ..kernels import detect_filter as _h4
from .compact import compact_indices, scatter_into
from .convolve import DEFAULT_FILTER, conv2_same
from .deblend import cell_graph, deblend_exact, split_margins
from .ordered import fma, segmented_scan, sum_last

__all__ = ['DETECTION_FIELDS', 'compact_indices', 'seed_labels',
           'label_compact', 'matched_filter', 'matched_filter_plain',
           'ascent_cells', 'detect_sources', 'deblend_load']

DETECTION_FIELDS = [
    'x', 'y', 'x2', 'y2', 'xy', 'a', 'b', 'theta', 'elongation', 'fwhm',
    'flux', 'peak', 'npix', 'xmin', 'xmax', 'ymin', 'ymax', 'imaflags',
    'flags', 'thresh',
]

# 8-neighbour offsets (dy, dx), in the reference's adjacency order
_OFFS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
         (1, 1))
_BIG_NEG = -3e38


def matched_filter_plain(diff, rms, weight_ok, nsigma):
    """Plain version of H4 (detect.py:607-616): the good-pixel mask, the
    zeroed detection image, its 3x3 pyramid correlation and the threshold
    test. Returns (img, filt, det)."""
    good = weight_ok & (rms > 0) & torch.isfinite(diff)
    img = torch.where(good, diff, torch.zeros((), device=diff.device))
    filt = conv2_same(img, DEFAULT_FILTER)
    return img, filt, good & (filt > nsigma * rms)


def matched_filter(diff, rms, weight_ok, nsigma):
    """(img, filt, det) of the detection stage: hand kernel H4 on a CUDA
    tensor, :func:`matched_filter_plain` on a CPU tensor."""
    if diff.is_cuda:
        return _h4.detect_filter(diff, rms, weight_ok, nsigma)
    return matched_filter_plain(diff, rms, weight_ok, nsigma)


def _adjacency(pidx, pok, inv, shape):
    """Compact positions of each entry's 8 neighbours and their validity
    (detect.py:227-251, the inverse-map form)."""
    H, W = shape
    dev = pidx.device
    dy = torch.tensor([o[0] for o in _OFFS], device=dev)[:, None]
    dx = torch.tensor([o[1] for o in _OFFS], device=dev)[:, None]
    x = (pidx % W)[None]
    tgt = pidx[None] + dy * W + dx                               # (8, cap)
    ok = (pok[None] & (tgt >= 0) & (tgt < H * W)
          & ~((dx == -1) & (x <= 0)) & ~((dx == 1) & (x >= W - 1)))
    pos = inv[tgt.clamp(0, H * W - 1)]
    ok = ok & (pos >= 0)
    return pos.clamp(min=0), ok


def seed_labels(det, sweeps=12):
    """The reference's label seeds (detect.py:657-665): ``sweeps`` 3x3
    min-pool passes of flat indices over the FULL detection mask. When the
    compaction overflows, two kept pieces joined only through dropped
    pixels share a seed, so the seeds decide the overflow counters too.
    Flat indices ride in float32, exact below 2^24."""
    H, W = det.shape
    if H * W >= 1 << 24:
        raise ValueError('seed_labels: flat indices exceed exact float32')
    inf = torch.tensor(float('inf'), device=det.device)
    lab = torch.where(det, torch.arange(H * W, device=det.device,
                                        dtype=torch.float32).reshape(H, W),
                      inf)
    for _ in range(sweeps):
        pooled = -F.max_pool2d(-lab[None, None], 3, 1, 1)[0, 0]
        lab = torch.where(det, pooled, inf)
    return lab


def label_compact(nbr_pos, okb, lab):
    """8-connected components of the compact pixel list (detect.py:649-700)
    from initial labels ``lab`` (compact positions): per entry, the compact
    position of its component's smallest label, hence, from the identity,
    its minimum flat index (the reference's label).

    Shiloach-Vishkin style, as the reference: each round hooks every
    pixel's root onto the smallest neighbouring label (scatter-min) and
    compresses pointers, to a fixed point. From the same initial labels
    the fixed point is unique, so the labels equal the reference's bit
    for bit whatever the round count."""
    while True:
        cand = torch.where(okb, lab[nbr_pos], lab[None]).amin(0)
        new = lab.scatter_reduce(0, lab, torch.minimum(lab, cand), 'amin')
        for _ in range(3):
            new = torch.minimum(new, new[new])
        if torch.equal(new, lab):
            return lab
        lab = new


def ascent_cells(filt, img, pidx, pok, okb, nbr_pos):
    """Steepest-ascent watershed cells (detect.py:721-739): each compact
    pixel points to its brightest neighbour in ``filt`` when that one is
    brighter (the first of equal maxima in adjacency order, as
    ``jnp.argmax``), and 6 pointer squarings carry it to its cell's peak.
    Returns (filt_c, pos_c, cellpos): the filtered and the positive image
    values on the compact list and each pixel's peak position."""
    posidx = torch.arange(pidx.shape[0], device=pidx.device)
    filt_c = torch.where(pok, filt.reshape(-1)[pidx], 0.0)
    pos_c = torch.clamp(torch.where(pok, img.reshape(-1)[pidx], 0.0),
                        min=0.0)
    nbr_filt = torch.where(okb, filt_c[nbr_pos], _BIG_NEG)      # (8, cap)
    vbest, kbest = nbr_filt[0], torch.zeros_like(posidx)
    for k in range(1, 8):
        take = nbr_filt[k] > vbest
        vbest = torch.where(take, nbr_filt[k], vbest)
        kbest = torch.where(take, k, kbest)
    pbest = nbr_pos.gather(0, kbest[None])[0]
    cellpos = torch.where(pok & (vbest > filt_c), pbest, posidx)
    for _ in range(6):
        cellpos = cellpos[cellpos]
    return filt_c, pos_c, cellpos


def _extract(bkgsub, rms, weight_ok, nsigma, minarea, max_det, det_cap):
    """Filter, compaction, base components and DETECT_MINAREA
    (detect.py:607-711), as a dict of the compact-list state."""
    H, W = bkgsub.shape
    dev = bkgsub.device
    img, filt, det = matched_filter(bkgsub, rms, weight_ok, nsigma)

    # ---- compaction (detect.py:631-644) ----------------------------------
    cap = det_cap if det_cap else min(H * W, max(1 << 14, 32 * max_det))
    pidx, ndet_pix = compact_indices(det.reshape(-1), cap, H * W - 1)
    posidx = torch.arange(cap, device=dev)
    pok = posidx < torch.clamp(ndet_pix, max=cap)
    inv = scatter_into(H * W, pidx, pok, posidx, -1)
    # the reference's padded slots write -1 at H*W-1, the last one wins
    inv[-1] = torch.where(ndet_pix < cap, -1, inv[-1])

    # ---- base connected components ---------------------------------------
    seeds = seed_labels(det).reshape(-1)[pidx]
    seedpos = inv[torch.where(pok, seeds, 0.0).to(torch.int64)].clamp(min=0)
    nbr_pos, nbr_ok = _adjacency(pidx, pok, inv, (H, W))
    okb = nbr_ok & pok[None] & pok[nbr_pos]
    lab_p = label_compact(nbr_pos, okb, torch.where(pok, seedpos, posidx))
    comppos = torch.where(pok, lab_p, cap - 1)

    # DETECT_MINAREA on base components, at extraction (detect.py:709-711)
    npix_comp = torch.zeros(cap, device=dev).index_add_(
        0, comppos, pok.to(torch.float32))
    return {'img': img, 'filt': filt, 'cap': cap, 'pidx': pidx,
            'ndet_pix': ndet_pix, 'pok': pok, 'inv': inv,
            'nbr_pos': nbr_pos, 'nbr_ok': nbr_ok, 'okb': okb,
            'lab_c': torch.where(pok, pidx[lab_p], H * W - 1),
            'comppos': comppos,
            'big': pok & (npix_comp[comppos] >= minarea)}


def _tree_input(st, thresh_map, filt_c, pos_c, cellpos, deb_cap):
    """The exact tree's pixels, those of multi-cell base components,
    compacted to ``cap2`` slots, and the tree's arguments on them
    (detect.py:760-786)."""
    cap, pidx, pok = st['cap'], st['pidx'], st['pok']
    comppos, nbr_pos = st['comppos'], st['nbr_pos']
    dev = pidx.device
    nflat = thresh_map.numel()
    is_peak = pok & (cellpos == torch.arange(cap, device=dev))
    ncell_comp = torch.zeros(cap, dtype=torch.int64, device=dev).index_add_(
        0, comppos, is_peak.to(torch.int64))
    multi = st['big'] & (ncell_comp[comppos] >= 2)
    cap2 = deb_cap if deb_cap else min(cap, max(1 << 13, cap // 4))
    cap2 = min(cap2, cap)
    idx2, nmulti = compact_indices(multi, cap2, cap - 1)
    pos2 = torch.arange(cap2, device=dev)
    pok2 = pos2 < torch.clamp(nmulti, max=cap2)
    inv2 = scatter_into(cap, idx2, pok2, pos2, 0)
    # the reference's padded slots write at cap-1, the last one wins
    inv2[cap - 1] = torch.where(nmulti < cap2, cap2 - 1, inv2[cap - 1])
    sub = nbr_pos[:, idx2]
    thresh_c = torch.where(pok, thresh_map.reshape(-1)[pidx], 1e30)
    args = (torch.where(pok2, pidx[idx2], nflat - 1), pok2,
            torch.where(pok2, inv2[comppos[idx2]], cap2 - 1),
            torch.where(pok2, inv2[cellpos[idx2]], cap2 - 1),
            filt_c[idx2], pos_c[idx2], thresh_c[idx2], inv2[sub],
            st['nbr_ok'][:, idx2] & multi[sub] & pok2[None])
    return {'multi': multi, 'cap2': cap2, 'idx2': idx2, 'pok2': pok2,
            'nmulti': nmulti, 'args': args}


def _deblend(st, thresh_map, mode, minarea, deb_cap):
    """Per compact pixel, the flat index of its object's root after
    deblending (detect.py:713-821), which pixels the tree's capacity left
    out (``deb_ovf``, for FLAGS bit 64) and ``deblend_overflow``."""
    cap, pidx, pok = st['cap'], st['pidx'], st['pok']
    lab_c, comppos = st['lab_c'], st['comppos']
    dev = pidx.device
    nflat = thresh_map.numel()
    filt_c, pos_c, cellpos = ascent_cells(st['filt'], st['img'], pidx, pok,
                                          st['okb'], st['nbr_pos'])
    if mode == 'watershed':
        flux = torch.where(pok, pos_c, 0.0)
        zero = torch.zeros(cap, device=dev)
        f_cell = zero.index_add(0, cellpos, flux)
        n_cell = zero.index_add(0, cellpos, pok.to(torch.float32))
        f_comp = zero.index_add(0, comppos, flux)
        m_comp = torch.full((cap,), -float('inf'), device=dev).scatter_reduce(
            0, comppos, torch.where(pok, filt_c, _BIG_NEG), 'amax')
        dominant = filt_c[cellpos] >= m_comp[comppos]
        significant = ((f_cell[cellpos] >= DEBLEND_MINCONT * f_comp[comppos])
                       & (n_cell[cellpos] >= minarea) & ~dominant)
        p_c = torch.where(pok, pidx[cellpos], nflat - 1)
        return (torch.where(significant, p_c, lab_c),
                torch.zeros(cap, dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    t = _tree_input(st, thresh_map, filt_c, pos_c, cellpos, deb_cap)
    objdeep2, edge_ovf = deblend_exact(*t['args'], DEBLEND_NTHRESH,
                                       DEBLEND_MINCONT)
    key_full = scatter_into(cap, t['idx2'], t['pok2'], objdeep2, 0)
    # pixels of multi-cell components past cap2 keep their base component
    # and flag their object with bit 64
    multi, cap2, nmulti = t['multi'], t['cap2'], t['nmulti']
    in2 = multi & (torch.cumsum(multi, 0) - 1 < cap2)
    key_c = torch.where(pok, torch.where(in2, key_full, lab_c), nflat - 1)
    return (key_c, multi & ~in2,
            nmulti - torch.clamp(nmulti, max=cap2) + edge_ovf)


def detect_sources(bkgsub, rms, mask=None, weight_ok=None,
                   nsigma=DETECT_NSIGMA, minarea=DETECT_NPIX,
                   max_det=MAX_DETECTIONS, return_labels=True, deblend=True,
                   clean=True, det_cap=None, deb_cap=None):
    """Detect sources on a background-subtracted frame (detect.py:573).

    ``mask`` is an int32 bitmask, ``weight_ok`` bool. Returns the dict of
    the reference: fixed (max_det,) rows of DETECTION_FIELDS, ``valid``,
    ``n``, the three overflow counters and, with ``return_labels``, the
    (H, W) int32 segmentation map ``labels`` (0 background, 1..n objects).
    The reference's ``kernel`` (the filter is H4's 3x3 pyramid) and
    ``dbg_stop_after`` arguments are not ported.
    """
    H, W = bkgsub.shape
    dev = bkgsub.device
    if weight_ok is None:
        weight_ok = torch.ones((H, W), dtype=torch.bool, device=dev)
    if mask is None:
        mask = torch.zeros((H, W), dtype=torch.int32, device=dev)
    thresh_map = nsigma * rms
    nseg = max_det + 2
    st = _extract(bkgsub, rms, weight_ok, nsigma, minarea, max_det, det_cap)
    cap, pidx, pok, big = st['cap'], st['pidx'], st['pok'], st['big']

    # ---- deblending (detect.py:713-821) ----------------------------------
    key_c = st['lab_c']
    deb_ovf = torch.zeros(cap, dtype=torch.bool, device=dev)
    deblend_overflow = torch.zeros((), dtype=torch.int64, device=dev)
    if deblend:
        with torch.profiler.record_function('deblend'):
            key_c, deb_ovf, deblend_overflow = _deblend(
                st, thresh_map, deblend, minarea, deb_cap)

    # ---- raster-order object ids (detect.py:826-839) ---------------------
    key_c = torch.where(big, key_c, H * W - 1)
    robj = torch.cumsum(big & (pidx == key_c), 0)         # 1-based at roots
    nroots = robj[-1]
    obj_overflow = nroots - torch.clamp(nroots, max=max_det)
    rootpos = st['inv'][key_c.clamp(0, H * W - 1)].clamp(min=0)
    obj = robj[rootpos]
    obj = torch.where(obj > max_det, max_det + 1, obj)
    cid = torch.where(big, obj, nseg - 1)

    # ---- per-object statistics (detect.py:844-916) -----------------------
    vals = st['img'].reshape(-1)[pidx]
    pxx = (pidx % W).to(torch.float32)
    pyy = torch.div(pidx, W, rounding_mode='floor').to(torch.float32)
    m32 = mask.reshape(-1)[pidx].to(torch.int32)
    wnot = torch.where(weight_ok.reshape(-1)[pidx], 0, 1)
    thr = thresh_map.reshape(-1)[pidx]

    cid_s, perm = torch.sort(cid, stable=True)
    vals_s, pxx_s, pyy_s, thr_s = (a[perm] for a in (vals, pxx, pyy, thr))
    m32_s, wnot_s, debovf_s = m32[perm], wnot[perm], deb_ovf[perm]
    pos_s = torch.clamp(vals_s, min=0.0)
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       cid_s[1:] != cid_s[:-1]])

    rows = torch.arange(nseg, device=dev)
    starts = torch.searchsorted(cid_s, rows)
    ends = (torch.searchsorted(cid_s, rows + 1) - 1).clamp(0, cap - 1)
    present = (cid_s[ends] == rows) & (ends >= starts)

    def seg_stat(v, combine, empty):
        scanned = segmented_scan(v, start, combine)[:, ends]
        fill = torch.as_tensor(np.asarray(empty), dtype=v.dtype,
                               device=dev)[:, None]
        return torch.where(present[None], scanned, fill)

    adds = seg_stat(torch.stack([torch.ones_like(vals_s), vals_s, pos_s,
                                 pos_s * pxx_s, pos_s * pyy_s,
                                 pos_s * pxx_s * pxx_s,
                                 pos_s * pyy_s * pyy_s,
                                 pos_s * pxx_s * pyy_s]),
                    torch.add, np.zeros(8, np.float32))
    npix, flux, wsum, sx, sy, sxx, syy, sxy = adds
    wsum = torch.clamp(wsum, min=1e-20)
    xbar = sx / wsum
    ybar = sy / wsum
    # one rounding for "c - a*b", as the reference's CPU backend contracts
    # it: the moments cancel to ~1e-3 of their size, so a second rounding
    # would move a and b by ~1e-4
    x2 = torch.clamp(fma(-xbar, xbar, sxx / wsum), min=1.0 / 12.0)
    y2 = torch.clamp(fma(-ybar, ybar, syy / wsum), min=1.0 / 12.0)
    xy = fma(-xbar, ybar, sxy / wsum)
    maxs = seg_stat(torch.stack([vals_s, pxx_s, pyy_s,
                                 wnot_s.to(torch.float32), thr_s,
                                 debovf_s.to(torch.float32)]),
                    torch.maximum,
                    np.array([0.0, -np.inf, -np.inf, 0.0, 0.0, 0.0],
                             np.float32))
    peak, xmax, ymax, wflag, thr_at_peak, debovf_obj = maxs
    xmin, ymin = seg_stat(torch.stack([pxx_s, pyy_s]), torch.minimum,
                          np.array([np.inf, np.inf], np.float32))
    imaflags = seg_stat(m32_s[None], torch.bitwise_or,
                        np.zeros(1, np.int32))[0]
    pix_overflow = st['ndet_pix'] - pok.sum()

    # shape parameters (detect.py:918-925)
    t1 = (x2 + y2) / 2.0
    t2 = torch.sqrt(torch.clamp(((x2 - y2) / 2.0) ** 2 + xy * xy, min=0.0))
    a = torch.sqrt(torch.clamp(t1 + t2, min=1e-12))
    b = torch.sqrt(torch.clamp(t1 - t2, min=1e-12))
    theta = 0.5 * torch.atan2(2.0 * xy, x2 - y2)
    elong = a / torch.clamp(b, min=1e-12)
    fwhm = 2.0 * torch.sqrt(float(np.float32(np.log(2.0))) * (x2 + y2))

    valid = (rows >= 1) & (rows <= max_det) & (npix >= minarea)
    edge = (xmin <= 0) | (ymin <= 0) | (xmax >= W - 1) | (ymax >= H - 1)
    flags = (torch.where(wflag > 0, 1, 0) | torch.where(edge, 8, 0)
             | torch.where(debovf_obj > 0, 64, 0))
    trunc_row = torch.where(
        pix_overflow > 0,
        torch.div(pidx[-1], W, rounding_mode='floor').to(torch.float32) - 1,
        torch.tensor(float(H), device=dev))
    flags = flags | torch.where(ymax >= trunc_row, 128, 0)

    if clean:
        flux, npix, flags, valid = _clean(xbar, ybar, a, b, theta, peak,
                                          thr_at_peak, flux, npix, flags,
                                          valid)

    sl = slice(1, max_det + 1)
    out = {
        'x': xbar[sl], 'y': ybar[sl], 'x2': x2[sl], 'y2': y2[sl],
        'xy': xy[sl], 'a': a[sl], 'b': b[sl], 'theta': theta[sl],
        'elongation': elong[sl], 'fwhm': fwhm[sl], 'flux': flux[sl],
        'peak': peak[sl], 'npix': npix[sl], 'xmin': xmin[sl],
        'xmax': xmax[sl], 'ymin': ymin[sl], 'ymax': ymax[sl],
        'imaflags': imaflags[sl], 'flags': flags[sl].to(torch.int32),
        'thresh': thr_at_peak[sl],
        'pix_overflow': pix_overflow.to(torch.int32),
        'deblend_overflow': deblend_overflow.to(torch.int32),
        'obj_overflow': obj_overflow.to(torch.int32),
        'valid': valid[sl],
    }
    out['n'] = valid[sl].sum().to(torch.int32)
    if return_labels:
        # segmentation map (detect.py:1025-1033); padded slots, which the
        # reference writes 0 through at H*W-1, go to the discard slot
        keep = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                          valid[1:]])
        obj_masked = torch.where(big & keep[obj.clamp(0, max_det + 1)],
                                 obj, 0).to(torch.int32)
        seg = scatter_into(H * W, pidx, pok, obj_masked, 0)
        seg[-1] = torch.where(st['ndet_pix'] < cap, 0, seg[-1])
        out['labels'] = seg.reshape(H, W)
    return out


def deblend_load(bkgsub, rms, weight_ok=None, nsigma=DETECT_NSIGMA,
                 minarea=DETECT_NPIX,
                 max_det=MAX_DETECTIONS, det_cap=None, deb_cap=None):
    """What the exact tree of :func:`detect_sources` (``deblend=True``)
    works on for this frame, as 0-d tensors: ``multi_pixels`` (pixels of
    multi-cell components, before the cap), ``cells``, ``edges`` (cross-cell
    edges, before the cap) and ``deblend_overflow``; plus ``graph``, the
    tree's levels and edge list (:func:`.deblend.cell_graph`), and
    ``margins``, each live split decision's ratio to its threshold
    (:func:`.deblend.split_margins`)."""
    H, W = bkgsub.shape
    if weight_ok is None:
        weight_ok = torch.ones((H, W), dtype=torch.bool, device=rms.device)
    st = _extract(bkgsub, rms, weight_ok, nsigma, minarea, max_det, det_cap)
    filt_c, pos_c, cellpos = ascent_cells(st['filt'], st['img'], st['pidx'],
                                          st['pok'], st['okb'],
                                          st['nbr_pos'])
    t = _tree_input(st, nsigma * rms, filt_c, pos_c, cellpos, deb_cap)
    g = cell_graph(*t['args'][:5], t['args'][6], *t['args'][7:])
    nmulti = t['nmulti']
    return {'multi_pixels': nmulti, 'cells': g['ncell'],
            'edges': g['nedge'],
            'deblend_overflow': (nmulti - torch.clamp(nmulti, max=t['cap2'])
                                 + g['edge_overflow']),
            'graph': g, 'margins': split_margins(*t['args'])}


def _clean(xbar, ybar, a, b, theta, peak, thr_at_peak, flux, npix, flags,
           valid, blk=512):
    """SExtractor CLEAN pass (detect.py:966-1008): an object whose peak
    owes more than its threshold to brighter neighbours' Moffat wings is
    merged into its dominant contributor."""
    nseg = xbar.shape[0]
    dev = xbar.device
    rows = torch.arange(nseg, device=dev)
    denom_a = torch.clamp(a * a, min=1e-6)
    denom_b = torch.clamp(b * b, min=1e-6)
    ct, st = torch.cos(theta), torch.sin(theta)
    cxx = ct * ct / denom_a + st * st / denom_b
    cyy = st * st / denom_a + ct * ct / denom_b
    cxy = 2.0 * ct * st * (1.0 / denom_a - 1.0 / denom_b)
    peak_f = torch.where(valid, peak, 0.0)
    contrib_sum = torch.zeros(nseg, device=dev)
    best_c = torch.zeros(nseg, device=dev)
    best_j = torch.zeros(nseg, dtype=torch.int64, device=dev)
    for j0 in range(0, nseg, blk):
        j1 = min(j0 + blk, nseg)
        dx = xbar[:, None] - xbar[None, j0:j1]
        dy = ybar[:, None] - ybar[None, j0:j1]
        r2 = (cxx[None, j0:j1] * dx * dx + cyy[None, j0:j1] * dy * dy
              + cxy[None, j0:j1] * dx * dy)
        c = peak_f[None, j0:j1] * (1.0 + r2 / (2.0 * CLEAN_PARAM ** 2)) \
            ** -2.5
        ok_n = (valid[None, j0:j1] & (peak_f[None, j0:j1] > peak_f[:, None])
                & (rows[None, j0:j1] != rows[:, None]))
        c = torch.where(ok_n, c, 0.0)
        contrib_sum = contrib_sum + sum_last(c)
        blk_val, blk_best = c.max(1)
        take = blk_val > best_c
        best_c = torch.where(take, blk_val, best_c)
        best_j = torch.where(take, blk_best + j0, best_j)
    cleaned = valid & (peak - contrib_sum <= thr_at_peak)
    tgt = torch.where(cleaned, best_j, nseg - 1)
    zero = torch.zeros(nseg, device=dev)
    flux = flux + zero.index_add(0, tgt, torch.where(cleaned, flux, 0.0))
    npix = npix + zero.index_add(0, tgt, torch.where(cleaned, npix, 0.0))
    got = torch.zeros(nseg, dtype=torch.int32, device=dev).scatter_reduce(
        0, tgt, cleaned.to(torch.int32), 'amax')
    flags = flags | torch.where(got > 0, 2, 0)
    return flux, npix, flags, valid & ~cleaned
