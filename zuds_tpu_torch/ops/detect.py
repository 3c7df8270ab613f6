"""Source detection (twin of ``zuds_tpu/ops/detect.py``).

The matched filter and threshold run in hand kernel H4
(``kernels/detect_filter.cu``), the compactions in H6
(``kernels/compact.cu``), the deblend tree's level labels in H5
(``kernels/deblend.cu``), the label seeds in H24 and the base components
in H25 (``kernels/ccl.cu``), the per-object statistics in H26 and CLEAN in
H27 (``kernels/objects.cu``) on a CUDA tensor; on a CPU tensor each runs
its plain version (``*_plain`` beside its wrapper). The adjacency, the
ascent cells, the rest of the deblend (``ops/deblend.py``) and the object
ids are plain PyTorch on either device. ``deblend`` takes the reference's
three modes: True (the exact 32-level tree), ``'watershed'`` and False.
On the card the ``ccl``, ``stats`` and ``clean`` ranges read nothing back
to the host.

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
from ..kernels import launch
from .compact import compact_indices, scatter_into
from .convolve import DEFAULT_FILTER, conv2_same
from .deblend import cell_graph, deblend_exact, split_margins
from .ordered import fma, segmented_scan, sum_last

__all__ = ['DETECTION_FIELDS', 'compact_indices', 'seed_labels',
           'seed_labels_plain', 'seed_frame_plain', 'label_compact',
           'label_compact_plain',
           'label_compact_rounds', 'label_components', 'matched_filter',
           'matched_filter_plain', 'ascent_cells', 'object_stats',
           'object_stats_plain', 'clean_pass', 'detect_sources',
           'detect_taps', 'deblend_load']

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
        return launch.detect_filter(diff, rms, weight_ok, nsigma)
    return matched_filter_plain(diff, rms, weight_ok, nsigma)


def _adjacency(pidx, pok, inv, shape):
    """Compact positions of each entry's 8 neighbours and their validity
    (detect.py:227-251, the inverse-map form)."""
    H, W = shape
    # _OFFS as arithmetic on the card (a tensor built from a list would be
    # a host copy that waits for the card): the 3x3 window's cells in
    # row-major order, the centre skipped
    k = torch.arange(8, device=pidx.device)[:, None]
    k = k + (k >= 4).to(k.dtype)
    dy, dx = k // 3 - 1, k % 3 - 1
    x = (pidx % W)[None]
    tgt = pidx[None] + dy * W + dx                               # (8, cap)
    ok = (pok[None] & (tgt >= 0) & (tgt < H * W)
          & ~((dx == -1) & (x <= 0)) & ~((dx == 1) & (x >= W - 1)))
    pos = inv[tgt.clamp(0, H * W - 1)]
    ok = ok & (pos >= 0)
    return pos.clamp(min=0), ok


def seed_frame_plain(det, sweeps=12):
    """The reference's label seeds (detect.py:657-665): ``sweeps`` 3x3
    min-pool passes of flat indices over the FULL detection mask, (H, W)
    f32, +inf off ``det``. When the compaction overflows, two kept pieces
    joined only through dropped pixels share a seed, so the seeds decide
    the overflow counters too. Flat indices ride in float32, exact below
    2^24."""
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


def seed_labels_plain(det, pidx, count, sweeps=12):
    """Plain version of H24: the seeds of :func:`seed_frame_plain` at the
    compact list ``pidx`` of ``det`` (:func:`compact_indices`' (cap,)
    indices) whose first ``count`` entries (the 0-d count of detected
    pixels, at most cap of them listed) are listed, +inf past them: the
    only entries the callers read."""
    seeds = seed_frame_plain(det, sweeps).reshape(-1)[pidx]
    listed = torch.arange(pidx.shape[0], device=pidx.device) < count
    return torch.where(listed, seeds, float('inf'))


def seed_labels(det, pidx, count, sweeps=12):
    """(cap,) f32 label seeds of the bool mask ``det`` at its compact list
    ``pidx`` with ``count`` detected pixels (:func:`seed_labels_plain`):
    hand kernel H24 on a CUDA tensor (all sweeps in one launch, only the
    listed entries' seeds written, bit-equal), the plain version on a CPU
    tensor."""
    if det.is_cuda:
        return launch.seed_sweeps(det, pidx, count, sweeps)
    return seed_labels_plain(det, pidx, count, sweeps)


def _sv_rounds(nbr_pos, okb, lab):
    """The reference's hook-and-compress rounds (detect.py:667-700), each
    round's labels in turn until a round changes nothing: each round hooks
    every pixel's root onto the smallest neighbouring label (scatter-min)
    and compresses pointers. Waits for the card once a round."""
    while True:
        cand = torch.where(okb, lab[nbr_pos], lab[None]).amin(0)
        new = lab.scatter_reduce(0, lab, torch.minimum(lab, cand), 'amin')
        for _ in range(3):
            new = torch.minimum(new, new[new])
        if torch.equal(new, lab):
            return
        lab = new
        yield lab


def label_compact_plain(nbr_pos, okb, lab):
    """Plain version of H25: 8-connected components of the compact pixel
    list (detect.py:649-700) from initial labels ``lab`` (compact
    positions): per entry, the compact position of its component's
    smallest label, hence, from the identity, its minimum flat index (the
    reference's label).

    Shiloach-Vishkin style, as the reference, to the fixed point. From the
    same initial labels the fixed point is unique, so the labels equal the
    reference's bit for bit whatever the round count; the reference stops
    after 64 rounds (detect.py:685-687), this loop has no cap
    (:func:`label_compact_rounds` counts them)."""
    for lab in _sv_rounds(nbr_pos, okb, lab):
        pass
    return lab


def label_compact_rounds(nbr_pos, okb, lab):
    """How many rounds of :func:`label_compact_plain` change the labels:
    the reference, whose loop is the same round (detect.py:667-700),
    reaches the fixed point within its 64 rounds when this is at most
    64."""
    return sum(1 for _ in _sv_rounds(nbr_pos, okb, lab))


def label_compact(nbr_pos, okb, lab):
    """The fixed point of :func:`label_compact_plain` for the (8, n) int64
    neighbour positions ``nbr_pos``, their bool validity ``okb`` and the
    (n,) int64 initial labels ``lab`` (each at most its own position, as
    the seeds are): hand kernel H25 on a CUDA tensor (a union-find with no
    host read), the plain version on a CPU tensor.

    Input contract: ``okb`` is :func:`_adjacency`'s over a raster-ordered
    compact list in which every detected pixel before a listed one is also
    listed: :func:`_extract` and :func:`label_components` are its only
    supported producers. H25 unites the backward half of the edges alone,
    so for any other neighbour graph its labels differ from the plain
    version's, with no error."""
    if lab.is_cuda:
        return launch.ccl_fixpoint(nbr_pos, okb, lab)
    return label_compact_plain(nbr_pos, okb, lab)


def label_components(det, max_rounds=32, sweeps=8, hops=1):
    """8-connected labels of the bool mask ``det`` (detect.py:175): int32,
    INT_MAX off ``det``, else the flat index of the component's smallest
    pixel. The full-frame compaction (H6 at capacity H*W), ``sweeps`` seed
    sweeps (H24, at most 12: its halo) and the union-find (H25) give the
    fixed point itself;
    the reference iterates sweeps and ``hops`` pointer jumps for at most
    ``max_rounds`` rounds, so the two agree wherever the reference reaches
    its fixed point (``max_rounds`` and ``hops`` change nothing here)."""
    H, W = det.shape
    n = H * W
    flat = det.reshape(-1)
    pidx, ndet = compact_indices(flat, n, n - 1)
    posidx = torch.arange(n, device=det.device)
    pok = posidx < ndet
    inv = scatter_into(n, pidx, pok, posidx, -1)
    seeds = seed_labels(det, pidx, ndet, min(sweeps, 12))
    seedpos = inv[torch.where(pok, seeds, 0.0).to(torch.int64)].clamp(min=0)
    nbr_pos, nbr_ok = _adjacency(pidx, pok, inv, (H, W))
    okb = nbr_ok & pok[None] & pok[nbr_pos]
    lab = label_compact(nbr_pos, okb, torch.where(pok, seedpos, posidx))
    return scatter_into(n, pidx, pok, pidx[lab].to(torch.int32),
                        np.iinfo(np.int32).max).reshape(H, W)


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
    with torch.profiler.record_function('ccl'):
        seeds = seed_labels(det, pidx, ndet_pix)
        seedpos = inv[torch.where(pok, seeds, 0.0).to(torch.int64)].clamp(
            min=0)
        nbr_pos, nbr_ok = _adjacency(pidx, pok, inv, (H, W))
        okb = nbr_ok & pok[None] & pok[nbr_pos]
        lab0 = torch.where(pok, seedpos, posidx)
        lab_p = label_compact(nbr_pos, okb, lab0)
        comppos = torch.where(pok, lab_p, cap - 1)

        # DETECT_MINAREA on base components, at extraction
        # (detect.py:709-711)
        npix_comp = torch.zeros(cap, device=dev).index_add_(
            0, comppos, pok.to(torch.float32))
    return {'img': img, 'filt': filt, 'det': det, 'cap': cap, 'pidx': pidx,
            'ndet_pix': ndet_pix, 'pok': pok, 'inv': inv,
            'nbr_pos': nbr_pos, 'nbr_ok': nbr_ok, 'okb': okb, 'lab0': lab0,
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


def object_stats_plain(cid, pidx, vals, mask_c, wok_c, thr, deb_ovf,
                       ndet_pix, shape, nseg, minarea, max_det):
    """Plain version of H26: the per-object statistics (detect.py:840-953)
    of the compact list, object ``cid`` (int64, in [0, nseg)) per entry,
    with its flat index ``pidx``, detection-image value ``vals``, mask bits
    ``mask_c`` (int32), weight ``wok_c`` (bool), threshold ``thr`` and
    deblend-overflow bit ``deb_ovf``; ``ndet_pix`` (0-d) counts the
    detected pixels before the cap. Returns the (nseg,) rows of
    DETECTION_FIELDS (``imaflags`` and ``flags`` int32) and ``valid``.

    One stable sort by object, then segmented scans in the reference's
    pairing: the sums cancel (``x2 = sxx / wsum - xbar^2``), so their
    order is what keeps them bit-equal to the reference."""
    H, W = shape
    cap = cid.shape[0]
    dev = cid.device
    pxx = (pidx % W).to(torch.float32)
    pyy = torch.div(pidx, W, rounding_mode='floor').to(torch.float32)
    wnot = torch.where(wok_c, 0, 1)

    cid_s, perm = torch.sort(cid, stable=True)
    vals_s, pxx_s, pyy_s, thr_s = (a[perm] for a in (vals, pxx, pyy, thr))
    m32_s, wnot_s, debovf_s = mask_c[perm], wnot[perm], deb_ovf[perm]
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
    pix_overflow = ndet_pix - torch.clamp(ndet_pix, max=cap)

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
    return {'x': xbar, 'y': ybar, 'x2': x2, 'y2': y2, 'xy': xy, 'a': a,
            'b': b, 'theta': theta, 'elongation': elong, 'fwhm': fwhm,
            'flux': flux, 'peak': peak, 'npix': npix, 'xmin': xmin,
            'xmax': xmax, 'ymin': ymin, 'ymax': ymax, 'imaflags': imaflags,
            'flags': flags.to(torch.int32), 'thresh': thr_at_peak,
            'valid': valid}


def object_stats(cid, pidx, vals, mask_c, wok_c, thr, deb_ovf, ndet_pix,
                 shape, nseg, minarea, max_det):
    """The per-object rows of :func:`object_stats_plain`: hand kernel H26
    on a CUDA tensor (a stable counting sort, each row's sums formed from
    its own sorted span in the scan's pairing, as
    :func:`.ordered.row_tree_sum`; bit-equal), the plain version on a CPU
    tensor."""
    if cid.is_cuda:
        return launch.object_stats(cid, pidx, vals, mask_c, wok_c, thr,
                                   deb_ovf, ndet_pix, shape, nseg, minarea,
                                   max_det)
    return object_stats_plain(cid, pidx, vals, mask_c, wok_c, thr, deb_ovf,
                              ndet_pix, shape, nseg, minarea, max_det)


def _detect(bkgsub, rms, mask, weight_ok, nsigma, minarea, max_det,
            return_labels, deblend, clean, det_cap, deb_cap):
    """:func:`detect_sources`' output, and the inputs H24-H27 took on the
    way (:func:`detect_taps`)."""
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

    with torch.profiler.record_function('stats'):
        # ---- raster-order object ids (detect.py:826-839) -----------------
        key_c = torch.where(big, key_c, H * W - 1)
        robj = torch.cumsum(big & (pidx == key_c), 0)     # 1-based at roots
        nroots = robj[-1]
        obj_overflow = nroots - torch.clamp(nroots, max=max_det)
        rootpos = st['inv'][key_c.clamp(0, H * W - 1)].clamp(min=0)
        obj = robj[rootpos]
        obj = torch.where(obj > max_det, max_det + 1, obj)
        cid = torch.where(big, obj, nseg - 1)

        # ---- per-object statistics (detect.py:840-953) -------------------
        stats_args = (cid, pidx, st['img'].reshape(-1)[pidx],
                      mask.reshape(-1)[pidx].to(torch.int32),
                      weight_ok.reshape(-1)[pidx],
                      thresh_map.reshape(-1)[pidx], deb_ovf, st['ndet_pix'],
                      (H, W), nseg, minarea, max_det)
        r = object_stats(*stats_args)
        pix_overflow = st['ndet_pix'] - pok.sum()

    clean_args = None
    if clean:
        with torch.profiler.record_function('clean'):
            clean_args = tuple(r[k] for k in CLEAN_FIELDS)
            r['flux'], r['npix'], r['flags'], r['valid'] = _clean(
                *clean_args)

    sl = slice(1, max_det + 1)
    out = {k: r[k][sl] for k in DETECTION_FIELDS}
    out.update({'pix_overflow': pix_overflow.to(torch.int32),
                'deblend_overflow': deblend_overflow.to(torch.int32),
                'obj_overflow': obj_overflow.to(torch.int32),
                'valid': r['valid'][sl]})
    out['n'] = out['valid'].sum().to(torch.int32)
    if return_labels:
        # segmentation map (detect.py:1025-1033); padded slots, which the
        # reference writes 0 through at H*W-1, go to the discard slot
        keep = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                          r['valid'][1:]])
        obj_masked = torch.where(big & keep[obj.clamp(0, max_det + 1)],
                                 obj, 0).to(torch.int32)
        seg = scatter_into(H * W, pidx, pok, obj_masked, 0)
        seg[-1] = torch.where(st['ndet_pix'] < cap, 0, seg[-1])
        out['labels'] = seg.reshape(H, W)
    taps = {'seeds': (st['det'], st['pidx'], st['ndet_pix']),
            'ccl': (st['nbr_pos'], st['okb'], st['lab0']),
            'stats': stats_args, 'clean': clean_args}
    return out, taps


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
    return _detect(bkgsub, rms, mask, weight_ok, nsigma, minarea, max_det,
                   return_labels, deblend, clean, det_cap, deb_cap)[0]


def detect_taps(bkgsub, rms, mask=None, weight_ok=None,
                nsigma=DETECT_NSIGMA, minarea=DETECT_NPIX,
                max_det=MAX_DETECTIONS, deblend=True, det_cap=None,
                deb_cap=None):
    """The arguments :func:`detect_sources` passes to H24-H27 on this
    frame: ``seeds`` (the (H, W) detection mask, its compact list and
    its count of detected pixels), ``ccl`` (nbr_pos, okb,
    lab0), ``stats`` (those of :func:`object_stats`) and ``clean`` (the
    row fields of CLEAN_FIELDS, before CLEAN)."""
    return _detect(bkgsub, rms, mask, weight_ok, nsigma, minarea, max_det,
                   False, deblend, True, det_cap, deb_cap)[1]


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


# the row fields CLEAN reads, in the order of its arguments
CLEAN_FIELDS = ('x', 'y', 'a', 'b', 'theta', 'peak', 'thresh', 'flux',
                'npix', 'flags', 'valid')


def clean_pass(xbar, ybar, a, b, theta, peak, valid, blk=512):
    """CLEAN's contributions (detect.py:966-993): per row, the summed
    Moffat wings of its brighter valid neighbours at its centroid
    (``contrib_sum``, in 512-column blocks, each added in XLA:CPU's
    windowed order, the blocks in sequence) and its dominant contributor
    (``best_j``: the first column of the largest wing, block by block,
    taken only on a strictly larger value)."""
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
    return contrib_sum, best_j


def _clean_plain(xbar, ybar, a, b, theta, peak, thr_at_peak, flux, npix,
                 flags, valid):
    """Plain version of H27: the SExtractor CLEAN pass (detect.py:966-1008).
    An object whose peak owes more than its threshold to brighter
    neighbours' Moffat wings (:func:`clean_pass`) is merged into its
    dominant contributor. Returns (flux, npix, flags, valid)."""
    nseg = xbar.shape[0]
    dev = xbar.device
    contrib_sum, best_j = clean_pass(xbar, ybar, a, b, theta, peak, valid)
    cleaned = valid & (peak - contrib_sum <= thr_at_peak)
    tgt = torch.where(cleaned, best_j, nseg - 1)
    zero = torch.zeros(nseg, device=dev)
    flux = flux + zero.index_add(0, tgt, torch.where(cleaned, flux, 0.0))
    npix = npix + zero.index_add(0, tgt, torch.where(cleaned, npix, 0.0))
    got = torch.zeros(nseg, dtype=torch.int32, device=dev).scatter_reduce(
        0, tgt, cleaned.to(torch.int32), 'amax')
    flags = flags | torch.where(got > 0, 2, 0).to(flags.dtype)
    return flux, npix, flags, valid & ~cleaned


def _clean(xbar, ybar, a, b, theta, peak, thr_at_peak, flux, npix, flags,
           valid):
    """(flux, npix, flags, valid) after CLEAN (:func:`_clean_plain`): hand
    kernel H27 on a CUDA tensor (a warp a valid row; the merge adds in
    ascending row order, as ``index_add`` on the CPU), the plain version
    on a CPU tensor."""
    if xbar.is_cuda:
        inv = float(np.float32(1.0) / np.float32(2.0 * CLEAN_PARAM ** 2))
        return launch.clean(xbar, ybar, a, b, theta, peak, thr_at_peak, flux,
                            npix, flags, valid, inv)[:4]
    return _clean_plain(xbar, ybar, a, b, theta, peak, thr_at_peak, flux,
                        npix, flags, valid)
