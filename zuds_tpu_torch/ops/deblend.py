"""SExtractor's exact multi-threshold deblend tree on the compact pixel list
(twin of ``_deblend_exact``, ``zuds_tpu/ops/detect.py:370-560``).

The level labels run in hand kernel H5 (``kernels/deblend.cu``) on a CUDA
tensor and in :func:`level_labels_plain` on a CPU tensor; the compactions
go through :func:`.compact.compact_indices` (H6 on the card). Everything
else is plain PyTorch on either device.

Numbers that decide splits, held to the reference on the CPU:

* the level thresholds ``t0 * ratio ** (l / 32)``: the power is taken in
  float64 and rounded once to float32. XLA:CPU's f32 power is within
  0.502 ulp of exact, so the two differ by one ulp in ~0.06% of
  (pixel, level) pairs, and a pixel's activity flips only where its
  filtered value lies within one ulp of its level (the tests count such
  pixels);
* the flux sums ``F0``, the buckets, their suffix sum and ``subflux`` are
  added in the reference's order on the CPU (``index_add_`` in index
  order, :func:`.ordered.cumsum_last`), so CPU parity is bit-equal. On the
  card ``index_add_`` uses atomics: a split decision whose ratio
  ``subflux / (mincont * F0)`` lies within a few float32 roundings of 1
  may come out the other way (``chip_smoke.py`` counts those within
  1e-5);
* the deepest split is the largest split level, which is what the
  reference's ``argmax`` over the reversed levels picks.

The cell cap is the reference's: cells past ``ccap = min(cap, 8192)`` have
no slot, so their pixels join cell 0, and ``deblend_overflow`` does not
count them (ROADMAP section 3).
"""
from __future__ import annotations

import os

import torch

from ..constants import DEBLEND_MINCONT, DEBLEND_NTHRESH
from ..kernels import launch
from .compact import compact_indices, scatter_into
from .ordered import cumsum_last

__all__ = ['level_labels', 'level_labels_plain', 'cell_graph',
           'deblend_exact', 'split_margins', 'deblend_probe', 'wrap32',
           'TREE_PROBES']

# hook+compress rounds per level, counting the first (detect.py:357-358)
_DEB_ROUNDS = int(os.environ.get('ZUDS_DEB_ROUNDS', '6'))
# the cell compaction's capacity (detect.py:419)
MAX_CELLS = 8192
INT_MAX = 2 ** 31 - 1
_BIG_NEG = -3e38


def level_labels_plain(e_src, e_dst, e_w, ccap, nlev, max_rounds):
    """Plain version of H5: (nlev, ccap) int32 labels of the cells at each
    level, from ``lab = arange(ccap)``, by rounds of a min-hook over the
    edges live at the level (``lev < e_w``) and three synchronous pointer
    jumps, until a round changes nothing or ``max_rounds`` rounds ran
    (detect.py:482-517; ``scatter_reduce('amin')`` gives the integer
    minimum of the reference's sorted segmented scan)."""
    dev = e_src.device
    src = e_src.long().expand(nlev, -1)
    dst = e_dst.long()
    live = torch.arange(nlev, device=dev)[:, None] < e_w[None]
    infc = torch.full((nlev, ccap), ccap, dtype=torch.int64, device=dev)

    def one_round(lab):
        cand = torch.where(live, lab[:, dst], ccap)
        lab = torch.minimum(lab, infc.scatter_reduce(1, src, cand, 'amin'))
        for _ in range(3):
            lab = torch.minimum(lab, lab.gather(1, lab))
        return lab

    lab = one_round(torch.arange(ccap, device=dev).expand(nlev, -1))
    for _ in range(max_rounds - 1):
        new = one_round(lab)
        if torch.equal(new, lab):
            break
        lab = new
    return lab.to(torch.int32)


def level_labels(e_src, e_dst, e_w, ccap, nlev, max_rounds, nedge):
    """The level labels: hand kernel H5 on a CUDA tensor (int64 edges, as
    :func:`cell_graph` gives them, taken without a copy; ``nedge``, the
    0-d count of live slots, spares it the padding),
    :func:`level_labels_plain` on a CPU tensor."""
    if e_src.is_cuda:
        return launch.deblend_labels(
            *(t.to(torch.int64).contiguous() for t in (e_src, e_dst, e_w)),
            ccap, nlev, max_rounds, nedge)
    return level_labels_plain(e_src, e_dst, e_w, ccap, nlev, max_rounds)


def cell_graph(pidx, pok, comppos, cellpos, filt_c, thresh_c, nbr_pos,
               nbr_ok, nlevels=DEBLEND_NTHRESH):
    """The tree's levels and its cross-cell edge list (detect.py:400-467).

    Returns a dict: ``L`` levels; ``t0_c``, ``ratio`` (cap,) and ``t_l``
    (L, cap) the base components' thresholds and the levels; ``active``
    (L, cap) and ``lpix`` (cap,) the pixels' levels;
    ``cpos``/``cok``/``ncell``/``ccap`` the compact cells (a cell is its
    peak pixel); ``cellid`` (cap,) each pixel's cell slot;
    ``e_src``/``e_dst``/``e_w`` the cross-cell edges (ecap = cap slots),
    ``nedge`` and ``edge_overflow``."""
    cap = pidx.shape[0]
    dev = pidx.device
    L = nlevels - 1
    posidx = torch.arange(cap, device=dev)

    # per-base-component filtered peak and detection threshold (:403-406)
    neg = torch.full((cap,), -float('inf'), device=dev)
    peak = neg.scatter_reduce(0, comppos, torch.where(pok, filt_c, _BIG_NEG),
                              'amax')
    t0 = -neg.scatter_reduce(0, comppos,
                             torch.where(pok, -thresh_c, _BIG_NEG), 'amax')
    t0_c = torch.clamp(t0[comppos], min=1e-20)
    ratio = torch.clamp(peak[comppos] / t0_c, min=1.0)
    fracs = torch.arange(1, nlevels, dtype=torch.float32, device=dev) \
        / nlevels
    # the power in float64, rounded once (see the module docstring)
    t_l = t0_c[None] * (ratio.double()[None]
                        ** fracs.double()[:, None]).float()     # (L, cap)
    active = pok[None] & (filt_c[None] >= t_l)
    lpix = active.sum(0)                                        # (cap,)

    # compact the watershed cells (:419-426)
    ccap = min(cap, MAX_CELLS)
    is_peak = pok & (cellpos == posidx)
    cpos, ncell = compact_indices(is_peak, ccap, cap - 1)
    cok = torch.arange(ccap, device=dev) < torch.clamp(ncell, max=ccap)
    invcell = scatter_into(cap, cpos, cok, torch.arange(ccap, device=dev),
                           0)
    # the reference's padded slots all write cap-1, the last one wins
    invcell[cap - 1] = torch.where(ncell < ccap, ccap - 1, invcell[cap - 1])
    cellid = invcell[cellpos]

    # edge weights and the cross-cell edge list (:431-467)
    w_edge = torch.where(nbr_ok, torch.minimum(lpix[None], lpix[nbr_pos]), 0)
    c_dst = cellid[nbr_pos]                                     # (8, cap)
    cross = (w_edge > 0) & (cellid[None] != c_dst)
    ecap = cap
    eidx, nedge = compact_indices(cross.reshape(-1), ecap, 8 * cap - 1)
    eok = torch.arange(ecap, device=dev) < torch.clamp(nedge, max=ecap)
    src_flat = cellid[None].expand(8, cap).reshape(-1)
    return {
        'L': L, 't0_c': t0_c, 'ratio': ratio, 't_l': t_l,
        'active': active, 'lpix': lpix, 'ccap': ccap, 'cpos': cpos,
        'cok': cok, 'ncell': ncell, 'cellid': cellid,
        'e_src': torch.where(eok, src_flat[eidx], ccap - 1),
        'e_dst': torch.where(eok, c_dst.reshape(-1)[eidx], ccap - 1),
        'e_w': torch.where(eok, w_edge.reshape(-1)[eidx], 0),
        'nedge': nedge,
        'edge_overflow': nedge - torch.clamp(nedge, max=ecap),
    }


def _tree(pidx, pok, comppos, cellpos, filt_c, pos_flux_c, thresh_c,
          nbr_pos, nbr_ok, nlevels):
    """The cell graph, its level labels ``bl`` (L, ccap), and F0 per cell
    and each (level, cell)'s branch flux (detect.py:401, :521-536), added
    in the reference's order on the CPU."""
    g = cell_graph(pidx, pok, comppos, cellpos, filt_c, thresh_c, nbr_pos,
                   nbr_ok, nlevels)
    L, ccap, cellid = g['L'], g['ccap'], g['cellid']
    bl = level_labels(g['e_src'], g['e_dst'], g['e_w'], ccap, L,
                      _DEB_ROUNDS, g['nedge']).long()
    cap = pok.shape[0]
    dev = pok.device
    flux = torch.where(pok, pos_flux_c, 0.0)
    F0 = torch.zeros(cap, device=dev).index_add_(0, comppos, flux)
    # per-cell flux above each level: bucket by the pixel's top level,
    # then suffix-sum along the levels
    bucket = torch.zeros(ccap * (nlevels + 1), device=dev).index_add_(
        0, cellid * (nlevels + 1) + g['lpix'], flux
    ).reshape(ccap, nlevels + 1)
    above = cumsum_last(bucket.flip(1)).flip(1)
    act_cell = g['active'][:, g['cpos']] & g['cok'][None]       # (L, ccap)
    lev = torch.arange(L, device=dev)[:, None]
    subflux = torch.zeros(L * ccap, device=dev).index_add_(
        0, (lev * ccap + bl).reshape(-1),
        torch.where(act_cell, above[:, 1:L + 1].T, 0.0).reshape(-1)
    ).reshape(L, ccap)
    return g, bl, {'act_cell': act_cell, 'sf': subflux.gather(1, bl),
                   'F0_cell': F0[comppos[g['cpos']]]}


def deblend_exact(pidx, pok, comppos, cellpos, filt_c, pos_flux_c, thresh_c,
                  nbr_pos, nbr_ok, nlevels=DEBLEND_NTHRESH,
                  mincont=DEBLEND_MINCONT):
    """Per compact pixel, the root flat index of the deepest split branch
    holding its watershed cell (its base component's root when never
    split; INT_MAX on padding), and the count of cross-cell edges past the
    edge list's capacity (detect.py:370-560)."""
    dev = pidx.device
    g, bl, s = _tree(pidx, pok, comppos, cellpos, filt_c, pos_flux_c,
                     thresh_c, nbr_pos, nbr_ok, nlevels)
    L, ccap, cpos, cellid = g['L'], g['ccap'], g['cpos'], g['cellid']
    act_cell = s['act_cell']
    sig = act_cell & (s['sf'] >= mincont * s['F0_cell'][None])

    lev = torch.arange(L, device=dev)[:, None]
    cidx = torch.arange(ccap, device=dev)
    is_branch_root = act_cell & (bl == cidx[None])
    # level-0 parent: the base component, keyed by the cell of its root
    parent = torch.cat([cellid[comppos[cpos]][None], bl[:-1]], 0)
    nsig = torch.zeros(L * ccap, dtype=torch.int64, device=dev).index_add_(
        0, (lev * ccap + parent).reshape(-1),
        (is_branch_root & sig).to(torch.int64).reshape(-1)).reshape(L, ccap)
    split = sig & (nsig.gather(1, parent) >= 2)

    has_split = split.any(0)
    deepest = torch.where(split, lev, -1).amax(0).clamp(min=0)
    bl_deep = bl.gather(0, deepest[None])[0]
    objdeep_cell = torch.where(has_split, cpos[bl_deep], comppos[cpos])
    objdeep_pos = objdeep_cell[cellid]
    return (torch.where(pok, pidx[objdeep_pos], INT_MAX),
            g['edge_overflow'])


# the probes of the reference's tree (detect.py:432-438, :518-519, :537-539)
TREE_PROBES = ('deb_edges', 'deb_lab', 'deb_seg')


def wrap32(total):
    """A 0-d integer sum as the reference's int32 sum gives it: JAX runs
    with x64 off, so its sums of int32 wrap modulo 2^32."""
    v = total.to(torch.int64) & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def deblend_probe(stop, pidx, pok, comppos, cellpos, filt_c, pos_flux_c,
                  thresh_c, nbr_pos, nbr_ok, nlevels=DEBLEND_NTHRESH):
    """The reference tree's probe ``stop`` (one of :data:`TREE_PROBES`) on
    the tree's inputs, from the port's tree at the reference's
    definitions:

    * ``'deb_edges'`` (4,) int32: live pixels, cells (peak pixels),
      edges between pixels of different cells live at some level, and
      edges live at some level;
    * ``'deb_lab'``: the int32 sum over the slots of each live pixel's
      level-0 component root (the flat index of its smallest cell's peak),
      INT_MAX on padding;
    * ``'deb_seg'``: the same of ``pidx`` plus the level-0 branch flux of
      the pixel's cell truncated to int32."""
    if stop == 'deb_edges':
        g = cell_graph(pidx, pok, comppos, cellpos, filt_c, thresh_c,
                       nbr_pos, nbr_ok, nlevels)
        lpix = g['lpix']
        w_edge = torch.where(nbr_ok, torch.minimum(lpix[None], lpix[nbr_pos]),
                             0)
        is_peak = pok & (cellpos == torch.arange(pok.shape[0],
                                                 device=pok.device))
        cross = nbr_ok & (cellpos[None] != cellpos[nbr_pos]) & (w_edge > 0)
        return torch.stack([wrap32(m.sum()) for m in
                            (pok, is_peak, cross, w_edge > 0)])
    g, bl, s = _tree(pidx, pok, comppos, cellpos, filt_c, pos_flux_c,
                     thresh_c, nbr_pos, nbr_ok, nlevels)
    cellid = g['cellid']
    if stop == 'deb_lab':
        val = pidx[g['cpos'][bl[0]]][cellid]
    elif stop == 'deb_seg':
        val = pidx + s['sf'][0][cellid].to(torch.int32)
    else:
        raise ValueError(f'deblend_probe: no probe {stop!r}')
    return wrap32(torch.where(pok, val, INT_MAX).sum())


def split_margins(pidx, pok, comppos, cellpos, filt_c, pos_flux_c, thresh_c,
                  nbr_pos, nbr_ok, nlevels=DEBLEND_NTHRESH,
                  mincont=DEBLEND_MINCONT):
    """``subflux / (mincont * F0)`` of every live (level, cell) decision of
    the tree, flat: the decisions whose ratio lies near 1 are those whose
    outcome may change with the order of the float sums."""
    _, _, s = _tree(pidx, pok, comppos, cellpos, filt_c, pos_flux_c,
                    thresh_c, nbr_pos, nbr_ok, nlevels)
    thr = (mincont * s['F0_cell'])[None].expand_as(s['sf'])
    live = s['act_cell'] & (thr > 0)
    return s['sf'][live] / thr[live]
