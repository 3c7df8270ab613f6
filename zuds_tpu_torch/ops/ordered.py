"""Float32 sums in a fixed, documented order.

Where a formula cancels (a one-pass variance ``s2/n - mean^2``, second
moments about a centroid), the last bits of a sum decide the result to
1e-4. The reference's results are those of XLA's CPU backend, which
rewrites every reduction longer than 32 into sequential windows of 32
(zero padding split evenly at both ends, larger half after) and repeats
until 32 or fewer remain, then adds those in order; a 2-D reduction uses
32x32 windows, in row-major order inside the window. :func:`sum_last` and
:func:`sum_last2` add in exactly that order, so the port's plain versions
and its CUDA kernels (which follow the same order) agree with the
reference to the last bit wherever the summands agree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ['fma', 'sum_last', 'sum_last2', 'cumsum_last', 'segmented_scan',
           'tree_scan_at', 'row_tree_sum', 'counting_sort']

_WIN = 32


def _seq(x):
    """Sequential sum over the last axis: ((x0 + x1) + x2) + ..."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _split(n):
    p = (-n) % _WIN
    return p // 2, p - p // 2


def sum_last(x):
    """Sum over the last axis in XLA:CPU's windowed order."""
    while x.shape[-1] > _WIN:
        lo, hi = _split(x.shape[-1])
        x = F.pad(x, (lo, hi))
        x = _seq(x.reshape(*x.shape[:-1], -1, _WIN))
    return _seq(x)


def sum_last2(x):
    """Sum over the last two axes in XLA:CPU's order: row-major sequential
    when both are <= 32, else 32x32 windows, each summed row-major, whose
    sums are added row by row.

    On a CUDA tensor this is ``torch.sum``: the reference's order only
    matters for agreement with it on the CPU, and a sequential window
    costs one launch per element (~0.5 s per flagship frame across the
    measurement stage on an NVIDIA H100 80GB HBM3 at 700 W)."""
    if x.is_cuda:
        return x.sum((-2, -1))
    h, w = x.shape[-2:]
    if h <= _WIN and w <= _WIN:
        return _seq(x.reshape(*x.shape[:-2], h * w))
    (ty, by), (tx, bx) = (_split(h) if h > _WIN else (0, 0),
                          _split(w) if w > _WIN else (0, 0))
    x = F.pad(x, (tx, bx, ty, by))
    wh, ww = min(h, _WIN), min(w, _WIN)
    H2, W2 = x.shape[-2:]
    lead = x.shape[:-2]
    x = x.reshape(*lead, H2 // wh, wh, W2 // ww, ww)
    x = x.movedim(-3, -2).reshape(*lead, H2 // wh, W2 // ww, wh * ww)
    return _seq(_seq(_seq(x)))


def cumsum_last(x, base=16):
    """Inclusive cumulative sum over the last axis in XLA:CPU's order for
    ``jnp.cumsum``: the axis is zero-padded to blocks of ``base``, each
    block is summed sequentially, and each block's running sums get the
    sequential sum of the earlier blocks' totals added once. Lengths up to
    ``base**2`` (one level of blocks)."""
    n = x.shape[-1]
    nb = -(-n // base)
    if nb > base:
        raise ValueError(f'cumsum_last: length {n} exceeds {base ** 2}')
    xb = F.pad(x, (0, nb * base - n)).reshape(*x.shape[:-1], nb, base)
    acc = xb[..., 0]
    intra = [acc]
    for k in range(1, base):
        acc = acc + xb[..., k]
        intra.append(acc)
    intra = torch.stack(intra, -1)
    tot = intra[..., -1]
    run = torch.zeros_like(tot[..., 0])
    excl = []
    for j in range(nb):
        excl.append(run)
        run = run + tot[..., j]
    out = intra + torch.stack(excl, -1)[..., None]
    return out.reshape(*x.shape[:-1], nb * base)[..., :n]


def fma(a, b, c):
    """f32 fused multiply-add a*b + c with one rounding (the product is
    exact in double). XLA's CPU backend contracts ``c - a*b`` this way,
    and so does H2 (``fmaf``)."""
    return (a.double() * b.double() + c.double()).float()


def segmented_scan(vals, start, combine):
    """Inclusive segmented scan along the last axis of ``vals``: within
    runs that begin where ``start`` is True, combine left to right.

    The pairing is that of ``jax.lax.associative_scan`` (combine adjacent
    pairs, recurse on the half, fill in the evens), so float sums are
    added in the same tree order as the reference's ``_segmented_scan``
    (zuds_tpu/ops/detect.py:341) and agree with it to the last bit.
    """
    start = torch.broadcast_to(start, vals.shape)

    def op(a, b):
        (va, sa), (vb, sb) = a, b
        return torch.where(sb, vb, combine(va, vb)), sa | sb

    def scan(v, s):
        n = v.shape[-1]
        if n < 2:
            return v, s
        odd = scan(*op((v[..., 0:-1:2], s[..., 0:-1:2]),
                       (v[..., 1::2], s[..., 1::2])))
        if n % 2 == 0:
            even = op((odd[0][..., :-1], odd[1][..., :-1]),
                      (v[..., 2::2], s[..., 2::2]))
        else:
            even = op(odd, (v[..., 2::2], s[..., 2::2]))
        even = (torch.cat([v[..., :1], even[0]], -1),
                torch.cat([s[..., :1], even[1]], -1))
        return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])

    return scan(vals, start)[0]


def tree_scan_at(vals, start, ends, combine):
    """``segmented_scan(vals, start, combine)[..., ends]`` without the whole
    scan: the value at each position ``e`` of ``ends`` walked up the
    scan's pairwise tree (the walk H26 took before it formed each row from
    its own span, :func:`row_tree_sum`).

    The tree's level L+1 pairs level L, ``a[k] = op(a[2k], a[2k+1])``
    with ``op((va, sa), (vb, sb)) = (vb if sb else combine(va, vb),
    sa | sb)``, level 0 being ``(vals, start)``. By the recursion of
    :func:`segmented_scan`, the scan at level L is, at position i: ``a[0]``
    for i = 0; the scan at level L+1 at (i - 1) / 2 for odd i; and
    ``op(scan_{L+1}((i / 2) - 1), a[i])`` for even i > 0. So the value at
    ``e`` is the first ``a[0]`` the walk up reaches, combined with the
    even positions' ``a[i]`` it passed, from the top level down: the same
    combines, in the same order, as the full scan."""
    start = torch.broadcast_to(start, vals.shape)
    levels = [(vals, start)]
    while levels[-1][0].shape[-1] >= 2:
        v, s = levels[-1]
        h = v.shape[-1] // 2
        vb, sb = v[..., 1:2 * h:2], s[..., 1:2 * h:2]
        levels.append((torch.where(sb, vb, combine(v[..., 0:2 * h:2], vb)),
                       s[..., 0:2 * h:2] | sb))
    # the walk up: per level, the index reached and whether it is an even
    # position > 0 (an operand) or the 0 that ends the walk (the base)
    i = ends.to(torch.int64)
    base = torch.full_like(i, -1)
    steps = []
    for lev in range(len(levels)):
        live = base < 0
        base = torch.where(live & (i == 0), lev, base)
        steps.append((i, live & (i > 0) & (i % 2 == 0)))
        i = torch.where(i % 2 == 1, (i - 1) // 2,
                        torch.where(i > 0, i // 2 - 1, 0))
    acc = None
    for lev in reversed(range(len(levels))):
        v, s = levels[lev]
        idx, operand = steps[lev]
        idx = idx.clamp(0, v.shape[-1] - 1)
        vi, si = v[..., idx], s[..., idx]
        acc = vi if acc is None else torch.where(base == lev, vi, acc)
        acc = torch.where(operand, torch.where(si, vi, combine(acc, vi)), acc)
    return acc


def row_tree_sum(vals, starts, counts, combine, empty=0):
    """Each segment's value of ``segmented_scan`` read at its last entry,
    formed from the segment's own span at its absolute offset, as H26
    forms it (``kernels/objects.cu``): the (..., nseg) values for the
    segments ``[starts[j], starts[j] + counts[j])`` of ``vals`` (...,
    n), ``empty`` where ``counts[j]`` is 0.

    The walk of :func:`tree_scan_at` from a segment's last entry e
    gathers the nodes of the binary decomposition of [0, e + 1) and folds
    them left to right, each node being ``combine`` over its span in the
    tree's pairing from the last segment start inside it on. The node
    holding the segment's start s unfolds the same way, so the value is
    the left fold, in position order, of the maximal aligned dyadic
    blocks ``[k 2^L, (k + 1) 2^L)`` inside [s, e + 1) (at most two a
    level: the segment tree's canonical cover), each block reduced as a
    perfect pairwise tree. Only the segment's entries enter, and its
    offset s fixes the pairing. A block of level L at node k exists in
    level L of the tree whatever the list's length, since it ends by
    e + 1 <= n."""
    vals = torch.as_tensor(vals)
    n = vals.shape[-1]
    levels = [vals]           # level L: the perfect trees of 2^L entries
    while levels[-1].shape[-1] >= 2:
        v = levels[-1]
        h = v.shape[-1] // 2
        levels.append(combine(v[..., 0:2 * h:2], v[..., 1:2 * h:2]))
    starts = torch.as_tensor(starts, dtype=torch.int64)
    counts = torch.as_tensor(counts, dtype=torch.int64)
    if bool(((starts < 0) | (counts < 0) | (starts + counts > n)).any()):
        raise ValueError('row_tree_sum: a segment outside the list')
    lo, hi = starts.clone(), starts + counts
    lead = vals.shape[:-1]
    acc = torch.zeros(lead + starts.shape, dtype=vals.dtype)
    have = torch.zeros(starts.shape, dtype=torch.bool)

    def fold(acc, have, take, piece):
        acc = torch.where(take & have, combine(acc, piece),
                          torch.where(take, piece, acc))
        return acc, have | take

    rights = []
    for v in levels:
        # the cover's two blocks of this level: lo's when lo is odd, the
        # one before hi when hi is odd (the segment tree's loop)
        last = v.shape[-1] - 1
        take = (lo < hi) & (lo % 2 == 1)
        acc, have = fold(acc, have, take, v[..., lo.clamp(0, last)])
        lo = lo + take.long()
        take = (lo < hi) & (hi % 2 == 1)
        hi = hi - take.long()
        rights.append((take, v[..., hi.clamp(0, last)]))
        lo, hi = lo // 2, hi // 2
    for take, piece in reversed(rights):
        acc, have = fold(acc, have, take, piece)
    return torch.where(counts > 0, acc,
                       torch.as_tensor(empty, dtype=vals.dtype))


def counting_sort(keys, nkeys, tile=1024):
    """(perm, starts, counts) of a stable counting sort of the int64
    ``keys`` in [0, nkeys), in the passes of H26's sort
    (``kernels/objects.cu``), the plain twin that the tests hold to
    ``torch.sort(keys, stable=True)``: each tile of ``tile`` entries
    ranks its entries among its equal keys in order and counts its keys;
    each key's counts over the tiles become the tiles' offsets and its
    total the key's count, whose exclusive scan gives ``starts``; an entry
    goes to its key's start + its tile's offset + its rank."""
    n = keys.shape[0]
    ntiles = -(-n // tile)
    ranks, hist = [], []
    for t in range(ntiles):
        onehot = F.one_hot(keys[t * tile:(t + 1) * tile], nkeys)
        before = torch.cumsum(onehot, 0) - onehot
        ranks.append(before.gather(1, keys[t * tile:(t + 1) * tile, None])[:, 0])
        hist.append(onehot.sum(0))
    hist = torch.stack(hist)                                # (ntiles, nkeys)
    offsets = torch.cumsum(hist, 0) - hist
    counts = hist.sum(0)
    starts = torch.cumsum(counts, 0) - counts
    tiles = torch.arange(n, device=keys.device) // tile
    pos = starts[keys] + offsets[tiles, keys] + torch.cat(ranks)
    perm = torch.empty_like(pos).scatter_(0, pos, torch.arange(
        n, device=keys.device))
    return perm, starts, counts


def _interleave(a, b):
    out = a.new_empty(a.shape[:-1] + (a.shape[-1] + b.shape[-1],))
    out[..., 0::2] = a
    out[..., 1::2] = b
    return out
