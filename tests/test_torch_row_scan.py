"""H26's per-row sums on the CPU: ``ordered.row_tree_sum``, which forms
each segment's value from its own span at its absolute offset (the
maximal aligned dyadic blocks inside the span, each a perfect pairwise
tree, folded in position order), as the redesigned kernel does
(``kernels/objects.cu``), held bit-equal to

- ``ordered.tree_scan_at`` (the walk up the segmented scan's tree from
  each row's last entry) and ``ordered.segmented_scan`` read at the rows'
  ends, with f32 ``torch.add``, ``maximum``, ``minimum`` and int32
  ``bitwise_or``;
- the JAX package's ``_segmented_scan`` (``zuds_tpu/ops/detect.py:341``,
  ``jax.lax.associative_scan``) read at the rows' ends, with f32 adds;

on seeded layouts: segment lengths 1..3000, starts at odd positions, a
segment longer than one 1024-entry window (up to a discard row past
40,000 entries), odd list lengths (whose tree levels drop their last
node), empty rows, and ``object_stats_plain``'s eight f32 summands of a
seeded compact list. The statistics formed from the twin's sums through
the plain epilogue equal ``object_stats_plain``'s rows bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zuds_tpu.ops import detect as jd
from zuds_tpu_torch.ops import detect as td
from zuds_tpu_torch.ops.ordered import (counting_sort, fma, row_tree_sum,
                                        segmented_scan, tree_scan_at)

torch.set_num_threads(2)

WINDOW = 1024   # objects.cu kSpan: the row pass's aligned windows


def layout(seed, nrows, max_len, lead=0, tail=0, p_empty=0.3):
    """Segment lengths of ``nrows`` rows, each 0 with probability
    ``p_empty`` else in 1..max_len, after ``lead`` entries of a first row
    and before a last row of ``tail`` entries. Returns (starts, counts) as
    int64 numpy arrays."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, nrows)
    lens[rng.random(nrows) < p_empty] = 0
    lens[0] = max(lens[0], 1)
    lens = np.r_[lead, lens, tail].astype(np.int64)
    return np.r_[0, np.cumsum(lens)[:-1]], lens


def scan_inputs(starts, counts):
    """The scan's start flags and each row's last position, over the
    list the rows cover."""
    n = int(counts.sum())
    cid = np.repeat(np.arange(len(counts)), counts)
    start = np.r_[True, cid[1:] != cid[:-1]]
    ends = np.clip(starts + counts - 1, 0, n - 1)
    return n, torch.as_tensor(start), torch.as_tensor(ends)


def wide_values(seed, shape):
    """f32 values over six decades of magnitude, of both signs."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.normal(0, 1, shape)
                            * 10 ** rng.uniform(-3, 3, shape)).astype('f4'))


# (seed, rows, longest row, leading entries, discard row): odd and even
# list lengths, odd starts, rows past one window, a long discard row
LAYOUTS = [(0, 40, 8, 0, 0), (1, 200, 3, 1, 0), (2, 30, 300, 7, 1),
           (3, 12, 3000, 0, 0), (4, 25, 3000, 513, 3), (5, 6, 1500, 1023, 0),
           (6, 60, 100, 5, 40001), (7, 3, 2048, 2048, 1025),
           (8, 400, 40, 0, 9), (9, 1, 3000, 0, 0)]


@pytest.mark.parametrize('seed,nrows,max_len,lead,tail', LAYOUTS)
def test_row_tree_sum_is_the_scan_at_the_ends(seed, nrows, max_len, lead,
                                              tail):
    starts, counts = layout(seed, nrows, max_len, lead, tail)
    n, start, ends = scan_inputs(starts, counts)
    present = torch.as_tensor(counts > 0)
    odd = starts[(counts > 0) & (starts % 2 == 1)]
    assert len(odd) or nrows < 5, 'the layout starts no row at an odd place'
    v = wide_values(seed + 100, (3, n))
    for combine in (torch.add, torch.maximum, torch.minimum):
        got = row_tree_sum(v, starts, counts, combine)
        want = tree_scan_at(v, start, ends, combine)
        assert torch.equal(got[:, present], want[:, present]), combine
        full = segmented_scan(v, start, combine)[:, ends]
        assert torch.equal(got[:, present], full[:, present]), combine
        assert torch.equal(got[:, ~present],
                           torch.zeros_like(got[:, ~present]))
    m = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 1 << 17, n).astype('i4'))[None]
    got = row_tree_sum(m, starts, counts, torch.bitwise_or)
    want = tree_scan_at(m, start, ends, torch.bitwise_or)
    assert torch.equal(got[:, present], want[:, present])


# the reference's scan compiles once per shape: every layout's list is
# padded to this length with one more segment, which leaves the rows
# before it as they are
REF_LEN = 1 << 16
_ref_scan = jax.jit(lambda v, s: jd._segmented_scan(v, s, jnp.add))


@pytest.mark.parametrize('seed,nrows,max_len,lead,tail', LAYOUTS)
def test_row_tree_sum_is_the_reference_scan(seed, nrows, max_len, lead,
                                            tail):
    """Against the JAX package's associative scan, read at the ends."""
    starts, counts = layout(seed, nrows, max_len, lead, tail)
    n, start, ends = scan_inputs(starts, counts)
    assert n < REF_LEN
    present = counts > 0
    v = wide_values(seed + 200, (2, REF_LEN))
    got = row_tree_sum(v, starts, counts, torch.add).numpy()
    flags = np.zeros(REF_LEN, bool)
    flags[:n] = start.numpy()
    flags[n] = True
    want = np.asarray(_ref_scan(jnp.asarray(v.numpy()), jnp.asarray(
        np.broadcast_to(flags, v.shape))))[:, ends.numpy()]
    np.testing.assert_array_equal(got[:, present], want[:, present])


def test_row_tree_sum_windows():
    """A row's blocks of a level past the 1024-entry window are perfect
    trees of whole windows' sums: the twin agrees with a fold of the
    windows' own trees at every offset of a 3000-entry row."""
    v = wide_values(7, (1, 3 * WINDOW + 700))
    n = v.shape[-1]
    for st in (0, 1, 511, 1023, 1024, 1025, 2047):
        cnt = min(3000, n - st)
        got = row_tree_sum(v, [st], [cnt], torch.add)
        start = torch.zeros(n, dtype=torch.bool)
        start[0] = start[st] = True
        want = tree_scan_at(v, start, torch.as_tensor([st + cnt - 1]),
                            torch.add)
        assert torch.equal(got, want), st


def compact_list(seed, H, W, cap, nseg):
    """A seeded compact list as ``detect_sources`` hands it to
    ``object_stats``: rows of 1..3000 pixels in raster blocks, empty rows,
    and a discard row nseg - 1 holding the rest of the list."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 400, nseg - 2)
    lens[rng.random(nseg - 2) < 0.4] = 0
    lens[rng.integers(0, nseg - 2, 3)] = rng.integers(1025, 3000, 3)
    lens = lens[np.cumsum(lens) < cap // 2]
    cid = np.repeat(np.arange(1, len(lens) + 1), lens)
    cid = np.r_[cid, np.full(cap - len(cid), nseg - 1)]
    rng.shuffle(cid)
    pidx = np.sort(rng.choice(H * W, cap, replace=False))
    vals = rng.normal(5, 30, cap).astype('f4')
    vals[rng.random(cap) < 0.01] = -0.0
    mask = np.where(rng.random(cap) < 0.05, rng.integers(0, 1 << 17, cap),
                    0).astype('i4')
    wok = rng.random(cap) > 0.02
    thr = (15.0 * (1 + 0.1 * rng.random(cap))).astype('f4')
    deb = rng.random(cap) < 0.01
    T = torch.as_tensor
    return (T(cid), T(pidx), T(vals), T(mask), T(wok), T(thr), T(deb),
            T(np.int64(cap + 17)), (H, W), nseg, 5.0, nseg - 2)


@pytest.mark.parametrize('seed,cap,nseg', [(0, 4099, 130), (1, 65536, 4098),
                                           (2, 20000, 1026)])
def test_object_stats_from_row_tree_sums(seed, cap, nseg):
    """``object_stats_plain``'s eight summands of a seeded list, sorted by
    the counting sort of H26, summed per row by the twin: bit-equal to the
    segmented scan's, and the rows formed from them through the plain
    epilogue equal ``object_stats_plain``'s."""
    args = compact_list(seed, 600, 500, cap, nseg)
    cid, pidx, vals = args[:3]
    W = args[8][1]
    perm, starts, counts = counting_sort(cid, nseg)
    px = (pidx % W).to(torch.float32)[perm]
    py = torch.div(pidx, W, rounding_mode='floor').to(torch.float32)[perm]
    v = vals[perm]
    pos = torch.clamp(v, min=0.0)
    summands = torch.stack([torch.ones_like(v), v, pos, pos * px, pos * py,
                            pos * px * px, pos * py * py, pos * px * py])
    sums = row_tree_sum(summands, starts, counts, torch.add)
    cid_s = cid[perm]
    start = torch.cat([torch.ones(1, dtype=torch.bool),
                       cid_s[1:] != cid_s[:-1]])
    present = counts > 0
    ends = (starts + counts - 1).clamp(0, cap - 1)
    want = segmented_scan(summands, start, torch.add)[:, ends]
    assert torch.equal(sums[:, present], want[:, present])
    assert int(counts[-1]) > 2 * WINDOW and int(counts.max()) > WINDOW

    npix, flux, wsum, sx, sy, sxx, syy, sxy = sums
    wsum = torch.clamp(wsum, min=1e-20)
    xbar, ybar = sx / wsum, sy / wsum
    x2 = torch.clamp(fma(-xbar, xbar, sxx / wsum), min=1.0 / 12.0)
    y2 = torch.clamp(fma(-ybar, ybar, syy / wsum), min=1.0 / 12.0)
    xy = fma(-xbar, ybar, sxy / wsum)
    p = td.object_stats_plain(*args)
    for key, got in (('npix', npix), ('flux', flux), ('x', xbar),
                     ('y', ybar), ('x2', x2), ('y2', y2), ('xy', xy)):
        assert torch.equal(got, p[key]), key
    assert int(p["valid"].sum()) > 3


# ---- the kernel's schedule, emulated ----------------------------------------

def _cover_at(st, m, L):
    """objects.cu cover_at: the row [st, m)'s blocks of level L at its
    left and right ends (node indices), or -1."""
    lo, hi = (st + (1 << L) - 1) >> L, m >> L
    hl = bool(lo & 1) and lo < hi
    hr = bool(hi & 1) and lo + int(hl) < hi
    return (lo if hl else -1), (hi - 1 if hr else -1)


def _perfect(v):
    """A perfect pairwise tree over 2^k f32 values (a shuffle butterfly
    gives every lane this sum, as a + b == b + a)."""
    v = np.asarray(v, np.float32)
    while len(v) > 1:
        v = (v[0::2] + v[1::2]).astype(np.float32)
    return v[0]


def emulate_row_pass(vals, st, cnt, span_log=10, chunk=128):
    """One row's sum as ``objects.cu``'s row pass forms it: the passes
    over the row's first and last windows unless whole (levels 0-5 in
    groups of 32 entries, levels 6 up to the window in the group sums,
    capturing the cover's blocks by ``cover_at``), the whole windows' sums
    streamed ``chunk`` at a time through a binary-counter stack into the
    cover's blocks past the window's level, and the fold in position
    order."""
    span = 1 << span_log
    m = st + cnt
    wa, wb = st >> span_log, (m - 1) >> span_log
    hw, tw = (st + span - 1) >> span_log, m >> span_log
    piece = {}

    def window_pass(w, a, b):
        base = w << span_log
        lane = np.array([vals[p] if a <= p < b else 0.0
                         for p in range(base, base + span)], np.float32)
        for L in range(span_log):
            for side, n in enumerate(_cover_at(st, m, L)):
                if n >= 0 and (n << L) >> span_log == w:
                    blk = lane[(n << L) - base:((n + 1) << L) - base]
                    piece[L, side] = _perfect(blk)

    if not (hw <= wa < tw):
        window_pass(wa, st, min(m, (wa + 1) << span_log))
    if wb != wa and not (hw <= wb < tw):
        window_pass(wb, wb << span_log, m)
    acc = None

    def fold(v):
        return v if acc is None else np.float32(acc + v)

    for L in range(span_log):
        if _cover_at(st, m, L)[0] >= 0:
            acc = fold(piece[L, 0])
    if tw > hw:
        sizes = [1 << (L - span_log) for L in range(span_log, 32)
                 if _cover_at(st, m, L)[0] >= 0]
        sizes += [1 << (L - span_log) for L in reversed(range(span_log, 32))
                  if _cover_at(st, m, L)[1] >= 0]
        assert sum(sizes) == tw - hw
        wsum = [_perfect(vals[w << span_log:(w + 1) << span_log])
                for w in range(hw, tw)]
        pi = inpiece = 0
        stk = []
        for c0 in range(0, tw - hw, chunk):
            for v in wsum[c0:c0 + chunk]:
                c = inpiece
                while c & 1:
                    v = np.float32(stk.pop() + v)
                    c >>= 1
                stk.append(v)
                inpiece += 1
                if inpiece == sizes[pi]:
                    assert len(stk) == 1
                    acc = fold(stk.pop())
                    inpiece = 0
                    pi += 1
    for L in reversed(range(span_log)):
        if _cover_at(st, m, L)[1] >= 0:
            acc = fold(piece[L, 1])
    return acc


@pytest.mark.parametrize('span_log,chunk', [(10, 128), (5, 3), (3, 2)])
def test_the_kernels_schedule(span_log, chunk):
    """The row pass's schedule (emulated in numpy at its own window and
    chunk sizes, and at smaller ones that cross more windows and chunks)
    gives ``row_tree_sum``'s value on rows at every kind of offset."""
    rng = np.random.default_rng(span_log)
    span = 1 << span_log
    n = 40 * span + 13
    vals = (rng.normal(0, 1, n) * 10 ** rng.uniform(-3, 3, n)).astype('f4')
    rows = [(0, n), (1, n - 1), (span, 7 * span), (span - 1, 2),
            (3, 17 * span + 5), (2 * span, span), (5, 1), (n - 1, 1),
            (span + 1, span - 2), (span - 5, 10)]
    rows += [tuple(int(x) for x in sorted(rng.integers(0, n, 2)))
             for _ in range(30)]
    rows = [(st, max(1, min(cnt - st if cnt > st else cnt, n - st)))
            for st, cnt in rows]
    starts = np.array([r[0] for r in rows])
    counts = np.array([r[1] for r in rows])
    want = row_tree_sum(torch.as_tensor(vals), starts, counts,
                        torch.add).numpy()
    got = np.array([emulate_row_pass(vals, st, cnt, span_log, chunk)
                    for st, cnt in rows], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
