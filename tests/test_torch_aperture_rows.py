"""The premises of H22's and H24's designs (``kernels/photometry.cu``,
``kernels/ccl.cu``), emulated on the CPU with the constants read from the
sources.

H22 shares each pixel corner's quadrant area between the four pixels that
meet there, where a window's neighbouring edges are bitwise the same
float, and forms each corner's area from terms of its two edges (the arc
integrals once an edge): the numpy float32 emulation of its edge test
shows that wherever the test passes, the corner grid's four-term sums are
bit for bit the per-pixel overlaps of ``ops/photometry.py`` (at positions
near 0, negative, NaN, +-inf and past the frame too), and that the test
fails only near 0. H22 also measures each distinct row once: the
emulation of its row mapping (block 0 measures the last row and copies it
to every row at the same position, bitwise; every other row is measured
by its own warp) gives every row exactly one writer and the plain
outputs, with repeated rows that are not the last row's measured;
``detect_sources`` gives its rows past the frame's objects the last row's
position.

H24 writes the seeds only at the compact list's entries: its emulation
(tiles tested by their centres, span-local uint16 indices, the sweeps'
ping-pong buffers restricted to the cells still exact, each row's first
list position by a binary search of the list, then ranks) is bit-equal to
``seed_labels_plain``, itself the full-frame seeds gathered at the list,
+inf past the count, at capacity, padded, overflowing and where the
frame's last pixel is detected (``_extract``'s inverse map drops that
entry).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from zuds_tpu_torch.ops import detect as td
from zuds_tpu_torch.ops import photometry as ph
from zuds_tpu_torch.ops.compact import compact_indices

torch.set_num_threads(2)

KERNELS = Path(td.__file__).resolve().parent.parent / 'kernels'


def _const(src, name):
    text = (KERNELS / src).read_text()
    m = re.search(rf'constexpr int {name} = (\d+);', text) or re.search(
        rf'#define ZUDS_SEED_GROUP (\d+)', text)
    return int(m.group(1))


MAX_GRID_CUT = _const('photometry.cu', 'kMaxGridCut')
WARPS = _const('photometry.cu', 'kWarps')
AHEAD = _const('photometry.cu', 'kAhead')
TILE = _const('ccl.cu', 'kTile')
HALO = _const('ccl.cu', 'kHalo')
SPAN = TILE + 2 * HALO
OFF = 0xFFFF

# ---- H22: the corner grid -------------------------------------------------


def _edges(p0, cut, c):
    """Each pixel's low and high edge along one axis, as the kernel forms
    them in f32: fl(fl(X - c) -+ 0.5)."""
    d = (p0 + np.arange(cut)).astype(np.float32) - np.float32(c)
    return d - np.float32(0.5), d + np.float32(0.5)


def _edges_shared(p0, cut, c):
    """photometry.cu edges_shared: every high edge bitwise the next low
    edge."""
    lo, hi = _edges(p0, cut, c)
    return bool(np.all(hi[:-1].view(np.uint32) == lo[1:].view(np.uint32)))


def _grid_edges(p0, cut, c):
    """photometry.cu edge_at for i = 0..cut."""
    lo, hi = _edges(p0, cut, c)
    return np.append(lo, hi[-1])


def _arc_int(t, r):
    """ops/photometry.py's arc integral: 0.5 (t sqrt(r^2 - t^2) + r^2
    asin(t / r)), t clamped to [0, r]."""
    rt = torch.as_tensor(r, dtype=torch.float32)
    t = torch.minimum(torch.clamp(t, min=0.0), rt)
    return 0.5 * (t * torch.sqrt(torch.clamp(rt * rt - t * t, min=0.0))
                  + rt * rt * torch.asin(torch.clamp(
                      t / torch.clamp(rt, min=1e-30), -1.0, 1.0)))


def _grid_weights(xs, ys, x0, y0, r, cut):
    """The overlaps as photometry.cu forms them from the corner grid: per
    edge x = min(|ex|, r), its arc integral and sign, y = min(|ey|, r),
    the circle's x there, its arc integral and sign; each corner's signed
    area sx sy (y x1 + (x > x1 ? arc_int(x) - arc_int(xc) : 0)), x1 =
    min(x, xc); each pixel's w the four-term sum (a11 - a01) - a10 + a00,
    clamped."""
    rt = torch.as_tensor(r, dtype=torch.float32)
    out = []
    for xc, yc, px, py in zip(xs, ys, x0, y0):
        ex = torch.as_tensor(_grid_edges(int(px), cut, xc))
        ey = torch.as_tensor(_grid_edges(int(py), cut, yc))
        x = torch.minimum(ex.abs(), rt)
        y = torch.minimum(ey.abs(), rt)
        c = torch.sqrt(torch.clamp(rt * rt - y * y, min=0.0))
        x1 = torch.minimum(x[None, :], c[:, None])            # [y, x]
        arc = torch.where(x[None, :] > x1,
                          _arc_int(x, r)[None, :] - _arc_int(c, r)[:, None],
                          0.0)
        a = ((torch.sign(ex)[None, :] * torch.sign(ey)[:, None])
             * (y[:, None] * x1 + arc))
        w = ((a[1:, 1:] - a[1:, :-1]) - a[:-1, 1:]) + a[:-1, :-1]
        out.append(w.clamp(0.0, 1.0))
    return torch.stack(out)


def _same_bits(a, b):
    """Bit-equal, NaN where the other is NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num(7.0).view(torch.int32),
        b.nan_to_num(7.0).view(torch.int32))


def _positions(H, W, n, seed):
    rng = np.random.default_rng(seed)
    xs = np.r_[rng.uniform(-6, 6, n // 4), rng.uniform(4, W - 4, n // 4),
               rng.uniform(-40, W + 40, n // 4),
               W - rng.uniform(0, 6, n - 3 * (n // 4))]
    ys = rng.uniform(-8, H + 8, n)
    odd = [0.0, -0.0, 0.5, -0.5, 1e10, -1e10, np.nan, np.inf, -np.inf,
           3.5, 4.0, 4.5, 1e-30, -1e-30, 2.0 ** -20]
    xs = np.r_[xs, odd, rng.uniform(4, W - 4, len(odd))]
    ys = np.r_[ys, rng.uniform(4, H - 4, len(odd)), odd]
    return xs.astype(np.float32), ys.astype(np.float32)


@pytest.mark.parametrize('r', [3.0, 6.0])
def test_corner_grid_bit_equal_where_edges_shared(r):
    """Wherever both axes pass the edge test, the grid's overlaps are the
    plain version's bit for bit; positions that fail it keep the per-pixel
    form, and only positions within a few px of 0 fail."""
    H, W = 90, 3100
    cut = ph.aperture_cut(r)
    assert cut <= MAX_GRID_CUT
    xs, ys = _positions(H, W, 400, 3)
    tx, ty = torch.as_tensor(xs), torch.as_tensor(ys)
    x0, y0, _ = ph.aperture_corners(tx, ty, H, W, cut)
    plain = ph.aperture_weights(tx, ty, x0, y0, r, cut)
    grid = _grid_weights(xs, ys, x0.tolist(), y0.tolist(), r, cut)
    shared = np.array([_edges_shared(int(px), cut, xc)
                       and _edges_shared(int(py), cut, yc)
                       for xc, yc, px, py in zip(xs, ys, x0.tolist(),
                                                 y0.tolist())])
    assert shared.sum() > len(xs) // 2 and (~shared).sum() > 10
    for i in np.flatnonzero(shared):
        assert _same_bits(grid[i], plain[i]), (xs[i], ys[i])
    # the rows that fail: a coordinate near 0 (where X - x rounds finer
    # than the half pixel)
    for xc, yc in zip(xs[~shared], ys[~shared]):
        assert abs(xc) < 8 or abs(yc) < 8, (xc, yc)
    # away from 0 the edges are exact: every such position shares
    far = (np.abs(xs) >= 8) & (np.abs(xs) < 4096) & (np.abs(ys) >= 8) \
        & (np.abs(ys) < 4096)
    assert shared[far].all()


def test_corner_grid_infinite_and_far_positions():
    """NaN, +-inf and far-off positions pass the test (every edge is the
    same float, or NaN with the same bits) and the grid's overlaps, NaN or
    0, are still the plain version's."""
    cut = 9
    for c in (np.inf, -np.inf, 1e10, -1e10, np.nan):
        assert _edges_shared(0, cut, np.float32(c))
    xs = np.float32([np.inf, -np.inf, 1e10, 30.0, np.nan])
    ys = np.float32([20.0, 20.0, -1e10, np.inf, 7.0])
    tx, ty = torch.as_tensor(xs), torch.as_tensor(ys)
    x0, y0, _ = ph.aperture_corners(tx, ty, 64, 64, cut)
    plain = ph.aperture_weights(tx, ty, x0, y0, 3.0, cut)
    grid = _grid_weights(xs, ys, x0.tolist(), y0.tolist(), 3.0, cut)
    assert _same_bits(grid, plain)


# ---- H22: the row mapping -------------------------------------------------


def _row_writers(xs, ys, threads=WARPS * 32):
    """photometry.cu's writers of each row: 'own' (the row's warp, or block
    0 for the last row) or 'copy' (block 0's copy loop: the ahead bits of
    its first AHEAD chunks, a comparison past them)."""
    N = len(xs)
    last = N - 1
    bits = np.stack([xs.view(np.uint32), ys.view(np.uint32)], 1)
    same = (bits == bits[last]).all(1)
    writers = [[] for _ in range(N)]
    writers[last].append('own')
    for b in range(1, 1 + -(-(N - 1) // WARPS)):
        for w in range(WARPS):
            n = (b - 1) * WARPS + w
            if n < last and not same[n]:
                writers[n].append('own')
    ahead = np.zeros(threads, np.uint64)
    for k in range(AHEAD):
        q = np.arange(threads) + k * threads
        hit = (q < last) & same[np.minimum(q, last)]
        ahead |= hit.astype(np.uint64) << np.uint64(k)
    for b in range(0, last, threads):
        k = b // threads
        for t in range(threads):
            q = b + t
            dup = (bool((ahead[t] >> np.uint64(k)) & np.uint64(1))
                   if k < AHEAD else (q < last and bool(same[q])))
            if dup:
                writers[q].append('copy')
    return writers, same


@pytest.mark.parametrize('N', [1, 2, 9, 300, 4096, 9000])
def test_row_mapping_one_writer_each(N):
    """Every row has one writer; a row at the last row's position, bitwise,
    is copied; repeated rows elsewhere, -0 against 0 and NaN payloads are
    measured; past AHEAD chunks the copy loop compares (N = 9000)."""
    rng = np.random.default_rng(N)
    xs = rng.uniform(0, 100, N).astype(np.float32)
    ys = rng.uniform(0, 100, N).astype(np.float32)
    xs[N // 3:], ys[N // 3:] = 0.0, 0.0
    if N > 20:
        xs[5:9], ys[5:9] = xs[4], ys[4]
        xs[11] = np.float32(-0.0)
        xs[12:14] = np.float32(np.nan)
        xs[13] = np.uint32(0x7FC00001).view(np.float32)
        xs[-1] = np.float32(np.nan)
        xs[15], ys[15] = xs[-1], ys[-1]
    writers, same = _row_writers(xs, ys)
    assert all(len(w) == 1 for w in writers)
    for n, w in enumerate(writers[:-1]):
        assert (w == ['copy']) == bool(same[n])
    if N > 20:
        assert writers[5] == ['own'] and writers[11] == ['own']
        assert writers[15] == ['copy'] and writers[13] == ['own']
    # the mapped outputs are the plain outputs of every row
    img = torch.as_tensor(rng.normal(100, 5, (128, 128)).astype('f4'))
    tx, ty = torch.as_tensor(xs), torch.as_tensor(ys)
    full = ph.aperture_photometry_batched_plain(img, None, None, tx, ty)
    own = torch.as_tensor([w == ['own'] for w in writers])
    mapped = {}
    for key, v in full.items():
        m = v.clone()
        m[~own] = v[N - 1]
        mapped[key] = m
    for key in full:
        a, b = full[key], mapped[key]
        if a.is_floating_point():
            assert _same_bits(a, b), key
        else:
            assert torch.equal(a, b), key


def test_detected_rows_fill_the_last_rows_position():
    """detect_sources' rows past the frame's objects carry the last row's
    (x, y), bitwise: the rows H22 copies on the slice."""
    rng = np.random.default_rng(5)
    H, W = 128, 160
    img = rng.normal(0, 5, (H, W)).astype('f4')
    yy, xx = np.mgrid[:H, :W]
    for x, y in rng.uniform(10, 110, (6, 2)):
        img += 3e3 * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 6.0)
    out = td.detect_sources(torch.as_tensor(img.astype('f4')),
                            torch.full((H, W), 5.0), max_det=64,
                            return_labels=False)
    n = int(out['n'])
    assert 0 < n < 63
    xs, ys = out['x'].numpy(), out['y'].numpy()
    writers, same = _row_writers(xs, ys)
    assert same[n + 1:].all() and not same[1:n].any()
    assert sum(w == ['own'] for w in writers) <= n + 2


# ---- H24: the seeds at the list's entries ---------------------------------


def _h24_emulate(det, pidx, count, sweeps=12):
    """ccl.cu seed_kernel in numpy: +inf past the listed entries; per tile
    whose centre holds a detected pixel, the span's span-local uint16
    indices, the sweeps' ping-pong buffers (sweep s writes only the listed
    cells at least s from the span's edge), each centre row's first list
    position by a binary search, each detected pixel's by its rank."""
    H, W = det.shape
    cap = len(pidx)
    nl = min(int(count), cap)
    out = np.full(cap, np.inf, np.float32)
    if nl == 0:
        return out
    rr, cc = np.mgrid[:SPAN, :SPAN]
    local = (rr * SPAN + cc).astype(np.uint16)
    for ty in range(-(-H // TILE)):
        for tx in range(-(-W // TILE)):
            centre = det[ty * TILE:(ty + 1) * TILE, tx * TILE:(tx + 1) * TILE]
            if not centre.any():
                continue
            y0, x0 = ty * TILE - HALO, tx * TILE - HALO
            span = np.zeros((SPAN, SPAN), bool)
            ys0, xs0 = max(y0, 0), max(x0, 0)
            ys1, xs1 = min(y0 + SPAN, H), min(x0 + SPAN, W)
            span[ys0 - y0:ys1 - y0, xs0 - x0:xs1 - x0] = det[ys0:ys1, xs0:xs1]
            cur = [np.where(span, local, OFF).astype(np.uint16)]
            cur.append(cur[0].copy())
            c = 0
            for s in range(1, sweeps + 1):
                pad = np.pad(cur[c], 1, constant_values=OFF)
                mins = np.min([pad[1 + dy:1 + dy + SPAN, 1 + dx:1 + dx + SPAN]
                               for dy in (-1, 0, 1) for dx in (-1, 0, 1)], 0)
                inner = ((rr >= s) & (cc >= s) & (rr < SPAN - s)
                         & (cc < SPAN - s))
                cur[c ^ 1] = np.where(span & inner, mins, cur[c ^ 1])
                c ^= 1
            for r in range(TILE):
                y = ty * TILE + r
                if y >= H:
                    continue
                cols = np.flatnonzero(det[y, tx * TILE:(tx + 1) * TILE])
                if not len(cols):
                    continue
                first = int(np.searchsorted(pidx[:nl], y * W + tx * TILE))
                for rank, col in enumerate(cols):
                    pos = first + rank
                    if pos >= nl:
                        continue
                    v = int(cur[c][HALO + r, HALO + col])
                    out[pos] = (y0 + v // SPAN) * W + x0 + v % SPAN
    return out


def _masks():
    rng = np.random.default_rng(11)
    blobs = rng.random((70, 100)) < 0.08
    blobs[10:40, 20:70] = rng.random((30, 50)) < 0.9     # a large blob
    blobs[45:48, 5:95] = True                             # a long bar
    corner = rng.random((67, 93)) < 0.35
    corner[-1, -1] = True
    corner[:32, :32] = True
    snake = np.zeros((64, 96), bool)
    snake[5, 3:90] = snake[5:60, 89] = snake[59, 10:90] = True
    return {'blobs': blobs, 'corner': corner, 'snake': snake,
            'empty': np.zeros((40, 40), bool), 'full': np.ones((33, 70), bool)}


@pytest.mark.parametrize('which', list(_masks()))
def test_seeds_contract_and_emulation(which):
    """seed_labels_plain is the full-frame seeds at the listed entries,
    +inf past them; the kernel's emulation is bit-equal to it at capacity,
    padded and overflowing, and at fewer sweeps."""
    det = _masks()[which]
    t = torch.as_tensor(det)
    n = det.size
    nd = int(det.sum())
    frame = td.seed_frame_plain(t).reshape(-1)
    for cap in sorted({n, min(n, nd + 37), max(1, nd // 2)}):
        pidx, count = compact_indices(t.reshape(-1), cap, n - 1)
        got = td.seed_labels_plain(t, pidx, count)
        listed = min(nd, cap)
        assert torch.equal(got[:listed], frame[pidx[:listed]])
        assert bool(torch.isinf(got[listed:]).all())
        assert torch.equal(td.seed_labels(t, pidx, count), got)
        em = _h24_emulate(det, pidx.numpy(), int(count))
        assert np.array_equal(em, got.numpy()), (which, cap)
    if which == 'blobs':
        pidx, count = compact_indices(t.reshape(-1), n, n - 1)
        for sweeps in (0, 1, 5):
            assert np.array_equal(
                _h24_emulate(det, pidx.numpy(), int(count), sweeps),
                td.seed_labels_plain(t, pidx, count, sweeps).numpy())


@pytest.mark.parametrize('det_cap', [4096, 512])
def test_extract_seeds_with_the_last_pixel_detected(det_cap):
    """_extract with the frame's last pixel detected: the list padded
    (inv[H*W-1] is -1, the reference's padded write, yet the pixel is
    listed) or overflowing; the seeds at the list's entries are the
    full-frame seeds there, so lab0 is the parent's, and the emulation
    writes the last pixel's own entry."""
    rng = np.random.default_rng(4)
    det = rng.random((64, 80)) < 0.35
    det[-3:, -3:] = True
    det[:2, :] = False
    det[-1, -1] = True
    t = torch.as_tensor(det)
    H, W = det.shape
    st = td._extract(torch.full((H, W), 1000.0), torch.ones((H, W)), t, 5.0,
                     5, 64, det_cap)
    assert bool(st['det'].equal(t))
    nd = int(st['ndet_pix'])
    padded = nd < det_cap
    assert padded == (det_cap == 4096)
    pidx, pok, inv = st['pidx'], st['pok'], st['inv']
    if padded:
        assert int(inv[-1]) == -1 and int(pidx[nd - 1]) == H * W - 1
    seeds = td.seed_labels(t, pidx, st['ndet_pix'])
    old = td.seed_frame_plain(t).reshape(-1)[pidx]
    assert torch.equal(seeds[pok], old[pok])
    seedpos = inv[torch.where(pok, old, 0.0).to(torch.int64)].clamp(min=0)
    assert torch.equal(st['lab0'], torch.where(
        pok, seedpos, torch.arange(det_cap)))
    em = _h24_emulate(det, pidx.numpy(), nd)
    assert np.array_equal(em, seeds.numpy())
    if padded:
        assert np.isfinite(em[nd - 1])
