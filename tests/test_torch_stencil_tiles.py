"""The decomposition of the stencil kernels H4 (``zuds_tpu_torch/kernels/
detect_filter.cu``) and H7 (``kernels/stamps.cu``), emulated in numpy
float32 on the CPU, against the port's plain versions
``matched_filter_plain`` and ``stamp_candidates_plain``: bit-equal.

H4: a warp walks a strip of R rows (``ZUDS_DETECT_ROWS``, read from the
source, and other values the kernel admits) over 32 lanes of V columns (4,
or 1 where W % 4 != 0); a row's masked values m = good ? d : 0 take their
halo columns from the neighbouring lanes (``__shfl_up_sync`` /
``__shfl_down_sync``) and, at lanes 0 and 31, from a direct load; the strip
reads its two halo rows again; the nine taps are added in row-major order
from +0, the taps off the frame too. The emulation writes into poisoned
planes, so a pixel written twice or never shows.

H7: a block owns a TW x TH tile (``kTW``, ``kTH``, read from the source),
copies it with a 5-px image halo (columns x0 - 8 ... x0 + TW + 8, the copy
index stepped without a division; every slot copied once), computes
``filt`` on a thread's 4 x 4 pixels from six image rows (a 16-byte load
and shuffled halo values), tests the threshold first (only in a thread
whose largest ``filt`` is over it, from ``filt`` and ``img`` read back),
computes the bands of the 4-px ring of ``filt`` that a passing pixel's
window reaches, queues a warp's passing pixels (an exclusive scan of the
lanes' counts), compares each one's 3x3
and, for the survivors (compacted by a ballot), its whole 9x9 window
directly (NaN fails, -inf off the frame), and writes the candidate bytes
from a byte map, 16 bytes a lane (bytes where W % 16 != 0). The emulation
checks that every value a window reads was written and every byte stored
once.

H4 is also held to the JAX reference: ``zuds_tpu/ops/detect.py:607-616``
(the good mask, ``conv2_same`` of ``zuds_tpu/ops/convolve.py``, the
threshold) composed from the reference's own functions under ``jax.jit``,
as ``detect_sources`` runs it. XLA's CPU backend flushes subnormal
values to zero, inputs and results (an rms of 1e-39 is not > 0 there, a
product 2^-4 x 2e-38 is 0), and may contract ``out + w * tap`` into one
FMA; the port's plain version and H4 keep subnormal values and round each
product before its add, as IEEE f32 does on the card. On the cases with
subnormal values the test compares with the plain version only, and checks
that the JAX result differs from it only within one pixel of an input
that is subnormal or whose products with the taps are. XLA's algebraic
simplifier also drops the sum's start (``0 + x`` is x) and the taps it
knows to be zero (a frame narrower than the filter), so where every tap is
a zero the reference's ``filt`` is -0 and the plain version's +0 (the
plain version and H4 add every tap from +0): ``filt``'s zeros are
compared by value with the JAX reference, bit for bit with the plain
version.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zuds_tpu.ops.convolve import DEFAULT_FILTER as J_FILTER
from zuds_tpu.ops.convolve import conv2_same as j_conv2_same
from zuds_tpu_torch.ops import detect as tdetect
from zuds_tpu_torch.ops import measure as tmeasure
from zuds_tpu_torch.ops.ordered import fma

F = np.float32
FLT_MAX = F(np.finfo(F).max)
KERNELS = Path(tdetect.__file__).resolve().parents[1] / 'kernels'
SHAPES = [(1, 1), (3, 5), (33, 70), (97, 131), (200, 136), (257, 130)]


def _source_int(name, pattern):
    m = re.search(pattern, (KERNELS / name).read_text())
    assert m, (name, pattern)
    return int(m.group(1))


H4_ROWS = _source_int('detect_filter.cu', r'#define ZUDS_DETECT_ROWS (\d+)')
H4_WARPS = _source_int('detect_filter.cu', r'constexpr int kWarps = (\d+);')
H7_TW = _source_int('stamps.cu', r'constexpr int kTW = (\d+);')
H7_TH = _source_int('stamps.cu', r'constexpr int kTH = (\d+);')
H7_THREADS = _source_int('stamps.cu', r'constexpr int kThreads = (\d+);')
H7_R = _source_int('stamps.cu', r'constexpr int kR = (\d+);')


@pytest.fixture(autouse=True)
def _quiet():
    # NaN compares and inf - inf are what the cases exercise
    with np.errstate(over='ignore', invalid='ignore', under='ignore'):
        yield


def _w(dy, dx):
    """The pyramid's tap weight, as ``tap_weight`` of both sources."""
    return F((2 - (dy - 1) ** 2) * (2 - (dx - 1) ** 2)) * F(0.0625)


def _taps(rows):
    """The nine taps of three rows, each (..., n + 2): row-major from +0,
    every product rounded before its add (``__fmul_rn`` / ``__fadd_rn``)."""
    n = rows[0].shape[-1] - 2
    acc = np.zeros(rows[0].shape[:-1] + (n,), F)
    for dy in range(3):
        for dx in range(3):
            acc = (acc + _w(dy, dx) * rows[dy][..., dx:dx + n]).astype(F)
    return acc


# ---------------------------------------------------------------- H4 ----

def h4_emulate(diff, rms, wok, nsigma, V, R=H4_ROWS, warps=H4_WARPS):
    """detect_filter.cu's grid, warps, lanes and strips in numpy f32."""
    diff, rms = np.asarray(diff, F), np.asarray(rms, F)
    wok = np.asarray(wok, np.uint8)
    H, W = diff.shape
    img = np.full((H, W), np.nan, F)
    filt = np.full((H, W), np.nan, F)
    det = np.full((H, W), 2, np.uint8)
    nwritten = np.zeros((H, W), np.int64)
    ns = F(nsigma)
    strips = -(-H // R)
    lanes = np.arange(32)

    def load(y, x, hx):
        """One row's loads: (32, V) values (0 off the frame) and the outer
        column of lanes 0 and 31 (0 where hx is off the frame)."""
        d = np.zeros((32, V), F)
        r = np.zeros((32, V), F)
        w = np.zeros((32, V), np.uint8)
        hd = np.zeros(32, F)
        hr = np.zeros(32, F)
        hw = np.zeros(32, np.uint8)
        if 0 <= y < H:
            for c in range(V):
                on = x + c < W
                if V == 4:       # one 16-byte load: all four or none
                    on = x < W
                d[on, c] = diff[y, x[on] + c]
                r[on, c] = rms[y, x[on] + c]
                w[on, c] = wok[y, x[on] + c]
            on = (hx >= 0) & (hx < W)
            hd[on] = diff[y, hx[on]]
            hr[on] = rms[y, hx[on]]
            hw[on] = wok[y, hx[on]]
        return d, r, w, hd, hr, hw

    def good(d, r, w):
        return (w != 0) & (r > 0) & (np.abs(d) <= FLT_MAX)

    def mask_row(row):
        d, r, w, hd, hr, hw = row
        g = good(d, r, w)
        m = np.where(g, d, F(0))
        hm = np.where(good(hd, hr, hw), hd, F(0))
        left = np.roll(m[:, V - 1], 1)       # __shfl_up_sync(m[V], 1)
        right = np.roll(m[:, 0], -1)         # __shfl_down_sync(m[1], 1)
        left[0], right[31] = hm[0], hm[31]   # lanes 0 and 31 load theirs
        return np.concatenate([left[:, None], m, right[:, None]], 1), r, g

    for by in range(-(-strips // warps)):
        for bx in range(-(-W // (32 * V))):
            for warp in range(warps):
                y0 = (by * warps + warp) * R
                if y0 >= H:
                    continue
                xw = bx * 32 * V
                x = xw + lanes * V
                hx = np.where(lanes == 0, xw - 1,
                              np.where(lanes == 31, xw + 32 * V, -1))
                up = mask_row(load(y0 - 1, x, hx))[0]
                mid, rmid, gmid = mask_row(load(y0, x, hx))
                for i in range(R):
                    y = y0 + i
                    if y >= H:
                        break
                    dn, rdn, gdn = mask_row(load(y + 1, x, hx))
                    f = _taps([up, mid, dn])
                    dt = gmid & (f > (ns * rmid).astype(F))
                    for c in range(V):
                        on = (x < W) if V == 4 else (x + c < W)
                        xs = x[on] + c
                        img[y, xs] = mid[on, c + 1]
                        filt[y, xs] = f[on, c]
                        det[y, xs] = dt[on, c]
                        nwritten[y, xs] += 1
                    up, mid, rmid, gmid = mid, dn, rdn, gdn
    assert (nwritten == 1).all(), 'a pixel written twice or never'
    return img, filt, det.astype(bool)


def h4_frame(H, W, seed, case):
    """diff, rms, weight_ok with NaN, +-inf, -0 on good pixels, rms <= 0,
    weight holes, and for ``case='subnormal'`` a band of subnormal values
    (and 2^-149) whose products with the taps are inexact."""
    rng = np.random.default_rng(seed)
    diff = (8.0 * rng.standard_normal((H, W))).astype(F)
    rms = np.abs(rng.uniform(0.5, 5.0, (H, W))).astype(F)
    wok = rng.random((H, W)) > 0.05
    pick = rng.integers(0, H * W, (6, max(1, H * W // 97)))
    flat = diff.reshape(-1)
    flat[pick[0]] = np.nan
    flat[pick[1]] = np.inf
    flat[pick[2]] = -np.inf
    flat[pick[3]] = -0.0
    rms.reshape(-1)[pick[4]] = 0.0
    rms.reshape(-1)[pick[5]] = -1.0
    diff[H // 2, ::2] = -0.0
    wok[H // 2, ::2] = True
    rms[H // 2, ::2] = 1.0
    if case == 'subnormal':
        band = slice(H // 3, H // 3 + 4)
        diff[band] = ((rng.random(diff[band].shape) - 0.5) * 2e-38).astype(F)
        diff[band, ::5] = F(1.4e-45) * np.sign(rng.random(
            diff[band, ::5].shape) - 0.5).astype(F)
        rms[band] = F(1e-39)
        wok[band] = True
    return diff, rms, wok


def _bits(a):
    return np.asarray(a).view(np.uint8)


def _plain_h4(diff, rms, wok, nsigma):
    out = tdetect.matched_filter_plain(torch.from_numpy(diff),
                                       torch.from_numpy(rms),
                                       torch.from_numpy(wok), nsigma)
    return [t.numpy() for t in out]


@jax.jit
def _jax_h4(diff, rms, wok):
    """zuds_tpu/ops/detect.py:607-616 at nsigma 1.5, from the reference's
    own conv2_same and filter."""
    good = wok & (rms > 0) & jnp.isfinite(diff)
    img = jnp.where(good, diff, 0.0)
    filt = j_conv2_same(img, J_FILTER)
    return img, filt, good & (filt > 1.5 * rms)


def _h4_cases():
    out = []
    for H, W in SHAPES + [(40, 132), (17, 260)]:
        for V in ((4, 1) if W % 4 == 0 else (1,)):
            out.append((H, W, V, 'specials'))
    out += [(97, 131, 1, 'subnormal'), (200, 136, 4, 'subnormal')]
    return out


@pytest.mark.parametrize('H,W,V,case', _h4_cases())
def test_h4_decomposition_bit_equal(H, W, V, case):
    diff, rms, wok = h4_frame(H, W, H * 1000 + W, case)
    got = h4_emulate(diff, rms, wok, 1.5, V)
    want = _plain_h4(diff, rms, wok, 1.5)
    for plane, a, b in zip(('img', 'filt', 'det'), got, want):
        assert np.array_equal(_bits(a), _bits(b)), plane
    if H > 4:
        assert (want[0] == 0).any() and np.signbit(want[0][want[0] == 0]).any()
    ref = [np.asarray(t) for t in _jax_h4(diff, rms, wok)]
    if case != 'subnormal':
        assert np.array_equal(_bits(got[0]), _bits(ref[0]))
        assert np.array_equal(got[2], ref[2])
        zeros = (got[1] == 0) & (ref[1] == 0)    # their sign: see above
        assert np.array_equal(_bits(np.where(zeros, F(0), got[1])),
                              _bits(np.where(zeros, F(0), ref[1])))
    else:
        # XLA flushes subnormal values: the planes may differ only within
        # a pixel of an input that is subnormal or has subnormal products
        tiny = ((diff != 0) & (np.abs(diff) < 16 * np.finfo(F).tiny)) | \
            ((rms != 0) & (np.abs(rms) < np.finfo(F).tiny))
        near = np.zeros_like(tiny)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                near |= np.roll(np.roll(tiny, dy, 0), dx, 1)
        for a, b in zip(got, ref):
            differ = (_bits(a).reshape(H, W, -1)
                      != _bits(b).reshape(H, W, -1)).any(2)
            assert not (differ & ~near).any()
        assert (_bits(got[1]) != _bits(ref[1])).any()   # the case bites


@pytest.mark.parametrize('R', [1, 7, 16])
def test_h4_other_strip_heights(R):
    """Strips of R rows other than the source's: the halo rows and the
    ragged last strip at any height."""
    for H, W, V in ((33, 70, 1), (97, 132, 4)):
        diff, rms, wok = h4_frame(H, W, R, 'specials')
        got = h4_emulate(diff, rms, wok, 1.5, V, R=R)
        want = _plain_h4(diff, rms, wok, 1.5)
        for a, b in zip(got, want):
            assert np.array_equal(_bits(a), _bits(b))


# ---------------------------------------------------------------- H7 ----

def h7_copy_slots(vec, TW=H7_TW, TH=H7_TH, threads=H7_THREADS):
    """stamps.cu's load_tile: the (row, column) slots each thread copies,
    its index stepped by (threads // width, threads % width)."""
    IH, IW = TH + 2 * (H7_R + 1), TW + 16
    width = IW // 4 if vec else IW
    dr, dc = threads // width, threads % width
    slots = []
    for t in range(threads):
        r, c = t // width, t % width
        while r < IH:
            slots.append((r, c))
            r, c = r + dr, c + dc
            if c >= width:
                c, r = c - width, r + 1
    return slots, IH, width


@pytest.mark.parametrize('vec', [True, False])
def test_h7_copy_covers_each_slot_once(vec):
    slots, IH, width = h7_copy_slots(vec)
    assert len(slots) == IH * width
    assert sorted(slots) == [(r, c) for r in range(IH) for c in range(width)]


def h7_emulate(img, med, sigma, sat, margin, TW=H7_TW, TH=H7_TH, R=H7_R):
    """stamps.cu's tiles, threads, ring and windows in numpy f32. Returns
    (filt written at the candidates only, NaN elsewhere; cand)."""
    img = np.asarray(img, F)
    H, W = img.shape
    thr = F(fma(torch.tensor(10.0), torch.tensor(sigma),
                torch.tensor(med)).item())
    filt_out = np.full((H, W), np.nan, F)
    cand_out = np.full((H, W), 2, np.uint8)
    IH, IW, IX = TH + 2 * (R + 1), TW + 16, 8
    FH, FW = TH + 2 * R, TW + 2 * R
    warps = TH // 4
    lanes = np.arange(32)
    for by in range(-(-H // TH)):
        for bx in range(-(-W // TW)):
            x0, y0 = bx * TW, by * TH
            s_img = np.zeros((IH, IW), F)
            gy = y0 - (R + 1) + np.arange(IH)
            gx = x0 - IX + np.arange(IW)
            oy, ox = (gy >= 0) & (gy < H), (gx >= 0) & (gx < W)
            s_img[np.ix_(oy, ox)] = img[np.ix_(gy[oy], gx[ox])]
            s_filt = np.full((FH, FW), np.nan, F)
            written = np.zeros((FH, FW), bool)
            f = np.zeros((warps, 32, 4, 4), F)
            pas = np.zeros((warps, 32, 4, 4), bool)
            for w in range(warps):
                e = np.zeros((6, 32, 6), F)
                for k in range(6):
                    row = s_img[4 * w + R + k]
                    q = np.stack([row[4 * lanes + IX + c] for c in range(4)],
                                 1)
                    left, right = np.roll(q[:, 3], 1), np.roll(q[:, 0], -1)
                    left[0], right[31] = row[IX - 1], row[4 * 31 + IX + 4]
                    e[k] = np.concatenate([left[:, None], q, right[:, None]],
                                          1)
                for i in range(4):
                    acc = _taps([e[i], e[i + 1], e[i + 2]])      # (32, 4)
                    gyy = y0 + 4 * w + i
                    gxx = x0 + 4 * lanes[:, None] + np.arange(4)[None]
                    on = (gyy < H) & (gxx < W)
                    f[w, :, i] = np.where(on, acc, F(-np.inf))
                    s_filt[4 * w + i + R, 4 * lanes[:, None] + R
                           + np.arange(4)[None]] = f[w, :, i]
                    written[4 * w + i + R, R:R + TW] = True
                # the full test only in a thread whose largest filt is over
                # the threshold, from filt and img read back
                gate = np.nanmax(f[w].reshape(32, 16), 1) > thr
                for i in range(4):
                    gyy = y0 + 4 * w + i
                    gxx = x0 + 4 * lanes[:, None] + np.arange(4)[None]
                    fs = s_filt[4 * w + i + R, 4 * lanes[:, None] + R
                                + np.arange(4)[None]]
                    v = s_img[4 * w + i + R + 1, 4 * lanes[:, None] + IX
                              + np.arange(4)[None]]
                    pas[w, :, i] = (gate[:, None] & (fs > thr) & (v < F(sat))
                                    & (gxx >= margin) & (gxx < W - margin)
                                    & (gyy >= margin) & (gyy < H - margin))
            cmap = np.zeros((warps, 4, TW), np.uint8)
            if pas.any():                     # __syncthreads_or
                # the ring bands: above (warp 0), below (the last warp),
                # left (lane 0), right (lane 31) of a passing pixel
                need = (1 if pas[0].any() else 0) | \
                    (2 if pas[warps - 1].any() else 0) | \
                    (4 if pas[:, 0].any() else 0) | \
                    (8 if pas[:, 31].any() else 0)
                for k in range(FH * FW - TH * TW):
                    if k < 2 * R * FW:
                        r = k // FW
                        fy, fx = (r if r < R else r + TH), k - r * FW
                        band = 1 if r < R else 2
                    else:
                        q = k - 2 * R * FW
                        c = q % (2 * R)
                        fy, fx = R + q // (2 * R), (c if c < R else c + TW)
                        band = 4 if c < R else 8
                    assert not written[fy, fx]
                    if not need & band:
                        continue
                    gyy, gxx = y0 - R + fy, x0 - R + fx
                    if 0 <= gyy < H and 0 <= gxx < W:
                        c0 = fx + IX - R - 1
                        rows = [s_img[fy + dy, c0:c0 + 3][None]
                                for dy in range(3)]
                        s_filt[fy, fx] = _taps(rows)[0, 0]
                    else:
                        s_filt[fy, fx] = -np.inf
                    written[fy, fx] = True
                for w in range(warps):
                    # queue A: each lane's passing pixels at its exclusive
                    # prefix, (row in the warp) << 7 | column
                    bits = pas[w].reshape(32, 16)
                    off = np.concatenate([[0], np.cumsum(bits.sum(1))])
                    qa = np.zeros(512, np.int64)
                    for lane in range(32):
                        for n, bit in enumerate(np.nonzero(bits[lane])[0]):
                            qa[off[lane] + n] = (bit >> 2) << 7 | \
                                (4 * lane + (bit & 3))
                    total = off[32]
                    qb = []
                    for k0 in range(0, total, 32):   # a pixel a lane, 3x3
                        for q in qa[k0:min(total, k0 + 32)]:
                            ty, tx = 4 * w + (q >> 7), q & 127
                            win = s_filt[ty + R - 1:ty + R + 2,
                                         tx + R - 1:tx + R + 2]
                            assert written[ty + R - 1:ty + R + 2,
                                           tx + R - 1:tx + R + 2].all()
                            if (win <= s_filt[ty + R, tx + R]).all():
                                qb.append(q)         # ballot order = lanes
                    for q in qb:                     # the survivors, 9x9
                        ty, tx = 4 * w + (q >> 7), q & 127
                        fv = s_filt[ty + R, tx + R]
                        assert written[ty:ty + 2 * R + 1,
                                       tx:tx + 2 * R + 1].all()
                        if (s_filt[ty:ty + 2 * R + 1,
                                   tx:tx + 2 * R + 1] <= fv).all():
                            cmap[w, q >> 7, tx] = 1
                            filt_out[y0 + ty, x0 + tx] = fv
            # lane l of warp w writes 16 bytes: row 4 w + l // 8, columns
            # 16 (l % 8) ...
            for w in range(warps):
                for lane in range(32):
                    gyy = y0 + 4 * w + (lane >> 3)
                    gxx = x0 + 16 * (lane & 7)
                    if gyy >= H or gxx >= W:
                        continue
                    c0 = 16 * (lane & 7)
                    b = cmap[w, lane >> 3, c0:c0 + 16]
                    n = 16 if W % 16 == 0 else min(16, W - gxx)
                    assert (cand_out[gyy, gxx:gxx + n] == 2).all()
                    cand_out[gyy, gxx:gxx + n] = b[:n]
    assert (cand_out != 2).all(), 'a candidate byte never written'
    return filt_out, cand_out.astype(bool)


def h7_frame(H, W, seed, field):
    """Stars on noise 5 about 150; candidates placed at the tile corners
    and on the margin's edge; NaN within 4 px of some peaks; ±inf, -0 and
    subnormal values; 'crowded' (1% of pixels a source) or 'blank'."""
    rng = np.random.default_rng(seed)
    img = (150.0 + 5.0 * rng.standard_normal((H, W))).astype(F)
    yy, xx = np.mgrid[0:H, 0:W]
    if field == 'blank':
        return img
    if field == 'crowded':
        n = max(1, H * W // 100)
        pts = np.zeros(H * W)
        np.add.at(pts, rng.integers(0, H * W, n),
                  10 ** rng.uniform(2.5, 4.5, n))
        pts = pts.reshape(H, W)
        ax = np.arange(-6, 7)
        k = np.exp(-(ax ** 2) / 4.5)
        k /= k.sum()
        for axis in (0, 1):
            pts = np.apply_along_axis(
                lambda v: np.convolve(v, k, mode='same'), axis, pts)
        return (img + pts).astype(F)
    peaks = [(rng.uniform(0, H), rng.uniform(0, W)) for _ in range(12)]
    for ty in (H7_TH - 1, H7_TH, 2 * H7_TH - 1):          # tile corners
        for tx in (H7_TW - 1, H7_TW):
            peaks.append((ty, tx))
    m = 5
    peaks += [(H // 2, m), (H // 2 + 9, W - m - 1), (m, W // 2),
              (H // 2 - 9, m - 1)]                       # margin edges
    for py, px in peaks:
        img += (3000.0 * np.exp(-((yy - py) ** 2 + (xx - px) ** 2) / 3.0)
                ).astype(F)
    if field == 'specials':
        ys, xs = rng.integers(0, H, 8), rng.integers(0, W, 8)
        img[ys[:2], xs[:2]] = np.nan
        img[ys[2], xs[2]] = np.inf
        img[ys[3], xs[3]] = -np.inf
        img[ys[4], xs[4]] = -0.0
        img[ys[5], xs[5]] = F(1e-40)
        img[ys[6], xs[6]] = F(-1.4e-45)
        for py, px in peaks[:6]:                          # NaN near peaks
            dy, dx = rng.integers(-4, 5, 2)
            img[int(min(max(py + dy, 0), H - 1)),
                int(min(max(px + dx, 0), W - 1))] = np.nan
        img[H // 3, W // 3] = 7e4                          # saturated
    return img


def _plain_h7(img, med, sigma, sat, margin):
    f, c = tmeasure.stamp_candidates_plain(
        torch.from_numpy(img), torch.tensor(med, dtype=torch.float32),
        torch.tensor(sigma, dtype=torch.float32), sat, margin)
    return f.numpy(), c.numpy()


def _h7_cases():
    out = [(H, W, 'specials') for H, W in SHAPES]
    out += [(H, W, 'stars') for H, W in SHAPES[2:]]
    out += [(200, 136, 'crowded'), (257, 130, 'crowded'),
            (200, 136, 'blank'), (64, 256, 'stars'), (64, 256, 'specials')]
    return out


@pytest.mark.parametrize('H,W,field', _h7_cases())
def test_h7_decomposition_bit_equal(H, W, field):
    img = h7_frame(H, W, H * 7 + W, field)
    fin = img[np.isfinite(img)]
    med = F(np.median(fin)) if fin.size else F(0)
    sigma = F(1.4826) * F(np.median(np.abs(fin - med))) if fin.size \
        else F(1)
    margin = 5
    kf, kc = h7_emulate(img, med, sigma, 6e4, margin)
    pf, pc = _plain_h7(img, med, sigma, 6e4, margin)
    assert np.array_equal(kc, pc)
    assert np.array_equal(_bits(kf[kc]), _bits(pf[pc]))
    if field == 'blank':
        assert not pc.any()
    elif min(H, W) > 2 * margin + 8:
        assert pc.sum() > 0
