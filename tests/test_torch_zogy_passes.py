"""H17's and H16's decompositions (``zuds_tpu_torch/kernels/zogy.cu``,
``psf_stamps_kernel`` and ``normalize_kernel``) emulated in numpy on the
CPU, against the plain versions of ``zuds_tpu_torch/ops/zogy.py`` and the
JAX package's ``estimate_psf_from_stars`` and ``zogy_subtract``.

H17 shifts each star's cut by the Fourier phase ramp as four DFT passes in
float64 over the half spectrum (columns v < n // 2 + 1) of the ramped
spectrum's Hermitian part, whose inverse is the real part the reference
keeps: P1 the real rows (columns c and n - c paired), P2 and P3 the
conjugate rows k and n - k from one set of four sums (the even and odd
terms on two lanes, added once), the ramp folded into P2's outputs as
(E(u, v) + conj(E(-u, -v))) / 2, P3's columns weighted for P4, and P4 the
real part of the inverse along x (columns c and n - c from two sums). The
twiddles come by recurrence along each lane's terms (held within 1e-13 of
the table's). The emulation keeps the
kernel's order of every sum (numpy rounds the products the kernel fuses
into FMAs: float64 noise), the f32 median and the stamp's f32 sum (its
lanes read from the source), and is held against ``psf_stamps_plain`` (1e-7
absolute on the unit-sum stamps, ``good0`` equal, NaN where the plain
version has it) at sizes 1, 2, 15, 24, 25 and 32 with clamped corners,
padding rows and a NaN pixel, and, through ``psf_clip_plain``, against the
JAX package's PSF on ``tests/test_torch_zogy.py``'s scenes (1e-7).

H16 sums fl(p_d^2) in double over each block's contiguous slab (four
chains a thread, 16-byte chunks or single floats), a fixed tree a block,
the partials added in one fixed order by every block, rounded once to f32.
Held against ``score_normalize_plain`` (1e-6 relative, the kernels' card
gate) for several block counts, lengths that are no multiple of 4 or
under one slab, zeros (the 1e-20 clamp) and a NaN, and against the JAX
``zogy_subtract``'s ``s_corr`` on ``tests/test_torch_zogy.py``'s scenes
(1e-3 absolute, that file's tolerance).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zuds_tpu.ops import zogy as jz
from zuds_tpu_torch.ops import zogy as tz
from test_torch_zogy import (ARGS, SCENES, hard_scene, psf_scene, render,
                             run_jax)

F32 = np.float32
_SRC = (Path(tz.__file__).resolve().parents[1] / 'kernels'
        / 'zogy.cu').read_text()


def _constant(pattern):
    return int(re.search(pattern, _SRC).group(1))


SUM_LANES = _constant(r'constexpr int kSumLanes = (\d+);')
NORM_THREADS = _constant(r'constexpr int kNormThreads = (\d+);')


# ---- H17 ---------------------------------------------------------------------

def _twiddles(n):
    """(cos, -sin) of 2 pi k / n, k < n, with sincospi's exact zeros and
    ones at the multiples of a quarter turn."""
    k = np.arange(n)
    c = np.cos(2 * np.pi * k / n)
    s = np.sin(2 * np.pi * k / n)
    quarter = (4 * k) % n == 0
    turns = ((4 * k) // n) % 4
    c[quarter] = np.array([1.0, 0.0, -1.0, 0.0])[turns[quarter]]
    s[quarter] = np.array([0.0, 1.0, 0.0, -1.0])[turns[quarter]]
    return c, -s


def _times(w, z):
    """The kernel's twiddle recurrence step w z (complex, in double)."""
    return complex(w.real * z.real - w.imag * z.imag,
                   w.real * z.imag + w.imag * z.real)


def _checked(w, k, n, wc, ws):
    """The recurrence's twiddle, held within 1e-13 of w^k's table value."""
    exact = complex(wc[k % n], ws[k % n])
    assert abs(w - exact) < 1e-13, (w, exact)
    return w


def _ramp(n, dx, dy):
    """The kernel's ramp table (S, n, m) complex: (E(u, v) + conj(E(-u,
    -v))) / 2 of the reference's f32 ramp E = exp(i 2 pi (fq[u] dy + fq[v]
    dx)), its cosine and sine as the plain version takes them."""
    m = n // 2 + 1
    fq = tz._fftfreq(n, torch.float32, 'cpu').numpy()
    two_pi = F32(2 * np.pi)
    dx = torch.as_tensor(dx)[:, None, None]
    dy = torch.as_tensor(dy)[:, None, None]

    def e(u, v):
        fu = torch.as_tensor(fq[u])[None, :, None]
        fv = torch.as_tensor(fq[v])[None, None, :]
        th = two_pi * (fu * dy + fv * dx)
        return (torch.cos(th).double().numpy(),
                torch.sin(th).double().numpy())

    u, v = np.arange(n), np.arange(m)
    er, ei = e(u, v)
    fr, fi = e((n - u) % n, (n - v) % n)
    return 0.5 * (er + fr) + 1j * (0.5 * (ei - fi))


def _pair_pass(x, wc, ws, n, forward):
    """P2 (forward) and P3 along axis 1 of x (S, n, m) complex: for each
    pair of rows k, n - k (k < m) the two lanes' four sums over the even and
    the odd j, the twiddle w^(kj) by recurrence (w^(kh), then times
    w^(2k)), added lane to lane."""
    m = x.shape[2]
    out = np.zeros_like(x)
    for k in range(m):
        sums = []
        step = complex(wc[(2 * k) % n], ws[(2 * k) % n])
        for h in (0, 1):
            sap = sbq = saq = sbp = np.zeros(x.shape[::2])
            w = complex(wc[h * k % n], ws[h * k % n])
            for j in range(h, n, 2):
                a, b = _checked(w, k * j, n, wc, ws).real, w.imag
                p, q = x[:, j].real, x[:, j].imag
                sap, sbq = a * p + sap, b * q + sbq
                saq, sbp = a * q + saq, b * p + sbp
                w = _times(w, step)
            sums.append((sap, sbq, saq, sbp))
        sap, sbq, saq, sbp = (sums[0][i] + sums[1][i] for i in range(4))
        w_x = (sap - sbq) + 1j * (saq + sbp)      # sum w^(kj) x
        c_x = (sap + sbq) + 1j * (saq - sbp)      # sum conj(w^(kj)) x
        out[:, k] = w_x if forward else c_x
        if (n - k) % n != k:
            out[:, n - k] = c_x if forward else w_x
    return out


def _block_sum_f32(vals, threads):
    """block_sum: thread t's f32 sum of vals[t::threads], each warp's xor
    butterfly, then the warps' values by a butterfly of one warp."""
    acc = np.zeros(vals.shape[:-1] + (threads,), F32)
    for i in range(vals.shape[-1]):
        acc[..., i % threads] += vals[..., i]
    nw = (threads + 31) // 32
    lanes = np.zeros(vals.shape[:-1] + (nw * 32,), F32)
    lanes[..., :threads] = acc
    lanes = lanes.reshape(vals.shape[:-1] + (nw, 32))
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ o]
    red = np.zeros(vals.shape[:-1] + (32,), F32)
    red[..., :nw] = lanes[..., 0]
    for o in (16, 8, 4, 2, 1):
        red = red + red[..., np.arange(32) ^ o]
    return red[..., 0]


def emulate_stamps(img, xs, ys, valid, n, threads=SUM_LANES):
    """psf_stamps_kernel in numpy: (stamps (S, n, n) f32, good0 (S,))."""
    H, W = img.shape
    half, m = n // 2, n // 2 + 1
    x0 = np.minimum(np.maximum(np.rint(xs).astype(int) - half, 0), W - n)
    y0 = np.minimum(np.maximum(np.rint(ys).astype(int) - half, 0), H - n)
    dx = (xs - (x0 + half).astype(F32)).astype(F32)
    dy = (ys - (y0 + half).astype(F32)).astype(F32)
    r = np.arange(n)
    x = img[(y0[:, None] + r)[:, :, None],
            (x0[:, None] + r)[:, None, :]].astype(np.float64)
    wc, ws = _twiddles(n)
    # P1: B[r][v] = x[r][0] + sum_c (x_c + x_{n-c}) a + i (x_c - x_{n-c}) b,
    # the twiddle w^(vc) by recurrence (times w^v), the Nyquist column
    # (even n) last, its +-1 from the table
    B = np.zeros((len(xs), n, m), complex)
    for v in range(m):
        re, im = x[:, :, 0].copy(), np.zeros(x.shape[:2])
        step = complex(wc[v % n], ws[v % n])
        w = step
        for c in range(1, n):
            if 2 * c >= n:
                break
            a, b = _checked(w, v * c, n, wc, ws).real, w.imag
            re = (x[:, :, c] + x[:, :, n - c]) * a + re
            im = (x[:, :, c] - x[:, :, n - c]) * b + im
            w = _times(w, step)
        if n > 1 and n % 2 == 0:
            re = x[:, :, half] * wc[(v % 2) * half] + re
        B[:, :, v] = re + 1j * im
    F = _pair_pass(B, wc, ws, n, True)
    Hs = F * _ramp(n, dx, dy)
    C = _pair_pass(Hs, wc, ws, n, False)
    C[:, :, 1:] *= np.where(2 * np.arange(1, m) == n, 1.0, 2.0)
    # P4: the columns c and n - c from s1 = sum Cr a, s2 = sum Ci b, the
    # twiddle w^(vc) by recurrence (times w^c)
    st = np.zeros((len(xs), n, n), F32)
    inv_nn = 1.0 / (n * n)
    for c in range(m):
        s1 = s2 = np.zeros(C.shape[:2])
        step, w = complex(wc[c % n], ws[c % n]), 1 + 0j
        for v in range(m):
            a, b = _checked(w, v * c, n, wc, ws).real, w.imag
            s1 = C[:, :, v].real * a + s1
            s2 = C[:, :, v].imag * b + s2
            w = _times(w, step)
        st[:, :, c] = ((s1 + s2) * inv_nn).astype(F32)
        if (n - c) % n != c:
            st[:, :, n - c] = ((s1 - s2) * inv_nn).astype(F32)
    # the border's median by rank (ties by position), NaN with a NaN
    border = np.concatenate([st[:, 0, :], st[:, -1, :], st[:, :, 0],
                             st[:, :, -1]], 1)
    nb = 4 * n
    order = np.argsort(border, axis=1, kind='stable')
    lo = np.take_along_axis(border, order[:, (nb - 1) // 2:][:, :1], 1)[:, 0]
    hi = np.take_along_axis(border, order[:, nb // 2:][:, :1], 1)[:, 0]
    bkg = ((lo + hi) * F32(0.5)).astype(F32)
    bkg[np.isnan(border).any(1)] = np.nan
    st = (st - bkg[:, None, None]).astype(F32)
    total = _block_sum_f32(st.reshape(len(xs), -1), threads)
    pos = total > 0
    div = np.where(pos, total, F32(1))
    return (st / div[:, None, None]).astype(F32), valid & pos


def _field(H, W, n, seed):
    """Stars of 3e4 (sigma 1.8, noise 1) at n seeded positions, three at a
    border (their corners clamp), one near the corner (0, 0) where the
    four padding rows (valid False) cut."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(18, W - 18, n)
    ys = rng.uniform(18, H - 18, n)
    xs[:4], ys[:4] = (2.3, W - 1.7, 60.4, 11.8), (40.2, 90.6, 1.2, 12.3)
    img = render(H, W, xs, ys, np.full(n, 3e4), 1.8, rng, 1.0)
    xs = np.concatenate([xs, np.zeros(4)]).astype(F32)
    ys = np.concatenate([ys, np.zeros(4)]).astype(F32)
    return img, xs, ys, np.arange(n + 4) < n


def _plain(img, xs, ys, valid, n):
    st, good0 = tz.psf_stamps_plain(*(torch.as_tensor(a) for a in
                                      (img, xs, ys, valid)), n)
    return st.numpy(), good0.numpy()


@pytest.mark.parametrize('n', [1, 2, 15, 24, 25, 32])
def test_stamp_passes_are_the_plain_stamps(n):
    img, xs, ys, valid = _field(120, 131, 12, 31)
    got, gg = emulate_stamps(img, xs, ys, valid, n)
    want, wg = _plain(img, xs, ys, valid, n)
    assert got.shape == want.shape == (16, n, n)
    np.testing.assert_array_equal(gg, wg)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    if n > 2:
        assert wg[:12].all() and not wg[12:].any()
    # a NaN under the padding rows' cut spreads through their stamps only
    img = img.copy()
    img[min(n, 3) - 1, 0] = np.nan
    got, gg = emulate_stamps(img, xs, ys, valid, n)
    want, wg = _plain(img, xs, ys, valid, n)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(gg, wg)
    assert np.isnan(got[12:]).all() and not gg[12:].any()
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-7)


@pytest.mark.parametrize('threads', [128, 512])
def test_stamp_sum_order_at_other_widths(threads):
    img, xs, ys, valid = _field(96, 96, 6, 5)
    got, gg = emulate_stamps(img, xs, ys, valid, 25, threads)
    want, wg = _plain(img, xs, ys, valid, 25)
    np.testing.assert_array_equal(gg, wg)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize('scene', [psf_scene, hard_scene])
def test_stamp_passes_give_the_reference_psf(scene):
    img, xs, ys, valid = scene()
    want = np.asarray(jz.estimate_psf_from_stars(
        *(jnp.asarray(a) for a in (img, xs, ys, valid))))
    st, good0 = emulate_stamps(img, xs, ys, valid, 25)
    psf, _ = tz.psf_clip_plain(torch.as_tensor(st), torch.as_tensor(good0))
    np.testing.assert_allclose(psf.numpy(), want, rtol=0, atol=1e-7)


def test_ramp_table_is_the_reference_ramp_off_the_nyquist_modes():
    """At odd n the table is the reference's ramp (-k's frequency is
    exactly -fq[k]); at even n it differs on the Nyquist row and column,
    where fftfreq gives -1/2 for both k and -k, so the Hermitian part's
    ramp is not the ramp."""
    rng = np.random.default_rng(2)
    dx, dy = (rng.uniform(-0.5, 0.5, 5).astype(F32) for _ in range(2))
    for n in (15, 25, 24, 32):
        m = n // 2 + 1
        R = _ramp(n, dx, dy)
        fq = tz._fftfreq(n, torch.float32, 'cpu').numpy()
        th = (F32(2 * np.pi) * (fq[None, :, None] * dy[:, None, None]
                                + fq[None, None, :m] * dx[:, None, None]))
        E = np.exp(1j * th.astype(np.float64))
        off = np.ones((n, m), bool)
        if n % 2 == 0:
            off[n // 2, :] = off[:, n // 2] = False
            assert not np.allclose(R[:, ~off], E[:, ~off], atol=1e-3)
        np.testing.assert_allclose(R[:, off], E[:, off], rtol=0, atol=1e-6)


# ---- H16 ---------------------------------------------------------------------

def _block_sum_f64(vals):
    """block_sum_d over (..., threads) doubles: each warp's xor butterfly,
    then the warps in order from 0.0."""
    w = vals.reshape(vals.shape[:-1] + (-1, 32))
    for o in (16, 8, 4, 2, 1):
        w = w + w[..., np.arange(32) ^ o]
    s = np.zeros(vals.shape[:-1])
    for k in range(w.shape[-2]):
        s = s + w[..., k, 0]
    return s


def emulate_normalize(p_d, s, f_d, blocks, vec=True, threads=NORM_THREADS):
    """normalize_kernel in numpy at ``blocks`` blocks (V = 4 floats a chunk
    on the vector path, 1 off it)."""
    p = np.ascontiguousarray(p_d, F32).ravel()
    n, V = p.size, (4 if vec else 1)
    nv = n // V
    per = -(-nv // blocks)
    sq = (p * p).astype(F32).astype(np.float64)
    partials = np.zeros(blocks)
    for b in range(blocks):
        lo = min(b * per, nv)
        hi = min(lo + per, nv)
        chunks = sq[lo * V:hi * V].reshape(-1, V)
        rows = -(-len(chunks) // threads)
        pad = np.zeros((rows * threads, 4))
        pad[:len(chunks), :V] = chunks
        pad = pad.reshape(rows, threads, 4)
        acc = np.zeros((threads, 4))
        for k in range(rows):
            acc = acc + pad[k]
        if b == blocks - 1:
            for v in sq[nv * V:]:
                acc[0, 0] += v
        partials[b] = _block_sum_f64((acc[:, 0] + acc[:, 1])
                                     + (acc[:, 2] + acc[:, 3]))
    mine = np.zeros(threads)
    for i in range(blocks):
        mine[i % threads] += partials[i]
    total = F32(_block_sum_f64(mine))
    with np.errstate(invalid='ignore'):
        norm = F32(f_d) * np.sqrt(total if np.isnan(total)
                                  else max(total, F32(1e-20)), dtype=F32)
        return (np.asarray(s, F32) / F32(norm)).astype(F32)


def _plain_norm(p_d, s, f_d):
    return tz.score_normalize_plain(torch.as_tensor(p_d), torch.as_tensor(s),
                                    f_d).numpy()


@pytest.mark.parametrize('blocks', [1, 3, 7, 64, 528, 1056])
@pytest.mark.parametrize('shape', [(250, 197), (256, 256), (1001,), (5,),
                                   (3,)])
def test_normalize_slabs_are_the_plain_score(blocks, shape):
    rng = np.random.default_rng(sum(shape))
    p_d = (rng.normal(size=shape) * 1e-3).astype(F32)
    s = (rng.normal(size=shape) * 5).astype(F32)
    want = _plain_norm(p_d, s, 0.7)
    for vec in (True, False):
        got = emulate_normalize(p_d, s, 0.7, blocks, vec)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_normalize_zeros_clamp_and_a_nan_spreads():
    rng = np.random.default_rng(4)
    s = (rng.normal(size=(61, 33)) * 5).astype(F32)
    z = np.zeros_like(s)
    for blocks in (1, 9):
        np.testing.assert_array_equal(emulate_normalize(z, s, 0.7, blocks),
                                      _plain_norm(z, s, 0.7))
        p_d = (rng.normal(size=s.shape) * 1e-3).astype(F32)
        p_d[60, 32] = np.nan                    # in the tail past the chunks
        assert np.isnan(emulate_normalize(p_d, s, 0.7, blocks)).all()
        p_d[60, 32], p_d[1, 2] = 0.0, np.nan
        assert np.isnan(emulate_normalize(p_d, s, 0.7, blocks, False)).all()
        assert np.isnan(_plain_norm(p_d, s, 0.7)).all()


@pytest.mark.parametrize('name', list(SCENES))
def test_normalize_slabs_give_the_reference_score(name):
    sc = SCENES[name]()
    want = run_jax(sc)['s_corr']

    def emulated(p_d, s, f_d):
        return torch.as_tensor(emulate_normalize(p_d.numpy(), s.numpy(), f_d,
                                                 528))
    out = tz._zogy(*(torch.as_tensor(sc[k]) for k in ARGS[:4]),
                   sc['sigma_new'], sc['sigma_ref'], 1.0, 1.0,
                   tz.spectral_pass_plain, emulated)
    np.testing.assert_allclose(out['s_corr'].numpy(), want, rtol=0, atol=1e-3)
    plain = tz.zogy_subtract_plain(*(torch.as_tensor(sc[k]) for k in
                                     ARGS[:4]), sc['sigma_new'],
                                   sc['sigma_ref'])
    np.testing.assert_allclose(out['s_corr'].numpy(),
                               plain['s_corr'].numpy(), rtol=1e-6, atol=0)
