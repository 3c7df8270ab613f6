"""H18's clip passes (``zuds_tpu_torch/kernels/zogy.cu``, ``psf_clip_kernel``)
emulated in numpy f32 on the CPU, against ``ops.zogy.psf_clip_plain`` and
the JAX package's ``estimate_psf_from_stars``.

The kernel decides each stamp's 5 sigma test as a vote over its pixels
(a stamp fails where any quotient |s - mean| / den is >= 5 or NaN: the
lanes' 32-stamp masks ORed across the warp) in place of the maximum of the
quotients, and decides each quotient without a division where it can: q =
fl(a fl(1 / den)) against 5 (1 -+ 2^-20) (thresholds read from the
source), ``__fdiv_rn`` only in between or for a NaN. Both are held exact
here: :func:`below5` against fl(a / b) < 5 on
quotients at 5's neighbouring floats, NaN and +-inf; the passes in the
vote form against the maximum form and the plain version (``good`` equal,
the PSF bit-equal between the forms and within 1e-7 of the plain
version) on stamps with NaN stamps, +-inf pixels and outliers about 5
sigma; and on the PSF scenes of ``tests/test_torch_zogy.py`` against the
JAX package's PSF (1e-7). numpy's f32 arithmetic rounds each operation to
nearest, as the kernel's ``__fadd_rn``, ``__fmul_rn``, ``__fdiv_rn``,
``__frcp_rn`` and ``__fsqrt_rn``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zuds_tpu.ops import zogy as jz
from zuds_tpu_torch.ops import zogy as tz
from test_torch_zogy import hard_scene, psf_scene

F32 = np.float32
_SRC = (Path(tz.__file__).resolve().parents[1] / 'kernels'
        / 'zogy.cu').read_text()


def _threshold(name):
    return F32(float.fromhex(re.search(
        rf'constexpr float {name} = (0x[0-9a-fp.+-]+)f;', _SRC).group(1)))


BELOW, ABOVE = _threshold('kBelow5'), _threshold('kAbove5')


def below5(a, b):
    """The kernel's quotient test: (fl(a / b) < 5, where the division was
    asked: the band between the thresholds and NaN)."""
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    with np.errstate(all='ignore'):
        q = a * (F32(1) / b)
        exact = (a / b) < 5
    fast_pass, fast_fail = q < BELOW, q > ABOVE
    return (np.where(fast_pass, True, np.where(fast_fail, False, exact)),
            ~(fast_pass | fast_fail))


def test_thresholds_bracket_five():
    assert BELOW == F32(5 - 5 * 2.0 ** -20)
    assert ABOVE == F32(5 + 5 * 2.0 ** -20)


def _near_five(b, k=80):
    """For each b, the floats a within k ulps of fl(5 b), and of the
    float below and above 5 b / (1 -+ 2^-21)."""
    out = []
    for t in (F32(5) * b, F32(5 - 2.0 ** -21) * b, F32(5 + 2.0 ** -21) * b):
        a = t.copy()
        for _ in range(k):
            a = np.nextafter(a, F32(np.inf))
            out.append(a.copy())
        a = t.copy()
        for _ in range(k):
            a = np.nextafter(a, F32(0))
            out.append(a.copy())
        out.append(t)
    return np.stack(out)


def test_fast_quotient_test_is_exact():
    """Quotients within ~80 ulps of 5 (where the fallback decides), random
    quotients over many decades (where it is never asked), and NaN, +-inf,
    0 and subnormal values."""
    rng = np.random.default_rng(3)
    b = (10.0 ** rng.uniform(-10, 10, 2000)).astype(F32)
    b = np.concatenate([b, np.array([1e-10, 1e-12 + 1e-20, 1.0, 0.2,
                                     3e19], F32)])
    a_near = _near_five(b)
    b_near = np.broadcast_to(b, a_near.shape)
    got, asked = below5(a_near, b_near)
    with np.errstate(all='ignore'):
        np.testing.assert_array_equal(got, (a_near / b_near) < 5)
    assert asked.any() and not asked.all()
    a = (b * rng.uniform(0, 20, b.size)).astype(F32)
    got, asked = below5(a, b)
    np.testing.assert_array_equal(got, (a / b) < 5)
    assert asked.mean() < 1e-3
    special = np.array([np.nan, np.inf, 0.0, 1e-45, 3e38, 5.0, 4.9999995],
                       F32)
    for bb in np.array([1.0, 1e-12, np.inf, np.nan, 1e-10, 2e19], F32):
        got, _ = below5(special, np.full_like(special, bb))
        with np.errstate(all='ignore'):
            np.testing.assert_array_equal(got, (special / bb) < 5)


def clip_passes(stamps, good0, iters, form):
    """The kernel's passes: per pixel the good stamps' mean and variance
    summed in stamp order, each stamp kept while ``form`` passes it
    ('vote': every pixel's quotient by :func:`below5`; 'max': the
    NaN-carrying maximum of the quotients < 5); the final mean clamped at
    0 over its sum. Returns (psf, good, divisions asked)."""
    S = stamps.shape[0]
    x = np.asarray(stamps, F32).reshape(S, -1)
    good = np.asarray(good0, bool).copy()
    asked = 0
    with np.errstate(all='ignore'):
        for p in range(iters + 1):
            g = good.astype(F32)
            nf = F32(max(int(good.sum()), 1))
            mean = np.zeros(x.shape[1], F32)
            for s in range(S):
                mean = mean + x[s] * g[s]
            mean = mean / nf
            if p == iters:
                break
            var = np.zeros(x.shape[1], F32)
            for s in range(S):
                d = x[s] - mean
                var = var + (d * d) * g[s]
            var = var / nf
            den = np.sqrt(np.maximum(var, F32(1e-20))) + F32(1e-12)
            a = np.abs(x - mean)
            if form == 'vote':
                ok, asks = below5(a, np.broadcast_to(den, a.shape))
                ok = ok.all(1)
                asked += int(asks.sum())
            else:
                ok = (a / den).max(1) < 5
            good = np.asarray(good0, bool) & ok
        v = np.where(np.isnan(mean), mean, np.maximum(mean, F32(0)))
        tot = v.sum(dtype=F32)
        psf = v / np.maximum(tot, F32(1e-20))
    return psf.reshape(stamps.shape[1:]), good, asked


def _stack(S, seed, case):
    """S stamps of a Gaussian PSF, noise, an outlier of 3-12 times the
    noise at a pixel of its own in every 5th stamp (some past 5 sigma,
    some not), the last fifth not good."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[-12:13, -12:13]
    g = np.exp(-(xx ** 2 + yy ** 2) / (2 * 1.8 ** 2))
    st = (g / g.sum() + rng.normal(0, 2e-4, (S, 25, 25))).astype(F32)
    for k in range(0, S, 5):
        st[k, (k // 5) % 25, (3 * k) % 25] += F32(rng.uniform(3, 12) * 2e-4)
    good0 = np.arange(S) < S - S // 5
    if case == 'nan_stamp':
        st[S - 1] = np.nan
    elif case == 'nan_pixel_good':
        st[0, 4, 4] = np.nan
    elif case == 'inf_pixel':
        st[S // 2, 3, 4] = np.inf
    elif case == 'minus_inf_dropped':
        st[S - 1, 7, 7] = -np.inf
    return st, good0


@pytest.mark.parametrize('case', ['clean', 'nan_stamp', 'nan_pixel_good',
                                  'inf_pixel', 'minus_inf_dropped'])
@pytest.mark.parametrize('S,iters', [(1, 2), (64, 0), (64, 1), (64, 2),
                                     (65, 3), (300, 2)])
def test_vote_form_equals_the_max_form_and_the_plain_version(S, iters, case):
    st, good0 = _stack(S, 10 + S + iters, case)
    psf_v, good_v, _ = clip_passes(st, good0, iters, 'vote')
    psf_m, good_m, _ = clip_passes(st, good0, iters, 'max')
    np.testing.assert_array_equal(good_v, good_m)
    np.testing.assert_array_equal(psf_v, psf_m)
    pp, pg = tz.psf_clip_plain(torch.as_tensor(st), torch.as_tensor(good0),
                               iters)
    np.testing.assert_array_equal(good_v, pg.numpy())
    np.testing.assert_array_equal(np.isnan(psf_v), pp.isnan().numpy())
    fin = ~np.isnan(psf_v)
    np.testing.assert_allclose(psf_v[fin], pp.numpy()[fin], rtol=0,
                               atol=1e-7)
    if case == 'clean' and S >= 64 and iters:
        assert 0 < good_v.sum() < good0.sum()   # the clip drops outliers


def test_quotients_near_five_decided_by_the_division():
    """Stamps whose outlier puts a quotient within a few ulps of 5 (found
    by bisection of the outlier's size): the vote form asks the division
    there and agrees with the maximum form on which side it falls."""
    rng = np.random.default_rng(44)
    st0 = rng.normal(0, 1.0, (40, 3, 3)).astype(F32)
    good0 = np.ones(40, bool)

    def quotient(h):
        st = st0.copy()
        st[0, 1, 1] = h
        x = st.reshape(40, -1)
        mean = np.zeros(9, F32)
        for s in range(40):
            mean = mean + x[s]
        mean = mean / F32(40)
        var = np.zeros(9, F32)
        for s in range(40):
            d = x[s] - mean
            var = var + d * d
        var = var / F32(40)
        den = np.sqrt(np.maximum(var, F32(1e-20))) + F32(1e-12)
        return st, F32(abs(x[0, 4] - mean[4]) / den[4])

    lo, hi = F32(1.0), F32(100.0)
    for _ in range(60):                       # quotient(lo) < 5 <= q(hi)
        mid = F32((lo + hi) / 2)
        if quotient(mid)[1] < 5:
            lo = mid
        else:
            hi = mid
    asked_any = 0
    for h in (lo, hi, np.nextafter(lo, F32(0)), np.nextafter(hi, F32(200))):
        st, _ = quotient(h)
        _, gv, asked = clip_passes(st, good0, 1, 'vote')
        _, gm, _ = clip_passes(st, good0, 1, 'max')
        np.testing.assert_array_equal(gv, gm)
        asked_any += asked
    assert asked_any > 0


@pytest.mark.parametrize('scene', ['psf', 'hard'])
def test_passes_against_the_jax_psf(scene):
    """The emulated passes on the port's stamps of the PSF scenes: the PSF
    within 1e-7 of the JAX package's ``estimate_psf_from_stars`` (the
    stamps agree to the transforms' last rounding), ``good`` equal to the
    plain version's."""
    img, xs, ys, valid = psf_scene() if scene == 'psf' else hard_scene()
    want = np.asarray(jz.estimate_psf_from_stars(
        *(jnp.asarray(a) for a in (img, xs, ys, valid))))
    t = [torch.as_tensor(a) for a in (img, xs, ys, valid)]
    stamps, good0 = tz.psf_stamps_plain(*t)
    psf, good, _ = clip_passes(stamps.numpy(), good0.numpy(), 2, 'vote')
    np.testing.assert_allclose(psf, want, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        good, tz.psf_clip_plain(stamps, good0, 2)[1].numpy())
    if scene == 'hard':
        assert not good[0] and good.sum() >= 15
