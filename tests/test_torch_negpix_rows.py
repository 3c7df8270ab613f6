"""H14's schedule (``zuds_tpu_torch/kernels/cutouts.cu``) emulated in numpy
f32 on the CPU, against ``ops.cutouts.negpix_veto_plain`` and the JAX
package's ``filterobjects._negpix_veto``.

The kernel changes two things that a CPU run can check:

* a row whose corner is bitwise the last row's takes the last row's
  verdict (written by block 0) instead of reading its window: emulated by
  :func:`veto_rows`, held bit-equal to every row decided on its own, on
  trailing padding, a repeat in the middle, a frame whose rows are all one
  corner and N = 1;
* a lane tests s < -5 at its inner pixel first and forms the 3x3 maximum
  only there, as the maximum of the nine raw values standardised once
  (:func:`window_veto`): held bit-equal to the parent kernel's form (the
  nine standardised values' NaN-carrying maximum at every inner pixel,
  :func:`parent_window_veto`) on NaN neighbours and centres, +-inf pixels,
  windows at each frame edge and infinite or NaN medians and sigmas.

numpy's f32 scalar and array arithmetic rounds each operation to nearest,
as the kernel's ``__fsub_rn`` and ``__fdiv_rn``.
"""
import numpy as np
import pytest
import torch

from zuds_tpu import filterobjects as jfilter
from zuds_tpu_torch import filterobjects as tfilter
from zuds_tpu_torch.ops import cutouts

BOX = cutouts.NEGPIX_BOX
INNER = cutouts.NEGPIX_INNER
F32 = np.float32


def _std(v, m, d):
    """fl(fl(v - m) / d) in f32."""
    with np.errstate(all='ignore'):
        return (np.asarray(v, F32) - F32(m)) / F32(d)


def _divisor(sig):
    """fmaxf(sig, 1e-12f): a NaN sig gives the floor."""
    return np.fmax(F32(sig), F32(1e-12))


def _neighbours(win):
    """(9, INNER, INNER): the 3x3 neighbourhoods of the inner pixels."""
    return np.stack([win[1 + dy:1 + dy + INNER, 1 + dx:1 + dx + INNER]
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1)])


def window_veto(win, m, d):
    """The new lane test: the centre's s < -5 first; where it holds, the
    NaN-carrying maximum of the nine raw values, standardised once, > 5."""
    low = _std(win[1:1 + INNER, 1:1 + INNER], m, d) < -5
    if not low.any():
        return False
    mx = _neighbours(win).max(0)               # a NaN among the nine wins
    return bool((low & (_std(mx, m, d) > 5)).any())


def parent_window_veto(win, m, d):
    """The parent kernel's test: every window value standardised, the
    NaN-carrying maximum of the nine standardised values at every inner
    pixel, any(s < -5 & max > 5)."""
    s = _std(win, m, d)
    mx = _neighbours(s).max(0)
    return bool(((s[1:1 + INNER, 1:1 + INNER] < -5) & (mx > 5)).any())


def veto_rows(img, med, sig, x0, y0, reads=None):
    """The kernel's rows: row N - 1 decided once and its verdict written to
    every row of its corner; every other row decided from its window.
    ``reads`` (a list) collects the rows whose window was read."""
    m, d = F32(med), _divisor(sig)
    n = len(x0)
    last = n - 1

    def decide(i):
        if reads is not None:
            reads.append(i)
        return window_veto(img[y0[i]:y0[i] + BOX, x0[i]:x0[i] + BOX], m, d)

    out = np.zeros(n, bool)
    v_last = decide(last)
    for i in range(n):
        same = x0[i] == x0[last] and y0[i] == y0[last]
        out[i] = v_last if same else decide(i)
    return out


def every_row(img, med, sig, x0, y0, form=parent_window_veto):
    m, d = F32(med), _divisor(sig)
    return np.array([form(img[y:y + BOX, x:x + BOX], m, d)
                     for x, y in zip(x0, y0)], bool)


def _plain(img, med, sig, x0, y0):
    return cutouts.negpix_veto_plain(
        torch.as_tensor(img), torch.tensor(F32(med)), torch.tensor(F32(sig)),
        torch.as_tensor(x0.astype('i4')),
        torch.as_tensor(y0.astype('i4'))).numpy()


def _frame(H, W, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(100.0, 5.0, (H, W)).astype(F32)


def _medsig(img):
    t = torch.as_tensor(img)
    med = cutouts.frame_median_exact(t)
    sig = 1.48 * cutouts.frame_median_exact((t - med).abs())
    return F32(med), F32(sig)


def _plant(img, x0, y0, every=3):
    """A -/+ pair at every ``every``-th window's centre, a lone low pixel
    at the next one and, for ``every`` > 2, a pair with a NaN beside its
    low pixel at the one after (at the first 40 rows)."""
    for i, (x, y) in enumerate(zip(x0, y0)):
        cy, cx = y + 6, x + 6
        if i % every == 0:
            img[cy, cx], img[cy + 1, cx - 1] = 40.0, 170.0
        elif i % every == 1:
            img[cy, cx] = 40.0
        elif i % every == 2 and i < 40:
            img[cy, cx], img[cy - 1, cx] = 40.0, np.nan
            img[cy + 1, cx + 1] = 170.0


def _corners(kind, H, W, n, seed):
    rng = np.random.default_rng(seed)
    flat = rng.choice((H - BOX + 1) * (W - BOX + 1), n, replace=False)
    y0, x0 = np.divmod(flat, W - BOX + 1)
    if kind == 'trailing':                 # the slice's fill rows
        x0[n // 3:], y0[n // 3:] = x0[-1], y0[-1]
    elif kind == 'middle':                 # a repeat that is not the last's
        x0[5:9], y0[5:9] = x0[4], y0[4]
        x0[10], y0[10] = x0[-1], y0[-1]
    elif kind == 'one':
        x0[:], y0[:] = x0[0], y0[0]
    return x0.astype(np.int64), y0.astype(np.int64)


@pytest.mark.parametrize('kind,n', [('trailing', 300), ('middle', 60),
                                    ('one', 200), ('distinct', 150),
                                    ('distinct', 1), ('one', 1)])
@pytest.mark.parametrize('last_hit', [False, True])
def test_repeated_corner_rule_bit_equal(kind, n, last_hit):
    H, W = 160, 150
    x0, y0 = _corners(kind, H, W, n, 40 + n)
    img = _frame(H, W, 41)
    _plant(img, x0, y0)
    if last_hit:
        img[y0[-1] + 3, x0[-1] + 3] = 40.0
        img[y0[-1] + 2, x0[-1] + 4] = 170.0
    med, sig = _medsig(img)
    reads = []
    got = veto_rows(img, med, sig, x0, y0, reads)
    want = _plain(img, med, sig, x0, y0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, every_row(img, med, sig, x0, y0))
    assert got[-1] or not last_hit
    same = (x0 == x0[-1]) & (y0 == y0[-1])
    # one read for the last corner's rows, one a row for the others
    assert len(reads) == 1 + int((~same).sum())
    if kind == 'trailing':
        assert 0 < got.sum() < n and len(reads) == n // 3 + 1


def _special_windows():
    """13x13 windows of noise about 0 (sigma ~1) with the cases the
    threshold-first form must decide as the parent form does."""
    rng = np.random.default_rng(7)
    base = rng.normal(0.0, 1.0, (BOX, BOX)).astype(F32)
    nan, inf = F32(np.nan), F32(np.inf)
    cases = {}

    def case(name, *sets):
        w = base.copy()
        for (r, c), v in sets:
            w[r, c] = v
        cases[name] = w
    case('pair', ((6, 6), -9.0), ((7, 5), 9.0))
    case('pair_at_the_rim', ((1, 1), -9.0), ((0, 0), 9.0))
    case('pair_far_corner', ((11, 11), -9.0), ((12, 12), 9.0))
    case('nan_neighbour', ((6, 6), -9.0), ((7, 5), 9.0), ((5, 6), nan))
    case('nan_centre', ((6, 6), nan), ((7, 5), 9.0))
    case('nan_outside_the_reach', ((6, 6), -9.0), ((7, 5), 9.0),
         ((6, 9), nan))
    case('inf_neighbour', ((6, 6), -9.0), ((7, 7), inf))
    case('minus_inf_centre', ((6, 6), -inf), ((5, 5), 9.0))
    case('minus_inf_neighbour', ((6, 6), -9.0), ((5, 5), -inf))
    case('lone_low', ((6, 6), -9.0))
    case('low_at_minus_5', ((6, 6), -5.0), ((6, 7), 9.0))
    case('high_at_5', ((6, 6), -9.0), ((6, 7), 5.0))
    case('high_just_over_5', ((6, 6), -9.0),
         ((6, 7), np.nextafter(F32(5), F32(6))))
    case('all_nan', *[((r, c), nan) for r in range(BOX) for c in range(BOX)])
    case('rim_only_pair', ((0, 6), -9.0), ((0, 7), 9.0))
    return cases


@pytest.mark.parametrize('med,sig', [
    (0.0, 1.0), (0.25, 0.5), (0.0, 1e-13), (0.0, 0.0), (np.inf, 1.0),
    (-np.inf, 1.0), (np.nan, 1.0), (0.0, np.inf), (0.0, np.nan),
    (3.0, 1.2), (-3.0, 1.2)])
def test_threshold_first_form_equals_the_parent_form(med, sig):
    d = _divisor(sig)
    for name, w in _special_windows().items():
        assert window_veto(w, med, d) == parent_window_veto(w, med, d), name


def test_threshold_first_form_decides_the_special_windows():
    want = {'pair': True, 'pair_at_the_rim': True, 'pair_far_corner': True,
            'nan_neighbour': False, 'nan_centre': False,
            'nan_outside_the_reach': True, 'inf_neighbour': True,
            'minus_inf_centre': True, 'minus_inf_neighbour': False,
            'lone_low': False, 'low_at_minus_5': False, 'high_at_5': False,
            'high_just_over_5': True, 'all_nan': False,
            'rim_only_pair': False}
    for name, w in _special_windows().items():
        assert window_veto(w, F32(0), _divisor(1.0)) == want[name], name


@pytest.mark.parametrize('seed', range(3))
def test_threshold_first_form_on_noise_with_planted_pairs(seed):
    """Seeded 13x13 windows: noise with pairs, NaN and +-inf sprinkled at
    a few pixels each: the two forms agree at every window."""
    rng = np.random.default_rng(100 + seed)
    w = rng.normal(0.0, 2.0, (400, BOX, BOX)).astype(F32)
    for k in range(400):
        for _ in range(rng.integers(0, 4)):
            r, c = rng.integers(0, BOX, 2)
            w[k, r, c] = rng.choice([-12.0, 12.0, np.nan, np.inf, -np.inf,
                                     -5.0, 5.0])
    for med, sig in ((0.0, 1.0), (0.5, 0.9), (np.inf, 1.0), (0.0, np.inf)):
        d = _divisor(sig)
        got = [window_veto(x, med, d) for x in w]
        assert got == [parent_window_veto(x, med, d) for x in w]
    assert 0 < sum(got) < 400 or sig == np.inf


def test_windows_at_each_frame_edge_bit_equal():
    """Corners clamped at all four edges and the four frame corners, pairs
    planted at the rim of the clamped windows: the emulated rows against
    the plain version."""
    H, W = 90, 80
    img = _frame(H, W, 12)
    x0 = np.array([0, W - BOX, 30, 30, 0, W - BOX, 0, W - BOX, 20])
    y0 = np.array([40, 40, 0, H - BOX, 0, 0, H - BOX, H - BOX, 20])
    for x, y in zip(x0, y0):
        img[y + 1, x + 1], img[y, x] = 40.0, 170.0        # pair at the rim
    img[y0[2] + 11, x0[2] + 11], img[y0[2] + 12, x0[2] + 12] = 40.0, 170.0
    med, sig = _medsig(img)
    got = veto_rows(img, med, sig, x0, y0)
    np.testing.assert_array_equal(got, _plain(img, med, sig, x0, y0))
    assert got.all()


@pytest.mark.parametrize('nan', [False, True])
@pytest.mark.parametrize('fill', ['last_row', 'none'])
def test_rows_against_the_jax_veto(fill, nan):
    """The JAX package's ``_negpix_veto`` on positions with edges and,
    where asked, the slice's trailing fill (rows past a third at the last
    row's position), against the emulated rows at the port's medians and
    clamped corners, and the port's ``_negpix_veto`` on the CPU. A frame
    that holds a NaN has a NaN median in both (jnp.median): nothing is
    vetoed."""
    H, W = 120, 110
    rng = np.random.default_rng(23)
    n = 90
    xs = rng.uniform(-3, W + 2, n).astype(F32)
    ys = rng.uniform(-3, H + 2, n).astype(F32)
    xs[::7], ys[1::7] = 0.4, H - 0.7
    if fill == 'last_row':
        xs[n // 3:], ys[n // 3:] = xs[-1], ys[-1]
    img = _frame(H, W, 24)
    x0t, y0t = cutouts.clamped_corners(torch.as_tensor(xs),
                                       torch.as_tensor(ys), BOX, H, W)
    x0, y0 = x0t.numpy().astype(np.int64), y0t.numpy().astype(np.int64)
    _plant(img, x0, y0, every=2)
    if nan:
        img[H // 2, W // 3] = np.nan
    med, sig = _medsig(img)
    if nan:
        med = sig = F32(np.nan)
    want = jfilter._negpix_veto(img, xs, ys)
    got = veto_rows(img, med, sig, x0, y0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tfilter._negpix_veto(img, xs, ys, device='cpu'), want)
    assert (0 < got.sum() < n) != nan
