"""The bisection median settled several rounds a pass, as the hand kernels
H8 (``zuds_tpu_torch/kernels/median.cu``) and H2 (``kernels/background.cu``)
compute it, emulated in numpy float32 on the CPU, against the port's plain
``frame_median_plain`` / ``bisect_median`` and the JAX package's
``bisect_median``: bit-equal, NaN where they are NaN.

``bisect_median`` starts at the min and max of the valid values and
``half = count * 0.5``; each of 12 rounds counts the valid values <= mid =
0.5 * (lo + hi) (f32) and goes up when ``(float)count < half``. The mids of
the next L rounds all follow from the pass's (lo, hi): node j of the
pass's tree (in order) holds the mid the plain version forms if its
descent reaches j. H8 puts each value in one of 2^L buckets by a binary
search over those mids (``!(v <= t)`` goes up) and takes the count at
node j as the buckets summed up to j, which holds because the mids, read
in order, never decrease (or are all NaN; tested below on adversarial
(lo, hi), overflow and infinities included). H2 counts each mid directly.
Both then replay the L rounds from the counts. L is read from the kernels'
sources (``ZUDS_MEDIAN_L``, ``ZUDS_BG_L``), so the emulation follows any
change there; the other values each kernel admits (1-6 for H8, 1-4 for
H2) are tested too.
"""
import re
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zuds_tpu.ops import background as jbg
from zuds_tpu_torch.ops import background as tbg

F = np.float32
KERNELS = Path(tbg.__file__).resolve().parents[1] / 'kernels'


def _source_l(name, macro):
    m = re.search(rf'#define {macro} (\d+)', (KERNELS / name).read_text())
    assert m, (name, macro)
    return int(m.group(1))


L_H8 = _source_l('median.cu', 'ZUDS_MEDIAN_L')
L_H2 = _source_l('background.cu', 'ZUDS_BG_L')


@pytest.fixture(autouse=True)
def _quiet():
    # f32 overflow to inf and inf - inf = NaN are what the tests exercise
    with np.errstate(over='ignore', invalid='ignore'):
        yield


def mid(lo, hi):
    return F(F(0.5) * F(F(lo) + F(hi)))


def mid_at(lo, hi, j, L):
    """median.cu's mid_at: the mids along the descent to in-order node j."""
    node, d = (1 << (L - 1)) - 1, L - 2
    while True:
        m = mid(lo, hi)
        if j == node or d < 0:
            return m
        if j < node:
            hi, node = m, node - (1 << d)
        else:
            lo, node = m, node + (1 << d)
        d -= 1


def pass_mids(lo, hi, L):
    """background.cu's pass_mids: level by level, node j at depth d
    between its nearest ancestors j -+ 2^(L-1-d)."""
    n = (1 << L) - 1
    t = np.zeros(n, F)
    for d in range(L):
        h = 1 << (L - 1 - d)
        for j in range(h - 1, n, 2 * h):
            t[j] = mid(lo if j - h < 0 else t[j - h],
                       hi if j + h >= n else t[j + h])
    return t


def replay(lo, hi, half, le, L):
    node = (1 << (L - 1)) - 1
    for d in range(L - 2, -2, -1):
        m = mid(lo, hi)
        up = F(le[node]) < half
        lo, hi = (m, hi) if up else (lo, m)
        if d >= 0:
            node += (1 << d) if up else -(1 << d)
    return lo, hi


def buckets(v, t, L):
    """H8's binary search: the bucket of each value among the in-order
    mids t (2^L - 1 of them)."""
    b = np.zeros(v.shape, np.int64)
    h = 1 << (L - 1)
    while h:
        b += h * ~(v <= t[b + h - 1])
        h >>= 1
    return b


def h8_median(x, ok, L, iters=12):
    """H8: minmax (NaN propagating), then passes of up to L rounds, each
    counted by buckets."""
    v = np.asarray(x, F).ravel()[np.asarray(ok).ravel()]
    lo = v.min() if v.size else F(np.inf)
    hi = v.max() if v.size else F(-np.inf)
    half = F(F(v.size) * F(0.5))
    left = iters
    while left:
        Lp = min(L, left)
        left -= Lp
        t = np.array([mid_at(lo, hi, j, Lp) for j in range((1 << Lp) - 1)],
                     F)
        le = np.cumsum(np.bincount(buckets(v, t, Lp), minlength=1 << Lp))
        lo, hi = replay(lo, hi, half, le, Lp)
    return mid(lo, hi)


def h2_median(x, keep, L, iters=12):
    """H2: min / max and count of the kept values, then iters / L passes,
    each mid counted directly."""
    v = np.asarray(x, F)[np.asarray(keep)]
    lo = v.min() if v.size else F(np.inf)
    hi = v.max() if v.size else F(-np.inf)
    half = F(F(v.size) * F(0.5))
    for _ in range(iters // L):
        t = pass_mids(lo, hi, L)
        le = np.array([(v <= tj).sum() for tj in t])
        lo, hi = replay(lo, hi, half, le, L)
    return mid(lo, hi)


def torch_median(x, ok):
    return F(tbg.frame_median_plain(torch.from_numpy(x),
                                    torch.from_numpy(ok)))


def jax_median(x, ok):
    return F(np.asarray(jbg.bisect_median(
        jnp.asarray(x.reshape(1, -1)), jnp.asarray(ok.reshape(1, -1))))[0])


def same(a, b):
    return (np.isnan(a) and np.isnan(b)) or a == b


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == 'on_mids':
        # integers in [0, 4096], both ends present: the first 12 mids of
        # every descent are integers that the data holds
        x = rng.integers(0, 4097, (96, 80)).astype(F)
        x[0, 0], x[0, 1] = 0, 4096
        return x, rng.random(x.shape) > 0.1
    if name == 'on_mids_crowded':
        x = np.where(rng.random((64, 64)) < 0.7, F(2048),
                     rng.integers(0, 4097, (64, 64))).astype(F)
        x[0, 0], x[0, 1] = 0, 4096
        return x, np.ones(x.shape, bool)
    if name == 'nan':
        x = rng.normal(150, 5, (40, 50)).astype(F)
        x[3, 4] = np.nan
        return x, np.ones(x.shape, bool)
    if name == 'nan_masked':
        x = rng.normal(150, 5, (40, 50)).astype(F)
        x[3, 4] = np.nan
        ok = np.ones(x.shape, bool)
        ok[3, 4] = False
        return x, ok
    if name in ('pos_inf', 'neg_inf', 'both_inf'):
        x = rng.normal(150, 5, (40, 50)).astype(F)
        if name != 'neg_inf':
            x[1, 2] = np.inf
        if name != 'pos_inf':
            x[5, 6] = -np.inf
        return x, np.ones(x.shape, bool)
    if name == 'many_neg_inf':
        x = rng.normal(150, 5, (40, 50)).astype(F)
        x[:25] = -np.inf
        return x, np.ones(x.shape, bool)
    if name == 'all_masked':
        return rng.normal(0, 1, (30, 31)).astype(F), np.zeros((30, 31), bool)
    if name == 'one_valid':
        ok = np.zeros((30, 31), bool)
        ok[7, 9] = True
        return rng.normal(0, 1, (30, 31)).astype(F), ok
    if name == 'overflow':
        # lo + hi overflows to inf in f32 on the upper spine
        x = rng.uniform(1e38, 3.3e38, (20, 30)).astype(F)
        return x, np.ones(x.shape, bool)
    if name == 'overflow_neg':
        x = -rng.uniform(1e38, 3.3e38, (20, 30)).astype(F)
        return x, np.ones(x.shape, bool)
    if name == 'span':
        x = rng.uniform(-3.3e38, 3.3e38, (20, 30)).astype(F)
        return x, np.ones(x.shape, bool)
    if name == 'subnormal':
        x = (rng.integers(0, 64, (20, 30)) * F(1e-45)).astype(F)
        return x, np.ones(x.shape, bool)
    if name == 'view_770x768':
        # the size of the pipeline's ::4 views of a quadrant, stars and a
        # masked band
        x = rng.normal(150, 5, (770, 768)).astype(F)
        x[::25, ::23] += 4e4
        ok = rng.random((770, 768)) > 0.01
        ok[250:266] = False
        return x, ok
    raise KeyError(name)


CASES = ['on_mids', 'on_mids_crowded', 'nan', 'nan_masked', 'pos_inf',
         'neg_inf', 'both_inf', 'many_neg_inf', 'all_masked', 'one_valid',
         'overflow', 'overflow_neg', 'span', 'subnormal', 'view_770x768']


@pytest.mark.parametrize('name', CASES)
def test_h8_passes_equal_plain(name):
    """H8's passes at the source's L and at every L it admits against the
    port's plain version; H2's counting at its L and the others too, where
    the valid values are finite (H2's cells drop the rest when they
    load)."""
    x, ok = _case(name)
    want = torch_median(x, ok)
    for L in sorted({L_H8, 1, 2, 3, 4, 5, 6}):
        assert same(h8_median(x, ok, L), want), (name, L)
    if np.isfinite(x[ok]).all():
        for L in sorted({L_H2, 1, 2, 3, 4}):
            assert same(h2_median(x.ravel(), ok.ravel(), L), want), (name, L)


@pytest.mark.parametrize('name', ['on_mids', 'nan', 'both_inf', 'all_masked',
                                  'one_valid', 'overflow', 'view_770x768'])
def test_h8_passes_equal_jax(name):
    x, ok = _case(name)
    assert same(h8_median(x, ok, L_H8), jax_median(x, ok)), name


def test_cell_subsample_clipped():
    """H2's form on a cell: the stride-5 subsample of a 128x128 cell with a
    star and masked pixels, clipped three times about its median, then the
    full-resolution keep; each median as the port's and the JAX package's
    bisect_median."""
    rng = np.random.default_rng(3)
    cell = rng.normal(150, 5, (128, 128)).astype(F)
    yy, xx = np.mgrid[:128, :128]
    cell += (3e4 * np.exp(-((yy - 40) ** 2 + (xx - 70) ** 2) / 8)).astype(F)
    cell = cell.ravel()
    valid = rng.random(cell.size) > 0.05
    sub, vsub = cell[::5], valid[::5]
    keep = vsub
    for _ in range(4):
        want = F(tbg.bisect_median(torch.from_numpy(sub)[None],
                                   torch.from_numpy(keep)[None])[0])
        assert same(h2_median(sub, keep, L_H2), want)
        assert same(h8_median(sub, keep, L_H8), want)
        assert same(jax_median(sub, keep), want)
        sig = F(np.std(sub[keep]))
        lo, hi = F(want - F(3) * sig), F(want + F(3) * sig)
        keep = vsub & (sub >= lo) & (sub <= hi)
    full = valid & (cell >= lo) & (cell <= hi)
    want = F(tbg.bisect_median(torch.from_numpy(cell)[None],
                               torch.from_numpy(full)[None])[0])
    assert same(h2_median(cell, full, L_H2), want)
    assert same(jax_median(cell, full), want)


def _special_floats(rng, n):
    """Float32 values that stress the mids: random bit patterns (every
    exponent, NaN and inf among them), the largest finite values, zeros
    and subnormals."""
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    pool = np.concatenate([bits.view(F), np.array(
        [0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38, 1.7e38, -1.7e38, np.inf,
         -np.inf, np.nan, 1.0, -1.0], F)])
    return pool


def _pass_starts(rng, pool, L):
    """(lo, hi) pairs a pass can start from: the min and max of random
    values (lo <= hi, or NaN, or the empty set's (inf, -inf)), walked down
    random descents of 12 rounds and taken at each pass's start, and the
    states an overflowing round leaves, (inf, x) and (x, -inf)."""
    lows, highs = rng.choice(pool, 120), rng.choice(pool, 120)
    starts = list(zip(np.minimum(lows, highs), np.maximum(lows, highs)))
    starts += [(F(np.inf), F(-np.inf))]
    starts += [(F(np.inf), v) for v in rng.choice(pool, 20)]
    starts += [(v, F(-np.inf)) for v in rng.choice(pool, 20)]
    for lo, hi in starts:
        lo, hi = F(lo), F(hi)
        for seq in range(2):
            ups = rng.random(12) < 0.5
            for r in range(12):
                if r % L == 0:
                    yield lo, hi
                m = mid(lo, hi)
                lo, hi = (m, hi) if ups[r] else (lo, m)


@pytest.mark.parametrize('L', [1, 2, 3, 4, 5, 6])
def test_pass_mids_sorted_or_all_nan(L):
    """For every (lo, hi) a pass can start from, the in-order mids never
    decrease or are all NaN, both kernels form the same mids, and H8's
    bucket sums equal the direct counts at every node, on values that
    include NaN, the infinities and values on the mids."""
    rng = np.random.default_rng(L)
    pool = _special_floats(rng, 200)
    for i, (lo, hi) in enumerate(_pass_starts(rng, pool, L)):
        t = pass_mids(lo, hi, L)
        if i % 8 == 0:
            assert np.array_equal(t, np.array(
                [mid_at(lo, hi, j, L) for j in range((1 << L) - 1)], F),
                equal_nan=True), (lo, hi)
        nan = np.isnan(t)
        assert nan.all() or (not nan.any() and np.all(t[1:] >= t[:-1])), \
            (lo, hi, t)
        v = np.concatenate([rng.choice(pool, 32), t,
                            np.array([lo, hi, np.nan], F)])
        le = np.cumsum(np.bincount(buckets(v, t, L), minlength=1 << L))
        direct = np.array([(v <= tj).sum() for tj in t])
        assert np.array_equal(le[:-1], direct), (lo, hi)
