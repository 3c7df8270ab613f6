"""H9's selection (``zuds_tpu_torch/kernels/coadd.cu``), emulated in numpy
on the CPU exactly as the kernel does it: each value's order-preserving
uint32 key, the bucket's padding (N to a multiple of 8), Batcher's
odd-even merge sort network pruned to the bucket, comparator by
comparator, and the select tree that picks the two middle keys by the
bits of their index. The network's sizes and the two special
keys are read out of ``coadd.cu``, so the emulation follows any change
there.

Held against ``torch.sort``'s order statistics at ``lo = (cnt - 1) / 2``
and ``hi = cnt / 2`` for N = 1..64, on stacks with ties, +-0, +-inf, NaN
(either sign) at weight > 0, epochs without weight, all-invalid pixels
and the padding past N: bit-equal (NaN for NaN) but for the sign of a zero
statistic, which ``torch.sort`` leaves to its order of ties; that sign
cannot reach an output, since the median enters the combine only through
``|x - med|``, ``|fma(x, s, -med)|`` and ``|med|`` (checked bit-equal).

The whole per-pixel combine emulated around the selection (the kernel's
roundings, the exact threshold at every epoch: the kernel's first test
against ``rsqrtf`` decides only where it cannot differ; ``fmaf`` as the
float64 product and sum rounded once, as ``ops.ordered.fma``) is held
bit-equal to the plain version
``ops.coadd.clipped_combine_plain`` on the CPU, with and without FLXSCALE,
and to the reference's ``zuds_tpu.ops.coadd.clipped_coadd`` (its median
through its clip): ``nexp`` and ``nclip`` equal, the sums rtol 2e-6 (the
reference adds in its own order at some depths, and from +0). The
reference's stacks use weights of 1/16, whose sigma is exactly 4 in both
packages (XLA:CPU's approximate ``rsqrt`` is otherwise one ulp off).
"""
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu.ops import coadd as jops
from zuds_tpu_torch.constants import MASK_BIT_NODATA_ALIGN
from zuds_tpu_torch.ops import coadd as tops

COADD_CU = (Path(tops.__file__).resolve().parents[1] / 'kernels'
            / 'coadd.cu').read_text()
BUCKETS = tuple(range(8, 65, 8))
F4 = np.float32
U4 = np.uint32


def _cu_int(pattern):
    m = re.search(pattern, COADD_CU)
    assert m, pattern
    return m.group(1)


NET_SIZES = tuple(int(v) for v in _cu_int(
    r'constexpr int kNetComparators\[\] = \{([0-9, ]+)\};').split(','))
NAN_KEY = U4(int(_cu_int(r'constexpr uint32_t kNanKey = (0x[0-9A-Fa-f]+)u;'),
                 16))
PAD_KEY = U4(int(_cu_int(r'constexpr uint32_t kPadKey = (0x[0-9A-Fa-f]+)u;'),
                 16))
SEQUENTIAL = int(_cu_int(r'constexpr int kSequential = (\d+);'))


def batcher(n, keep=None):
    """Batcher's odd-even merge sort of n = 2^m keys: the comparators in
    the kernel's order (``batcher`` in coadd.cu), those that touch only the
    first ``keep`` keys."""
    keep = n if keep is None else keep
    out = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            j = k % p
            while j <= n - 1 - k:
                for i in range(min(k - 1, n - j - k - 1) + 1):
                    if ((i + j) // (2 * p) == (i + j + k) // (2 * p)
                            and i + j + k < keep):
                        out.append((i + j, i + j + k))
                j += 2 * k
            k //= 2
        p *= 2
    return out


def key_of(v):
    u = np.ascontiguousarray(v, F4).view(U4)
    k = np.where(u & U4(0x80000000), ~u, u | U4(0x80000000)).astype(U4)
    return np.where(np.isnan(v), NAN_KEY, k).astype(U4)


def value_of(k):
    u = np.where(k & U4(0x80000000), k & U4(0x7FFFFFFF), ~k).astype(U4)
    return np.where(k == NAN_KEY, F4(np.nan), u.view(F4))


def network(cap):
    """The network of a bucket of ``cap`` keys: the power-of-two network
    at least as large, pruned to the first ``cap`` keys."""
    n = 1
    while n < cap:
        n *= 2
    return batcher(n, cap)


def pick(keys, idx):
    """keys[idx] per column by the kernel's select tree: each level keeps
    the odd or the even half by one bit of idx (an odd level's last key
    stays where idx cannot reach its missing pair)."""
    idx = idx.copy()
    while len(keys) > 1:
        odd = keys[1::2]
        if len(odd) < len(keys[0::2]):
            odd = np.concatenate([odd, keys[-1:]])
        keys = np.where((idx & 1).astype(bool), odd, keys[0::2])
        idx >>= 1
    return keys[0]


def order_stats(vals, cnt):
    """(s_lo, s_hi) of the (N, P) stack ``vals`` (+inf where an epoch has
    no weight) as H9 forms them."""
    n = vals.shape[0]
    cap = next(b for b in BUCKETS if b >= n)
    keys = np.full((cap, vals.shape[1]), PAD_KEY, U4)
    keys[:n] = key_of(vals)
    for a, b in network(cap):
        lo, hi = np.minimum(keys[a], keys[b]), np.maximum(keys[a], keys[b])
        keys[a], keys[b] = lo, hi
    lo = np.clip((cnt - 1) // 2, 0, n - 1)
    hi = np.clip(cnt // 2, 0, n - 1)
    return value_of(pick(keys, lo)), value_of(pick(keys, hi))


def fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F4)


def combine(imgs, wgts, masks, cov, scales=None, nsigma=4.0, amp_frac=0.3):
    """H9's per-pixel function over (N, P) planes, step by step in the
    kernel's f32 roundings."""
    n = imgs.shape[0]
    nsigma, amp_frac = F4(nsigma), F4(amp_frac)
    with np.errstate(all='ignore'):
        x = imgs.astype(F4)
        if scales is None:
            ww, v = wgts.astype(F4), x
        else:
            s = scales.astype(F4)[:, None]
            ww, v = (wgts / (s * s)).astype(F4), (x * s).astype(F4)
        ok = ww > 0
        cnt = ok.sum(0)
        slo, shi = order_stats(np.where(ok, v, F4(np.inf)), cnt)
        med = np.where(cnt > 0, F4(0.5) * (slo + shi), F4(0)).astype(F4)
        amed = np.abs(med)
        atol = (amp_frac * amed).astype(F4)
        sigma = (F4(1) / np.sqrt(np.maximum(ww, F4(1e-30)))).astype(F4)
        ns = (nsigma * sigma).astype(F4)
        tol = (ns + atol) if n <= SEQUENTIAL else fma(amp_frac, amed, ns)
        dev = np.abs(v - med) if scales is None else np.abs(fma(x, s, -med))
        keep = ok & (dev <= tol)
        split = n if n <= SEQUENTIAL else 32 - (64 - n) // 2
        start = F4(0.0 if SEQUENTIAL < n < 64 else -0.0)
        shape = imgs.shape[1:]
        wsum = [np.full(shape, start), np.full(shape, start)]
        csum = [np.full(shape, start), np.full(shape, start)]
        for e in range(n):
            h = int(e >= split)
            wsum[h] = (wsum[h] + np.where(keep[e], ww[e], F4(0))).astype(F4)
            csum[h] = (csum[h] + np.where(keep[e], (ww[e] * v[e]).astype(F4),
                                          F4(0))).astype(F4)
        ws = wsum[0] if n <= SEQUENTIAL else (wsum[0] + wsum[1]).astype(F4)
        cs = csum[0] if n <= SEQUENTIAL else (csum[0] + csum[1]).astype(F4)
        coadd = np.where(ws > 0, cs / np.where(ws > 0, ws, F4(1)), F4(0))
    m = np.bitwise_and.reduce(np.where(cov, masks, np.int32(-1)), axis=0)
    mask = np.where(cov.any(0), m, 0) | np.where(
        ws == 0, 1 << MASK_BIT_NODATA_ALIGN, 0)
    return {'coadd': coadd.astype(F4), 'weight': ws,
            'nclip': (cnt - keep.sum(0)).astype(np.int32),
            'nexp': cnt.astype(np.int32), 'mask': mask.astype(np.int32)}


def stack(n, npix, seed, sigma4=False):
    """(imgs, wgts, masks, cov, scales) of n epochs by npix pixels: noise
    about 100 with outliers, epochs without weight, all-invalid pixels,
    ties, +-0, +-inf and NaN of either sign at weight > 0, a pixel whose
    every epoch is -0; weights 1/16 everywhere with ``sigma4``."""
    rng = np.random.default_rng(seed)
    imgs = rng.normal(100.0, 5.0, (n, npix)).astype(F4)
    imgs[rng.random((n, npix)) < 0.03] += F4(300.0)
    if sigma4:
        w = np.full((n, npix), 1.0 / 16.0, F4)
    else:
        w = rng.uniform(0.02, 0.06, (n, npix)).astype(F4)
    w[rng.random((n, npix)) < 0.15] = 0.0
    w[:, :16] = 0.0                             # no epoch has data
    w[0, 16:48] = 0.0                           # the other parity
    imgs[:, 48:64] = imgs[0, 48:64]             # every epoch ties
    imgs[: max(1, n // 2), 64:80] = imgs[0, 64:80]   # half tie
    imgs[:, 80:96] = np.round(rng.normal(0.0, 0.6, (n, 16))).astype(F4)
    signs = rng.random((n, 16)) < 0.5
    imgs[:, 80:96] = np.where(imgs[:, 80:96] == 0,
                              np.where(signs, F4(-0.0), F4(0.0)),
                              imgs[:, 80:96])   # medians of +-0
    imgs[:, 96] = F4(-0.0)                       # every epoch -0
    w[:, 96] = F4(0.0625)
    special = np.array([np.inf, -np.inf, np.nan, -np.nan], F4)
    hit = rng.random((n, npix)) < 0.04
    hit[:, :100] = False
    imgs[hit] = special[rng.integers(0, 4, int(hit.sum()))]
    half = n // 2 + 1                            # NaN at weight > 0:
    imgs[:half, 100:102] = np.nan                # at the median,
    imgs[:half, 102:104] = -np.nan
    imgs[n - 1, 104:108] = np.nan                # one epoch
    imgs[:half, 108:110] = np.inf                # +inf at the median
    w[:, 100:110] = F4(0.03)
    w[n // 2:, 101:110:2] = 0.0                  # beside epochs without
    masks = rng.integers(0, 1 << 16, (n, npix)).astype(np.int32)
    masks = np.where(rng.random((n, npix)) < 0.5, masks, 0x7FFF).astype(
        np.int32)
    cov = rng.random((n, npix)) < 0.8
    cov[:, 110:112] = False                      # no epoch covers
    scales = rng.uniform(0.2, 0.5, n).astype(F4)
    return imgs, w, masks, cov, scales


def same(a, b):
    """Bit-equal, NaN where the other is NaN."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == 'f':
        nan = np.isnan(a)
        return bool((nan == np.isnan(b)).all()
                    and (a[~nan].view(U4) == b[~nan].view(U4)).all())
    return bool((a == b).all())


@pytest.mark.parametrize('cap', BUCKETS)
def test_network_size_and_sort(cap):
    """The emulated network has the kernel's comparator count (its
    static_asserts check its own), every comparator within the bucket, and
    sorts: all 0-1 inputs at 8 and 16 keys (the 0-1 principle), random
    keys with many duplicates past 16."""
    net = network(cap)
    assert len(net) == NET_SIZES[BUCKETS.index(cap)]
    assert all(0 <= a < b < cap for a, b in net)
    if cap <= 16:
        keys = ((np.arange(1 << cap)[None, :] >> np.arange(cap)[:, None])
                & 1).astype(U4)
    else:
        rng = np.random.default_rng(cap)
        keys = rng.integers(0, 9, (cap, 20000)).astype(U4)
    want = np.sort(keys, axis=0)
    for a, b in net:
        lo, hi = np.minimum(keys[a], keys[b]), np.maximum(keys[a], keys[b])
        keys[a], keys[b] = lo, hi
    assert (keys == want).all()


def test_key_map_orders_as_torch_sort():
    """key_of orders -inf < -max < ... < -0 < +0 < ... < +inf < NaN (every
    NaN one key) < padding, and value_of inverts it bit for bit."""
    tiny = np.finfo(F4).smallest_subnormal
    vals = np.array([-np.inf, -np.finfo(F4).max, -1.5, -tiny, -0.0, 0.0,
                     tiny, 1.5, np.finfo(F4).max, np.inf], F4)
    keys = key_of(vals)
    assert (np.diff(keys.astype(np.int64)) > 0).all()
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                    U4).view(F4)
    assert (key_of(nans) == NAN_KEY).all()
    assert keys[-1] < NAN_KEY < PAD_KEY
    assert same(value_of(keys), vals)
    assert np.isnan(value_of(np.array([NAN_KEY], U4))).all()
    # torch.sort's order on the same values (a tie of -0 and +0 aside)
    mixed = np.concatenate([vals, nans])
    got = value_of(np.sort(key_of(mixed)))
    want = torch.sort(torch.as_tensor(mixed)).values.numpy()
    assert (np.isnan(got) == np.isnan(want)).all()
    assert (got[~np.isnan(got)] == want[~np.isnan(want)]).all()


@pytest.mark.parametrize('n', range(1, 65))
def test_order_stats_match_torch_sort(n):
    imgs, w, _, _, _ = stack(n, 512, 1000 + n)
    ok = w > 0
    vals = np.where(ok, imgs, F4(np.inf))
    cnt = ok.sum(0)
    slo, shi = order_stats(vals, cnt)
    svals = torch.sort(torch.as_tensor(vals), dim=0).values
    lo = torch.as_tensor(np.clip((cnt - 1) // 2, 0, n - 1))[None]
    hi = torch.as_tensor(np.clip(cnt // 2, 0, n - 1))[None]
    tlo = torch.gather(svals, 0, lo)[0].numpy()
    thi = torch.gather(svals, 0, hi)[0].numpy()
    for got, want in ((slo, tlo), (shi, thi)):
        zero = (got == 0) & (want == 0)
        assert same(np.where(zero, F4(0), got), np.where(zero, F4(0), want))
    # the sign of a zero median reaches no output
    with np.errstate(all='ignore'):
        med = np.where(cnt > 0, F4(0.5) * (slo + shi), F4(0)).astype(F4)
        tmed = np.where(cnt > 0, F4(0.5) * (tlo + thi), F4(0)).astype(F4)
        assert same(np.abs(med), np.abs(tmed))
        assert same(np.abs(imgs - med), np.abs(imgs - tmed))
        s = F4(0.37)
        assert same(np.abs(fma(imgs, s, -med)), np.abs(fma(imgs, s, -tmed)))
    # the stack holds what it should
    both = np.concatenate([slo, shi])
    assert (cnt == 0).any() and np.isnan(both).any()
    assert np.isposinf(both).any() and (both == 0).any()
    if n > 1:
        assert ((both == 0) & np.signbit(both)).any()


@pytest.mark.parametrize('scaled', [False, True])
@pytest.mark.parametrize('n', [1, 2, 3, 8, 9, 16, 17, 31, 32, 33, 50, 62,
                               63, 64])
def test_emulated_combine_equals_plain(n, scaled):
    imgs, w, masks, cov, scales = stack(n, 2048, 2000 + n)
    sc = scales if scaled else None
    got = combine(imgs, w, masks, cov, sc)
    def T(a):            # (N, 1, P): the plain version takes (N, H, W)
        return torch.as_tensor(a[:, None])
    want = tops.clipped_combine_plain(T(imgs), T(w), T(masks), T(cov),
                                      None if sc is None else
                                      torch.as_tensor(sc))
    assert set(got) == set(want)
    for key in want:
        assert same(got[key], want[key][0].numpy()), key
    # every epoch -0: the sum keeps -0 but where sum_last pads in front
    assert got['coadd'][96] == 0
    assert np.signbit(got['coadd'][96]) == (not SEQUENTIAL < n < 64)
    assert (got['nclip'] > 0).any() and (got['nexp'] == 0).any()


@pytest.mark.parametrize('n', [1, 2, 7, 16, 17, 33, 50, 64])
def test_emulated_combine_matches_reference(n):
    imgs, w, masks, cov, _ = stack(n, 1024, 3000 + n, sigma4=True)
    got = combine(imgs, w, masks, cov)
    ref = {k: np.asarray(v) for k, v in jops.clipped_coadd(
        jnp.asarray(imgs), jnp.asarray(w)).items()}
    assert same(got['nexp'], ref['nexp'])
    assert same(got['nclip'], ref['nclip'])
    for key in ('weight', 'coadd'):
        a, r = got[key], ref[key]
        assert (np.isnan(a) == np.isnan(r)).all()
        fin = ~np.isnan(r)
        np.testing.assert_allclose(a[fin], r[fin], rtol=2e-6, atol=0)
    assert (got['nclip'] > 0).any()

