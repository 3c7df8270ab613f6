"""The port's stamp selector, stamp-moment seeing and frame medians against
the JAX package on the CPU (the plain versions of H7 and H8; the kernels
themselves are held to these in tests/test_torch_kernels_cuda.py).

Tolerances: ``select_stamps_device`` xs, ys and valid bit-equal (including
the x, y the invalid slots take from the top-k's tie order);
``seeing_from_stamps`` rtol 1e-6 (sums of 625 products, added in the
reference's order on the CPU); ``bisect_median`` of whole frames and ::4
views bit-equal (integer counts, f32 bisection).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu.ops import background as jb
from zuds_tpu.ops import measure as jm
from zuds_tpu_torch.ops import background as tb
from zuds_tpu_torch.ops import measure as tm

torch.set_num_threads(2)


def T(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def star_field(H=256, W=256, nstars=120, seed=0, plateaus=True):
    """Stars on noise at 256^2: more candidates than a region keeps, flat
    plateaus whose maxima tie, and a saturated star."""
    rng = np.random.default_rng(seed)
    img = rng.normal(150.0, 5.0, (H, W))
    yy, xx = np.mgrid[0:H, 0:W]
    for x, y, f in zip(rng.uniform(0, W, nstars), rng.uniform(0, H, nstars),
                       rng.uniform(800, 20000, nstars)):
        img += f / (2 * np.pi * 2.0) * np.exp(
            -((xx - x) ** 2 + (yy - y) ** 2) / 4.0)
    if plateaus:
        # equal flat tops: several pixels tie for the 9x9 maximum, and
        # equal peaks tie in the per-region top-k
        for (x, y) in ((60, 60), (120, 60), (60, 180), (200, 200)):
            img[y - 1:y + 2, x - 1:x + 2] = 3000.0
    img[128, 30] = 9000.0
    return img.astype('f4')


@pytest.mark.parametrize('seed,smax,nreg,sat,margin', [
    (0, 384, 3, 5e3, 21), (1, 32, 2, 5e3, 13), (2, 40, 3, 6e4, 21),
    (3, 16, 1, 2000.0, 8), (4, 700, 3, 5e3, 5)])
def test_select_stamps_bit_equal(seed, smax, nreg, sat, margin):
    img = star_field(seed=seed)
    j = jm.select_stamps_device(jnp.asarray(img), smax=smax, nreg=nreg,
                                sat_level=sat, margin=margin)
    t = tm.select_stamps_device(T(img), smax=smax, nreg=nreg, sat_level=sat,
                                margin=margin)
    for name, a, b in zip(('xs', 'ys', 'valid'), j, t):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert t[2].any()


def test_select_stamps_more_candidates_than_a_region_keeps():
    """The per-region top-k is exercised: a region holds more candidates
    than smax // nreg^2."""
    img = star_field(seed=5, nstars=200)
    med = tb.frame_median(T(img))
    sigma = 1.4826 * tb.frame_median(T(img), center=med)
    _, cand = tm.stamp_candidates(T(img), med, sigma, 5e3, 13)
    ys, xs = np.nonzero(cand.numpy())
    per_region = np.bincount((ys * 2 // 256) * 2 + xs * 2 // 256,
                             minlength=4)
    assert per_region.max() > 32 // 4
    j = jm.select_stamps_device(jnp.asarray(img), smax=32, nreg=2,
                                sat_level=5e3, margin=13)
    t = tm.select_stamps_device(T(img), smax=32, nreg=2, sat_level=5e3,
                                margin=13)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_select_stamps_threshold_is_one_fma():
    """XLA's CPU backend contracts the reference's ``med + 10.0 * sigma``
    into one FMA; the plain version (and H7) compute it so."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        med = np.float32(rng.uniform(100, 200))
        sig = np.float32(rng.uniform(1, 10))
        fused = np.float32(np.float64(med) + 10.0 * np.float64(sig))
        if fused > np.float32(med + np.float32(10.0) * sig):
            break
    img = np.full((64, 64), 0.0, 'f4')
    img[32, 32] = fused * 16 / 4     # filt at the peak is exactly `fused`
    _, cand = tm.stamp_candidates_plain(T(img), torch.tensor(med),
                                        torch.tensor(sig), 1e30, 4)
    # filt == fused exceeds the unfused threshold, not the fused one
    assert not bool(cand[32, 32])


@pytest.mark.parametrize('seed,nvalid', [(0, 64), (1, 9), (2, 10), (3, 0),
                                         (4, 1)])
def test_seeing_from_stamps(seed, nvalid):
    """An even count of valid stamps averages the two middle FWHMs, as
    jnp.nanmedian does; none valid gives 2.0."""
    img = star_field(seed=seed)
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 256, 80).astype('f4')
    ys = rng.uniform(0, 256, 80).astype('f4')
    valid = np.zeros(80, bool)
    valid[rng.permutation(64)[:nvalid]] = True
    j = float(jm.seeing_from_stamps(jnp.asarray(img), jnp.asarray(xs),
                                    jnp.asarray(ys), jnp.asarray(valid)))
    t = float(tm.seeing_from_stamps(T(img), T(xs), T(ys), T(valid)))
    assert abs(t - j) <= 1e-6 * abs(j), (t, j)
    if nvalid == 0:
        assert t == 2.0


FRAMES = {
    'frame': lambda f, ok: (f, None),
    'frame_mask': lambda f, ok: (f, ok),
    'view4': lambda f, ok: (f[::4, ::4], ok[::4, ::4]),
    'view4_all': lambda f, ok: (f[::4, ::4], None),
    'all_masked': lambda f, ok: (f, np.zeros_like(ok)),
    'one_valid': lambda f, ok: (f, np.eye(*f.shape, dtype=bool)[::-1] &
                                (np.arange(f.shape[1]) == 5)),
}


@pytest.mark.parametrize('case', sorted(FRAMES))
@pytest.mark.parametrize('center', [False, True])
def test_frame_median_bit_equal(case, center):
    """One row of the reference's bisect_median over a whole (sub)frame,
    as the stamp selector and the pipeline call it."""
    rng = np.random.default_rng(9)
    frame = rng.normal(150.0, 5.0, (200, 136)).astype('f4')
    frame[::7, ::5] = np.round(frame[::7, ::5])       # ties
    ok = rng.random((200, 136)) > 0.3
    x, o = FRAMES[case](frame, ok)
    jx = jnp.asarray(np.ascontiguousarray(x))
    jok = jnp.asarray(np.ones(x.shape, bool) if o is None else o)
    c = None
    if center:
        c = np.float32(np.median(frame))
        jx = jnp.abs(jx - c)
    want = np.asarray(jb.bisect_median(jx.ravel()[None], jok.ravel()[None])[0])
    got = tb.frame_median(T(frame)[::4, ::4] if case.startswith('view4')
                          else T(x), None if o is None else T(o),
                          None if c is None else torch.tensor(c)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_frame_median_propagates_nan():
    frame = np.random.default_rng(2).normal(150, 5, (64, 64)).astype('f4')
    frame[3, 3] = np.nan
    want = np.asarray(jb.bisect_median(jnp.asarray(frame).ravel()[None],
                                       jnp.ones((1, 64 * 64), bool))[0])
    got = tb.frame_median(T(frame)).numpy()
    assert np.isnan(want) and np.isnan(got)

