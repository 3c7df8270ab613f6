"""PyTorch port vs the JAX reference: Lanczos-3 warp, mask warp and the
coverage gate (H1's plain version), on the CPU at 256^2.

Tolerances: pixels rtol 3e-5, atol 5e-3 counts (docs/PARITY_CONTRACT.md,
Lanczos-3 warp); the mask and the coverage are integer decisions and must
be bit-equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu.ops import resample as jr
from zuds_tpu_torch.ops import resample as tr

torch.set_num_threads(2)

H = W = 256
STEP = 32
WINDOW = 2


def _grid(rng):
    """Smooth sub-pixel mapping grid, |du|, |dv| < 2 (the bucket)."""
    gy, gx = np.mgrid[0:(H - 1) // STEP + 2,
                      0:(W - 1) // STEP + 2].astype('f4') * STEP
    gu = gx + (1.3 * np.sin(gy / 70.0) + 0.4).astype('f4')
    gv = gy + (1.1 * np.cos(gx / 50.0) - 0.7).astype('f4')
    return gu.astype('f4'), gv.astype('f4')


@pytest.fixture(scope='module')
def scene():
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:H, 0:W]
    img = (150.0 + 30 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
           + rng.normal(0, 5, (H, W))).astype('f4')
    for _ in range(20):
        x0, y0 = rng.uniform(10, W - 10, 2)
        img += (5e3 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 4.5)
                ).astype('f4')
    bits = rng.integers(0, 1 << 18, (H, W)).astype('i4')
    mask = np.where(rng.random((H, W)) < 0.02, bits, 0).astype('i4')
    gu, gv = _grid(rng)
    u, v = jr.upsample_mapping(jnp.asarray(gu), jnp.asarray(gv), (H, W),
                               STEP)
    covb = np.asarray([2, W - 3, 2, H - 3], 'f4')
    covb_tight = np.asarray([5.5, W - 9.0, 4.0, H - 20.0], 'f4')
    return dict(img=img, mask=mask, gu=gu, gv=gv, u=np.asarray(u),
                v=np.asarray(v), covb=covb, covb_tight=covb_tight)


def T(a):
    return torch.as_tensor(np.array(a))


def test_lanczos3_matches_reference():
    t = np.linspace(-3.5, 3.5, 7001, dtype='f4')
    np.testing.assert_allclose(tr.lanczos3(T(t)).numpy(),
                               np.asarray(jr.lanczos3(jnp.asarray(t))),
                               rtol=1e-6, atol=1e-7)


def test_sig_lanczos_constants_are_the_references():
    assert tr._SIG_A == jr._SIG_A and tr._SIG_B == jr._SIG_B
    assert tr._SIG_C == jr._SIG_C
    t = np.linspace(-3, 3, 60001, dtype='f4')
    np.testing.assert_array_equal(tr._sig_lanczos(T(t)).numpy(),
                                  np.asarray(jr._sig_lanczos(jnp.asarray(t))))


def test_upsample_mapping(scene):
    tu, tv = tr.upsample_mapping(T(scene['gu']), T(scene['gv']), (H, W),
                                 STEP)
    # the same bilinear formula; XLA may contract a*b + c into one FMA
    np.testing.assert_allclose(tu.numpy(), scene['u'], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), scene['v'], rtol=0, atol=1e-4)


def test_warp_shift_image(scene):
    ju, jv = jnp.asarray(scene['u']), jnp.asarray(scene['v'])
    jw, jc = jr.warp_shift_image(jnp.asarray(scene['img']), ju, jv,
                                 window=WINDOW)
    tw, tc = tr.warp_shift_image(T(scene['img']), T(scene['u']),
                                 T(scene['v']), window=WINDOW)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=3e-5,
                               atol=5e-3)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_warp_shift_mask_bit_equal(scene):
    ju, jv = jnp.asarray(scene['u']), jnp.asarray(scene['v'])
    jm = jr.warp_shift_mask(jnp.asarray(scene['mask']).astype(jnp.uint32),
                            ju, jv, window=WINDOW)
    tm = tr.warp_shift_mask(T(scene['mask']), T(scene['u']), T(scene['v']),
                            window=WINDOW)
    assert tm.dtype == torch.int32
    assert (np.asarray(jm) != 0).sum() > 1000
    np.testing.assert_array_equal(tm.numpy(),
                                  np.asarray(jm).astype(np.int32))


@pytest.mark.parametrize('bounds', ['covb', 'covb_tight'])
def test_warp_reference_matches_one_frame(scene, bounds):
    """H1's plain version against the reference's warp + mask warp +
    original-frame coverage gate (pipeline.py:162-180)."""
    ju, jv = jnp.asarray(scene['u']), jnp.asarray(scene['v'])
    covb = jnp.asarray(scene[bounds])
    refw, cov = jr.warp_shift_image(jnp.asarray(scene['img']), ju, jv,
                                    window=WINDOW)
    refm = jr.warp_shift_mask(jnp.asarray(scene['mask']).astype(jnp.uint32),
                              ju, jv, window=WINDOW)
    covo = ((ju >= covb[0]) & (ju <= covb[1])
            & (jv >= covb[2]) & (jv <= covb[3]))
    cov = cov * covo.astype(jnp.float32)
    refw = refw * cov
    refm = jnp.where(cov > 0, refm, jnp.uint32(0))

    tw, tm, tc = tr.warp_reference(T(scene['img']), T(scene['mask']),
                                   T(scene['u']), T(scene['v']),
                                   T(scene[bounds]), WINDOW)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(cov))
    np.testing.assert_array_equal(tm.numpy(),
                                  np.asarray(refm).astype(np.int32))
    np.testing.assert_allclose(tw.numpy(), np.asarray(refw), rtol=3e-5,
                               atol=5e-3)


def test_warp_past_the_bucket_drops_far_taps(scene):
    """A displacement beyond window+3 keeps the windowed semantics: the
    reference drops the far taps, and so does the port."""
    u = scene['u'] + np.float32(4.6)
    ju, jv = jnp.asarray(u), jnp.asarray(scene['v'])
    jw, _ = jr.warp_shift_image(jnp.asarray(scene['img']), ju, jv,
                                window=WINDOW)
    jm = jr.warp_shift_mask(jnp.asarray(scene['mask']).astype(jnp.uint32),
                            ju, jv, window=WINDOW)
    tw, _ = tr.warp_shift_image(T(scene['img']), T(u), T(scene['v']),
                                window=WINDOW)
    tm = tr.warp_shift_mask(T(scene['mask']), T(u), T(scene['v']),
                            window=WINDOW)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=3e-5,
                               atol=5e-3)
    np.testing.assert_array_equal(tm.numpy(),
                                  np.asarray(jm).astype(np.int32))
