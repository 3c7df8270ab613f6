"""The port's ZOGY (``zuds_tpu_torch/ops/zogy.py``) against the JAX
package's ``zuds_tpu/ops/zogy.py`` on the CPU, on the same numpy inputs.

* ``_psf_to_otf``: rtol 1e-6, with an atol of 1e-6 of the OTF's peak (its
  modes near zero differ in the FFTs' rounding).
* ``estimate_psf_from_stars`` on ``tests/test_zogy.py``'s PSF scene and on a
  scene with stars at the border (clamped corners), padding rows, a star
  whose total is negative and a stamp with a planted cosmic ray: the PSF
  within 1e-7 absolute (measured ~1e-8). The reference returns the PSF
  alone, so ``good`` is held equal through it: flipping any one stamp's
  flag moves the PSF by more than twice that tolerance.
* ``zogy_subtract`` on ``test_zogy.py``'s star and noise scenes at 256^2
  and on a 250x197 noise frame (the half axis of an odd width): ``psf_d``
  1e-7 absolute, ``f_d`` rtol 1e-6, ``s_corr`` 1e-3 absolute. ``d`` is
  ill-conditioned in the reference itself (near Nyquist the OTFs fall to
  f32 rounding, where two FFT libraries disagree): the port's largest
  error against a float64 run of the plain version is at most twice the
  JAX output's own plus 1e-3.
* The properties ``test_zogy.py`` asserts hold for the port, and the
  reference's whitened ``d`` (std ~0.92 on noise of sigma 3, whose rms
  product is 4.24) is pinned in both packages.
* The f32 scalars, ``jnp.fft.fftfreq``'s quotients, ``jnp.median``'s
  midpoint and its NaN, ``jnp.abs`` of a complex64 (bit-equal; a hypot is
  not); a NaN under a padding row spoils the PSF in both.
* The launch wrappers of H15-H18 refuse CPU tensors.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu.ops import zogy as jz
from zuds_tpu_torch.kernels import launch
from zuds_tpu_torch.ops import zogy as tz
from zuds_tpu_torch.ops.cutouts import clamped_corners

torch.set_num_threads(2)

SEED = 8675309          # tests/conftest.py's rng


def gauss_psf(size, sigma):
    r = size // 2
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    p = np.exp(-(x * x + y * y) / (2 * sigma ** 2))
    return (p / p.sum()).astype('f4')


def render(H, W, xs, ys, fluxes, sigma, rng, noise):
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.zeros((H, W))
    for x, y, f in zip(xs, ys, fluxes):
        img += f * np.exp(-((xx - x) ** 2 + (yy - y) ** 2)
                          / (2 * sigma ** 2)) / (2 * np.pi * sigma ** 2)
    return (img + rng.normal(0, noise, (H, W))).astype('f4')


def star_scene():
    """test_zogy.py's stars-cancel scene: 30 stars, PSF sigma 1.5 (ref) and
    2.2 (new), noise 1, a transient of 15000 at (130, 140) in new."""
    rng = np.random.default_rng(SEED)
    H = W = 256
    xs = rng.uniform(20, W - 20, 30)
    ys = rng.uniform(20, H - 20, 30)
    fluxes = rng.uniform(5000, 30000, 30)
    ref = render(H, W, xs, ys, fluxes, 1.5, rng, 1.0)
    new = render(H, W, xs, ys, fluxes, 2.2, rng, 1.0)
    yy, xx = np.mgrid[0:H, 0:W]
    new += (15000.0 * np.exp(-((xx - 130) ** 2 + (yy - 140) ** 2)
                             / (2 * 2.2 ** 2)) / (2 * np.pi * 2.2 ** 2)
            ).astype('f4')
    return dict(new=new, ref=ref, psf_new=gauss_psf(25, 2.2),
                psf_ref=gauss_psf(25, 1.5), sigma_new=1.0, sigma_ref=1.0,
                stars=(xs, ys))


def noise_scene(H=256, W=256):
    """test_zogy.py's noise-normalisation scene: noise of sigma 3."""
    rng = np.random.default_rng(SEED)
    ref = rng.normal(0, 3.0, (H, W)).astype('f4')
    new = rng.normal(0, 3.0, (H, W)).astype('f4')
    return dict(new=new, ref=ref, psf_new=gauss_psf(25, 2.0),
                psf_ref=gauss_psf(25, 1.6), sigma_new=3.0, sigma_ref=3.0)


ARGS = ('new', 'ref', 'psf_new', 'psf_ref', 'sigma_new', 'sigma_ref')


def run_jax(sc):
    out = jz.zogy_subtract(*(jnp.asarray(sc[k]) for k in ARGS[:4]),
                           sc['sigma_new'], sc['sigma_ref'])
    return {k: np.asarray(v) for k, v in out.items()}


def run_port(sc, dtype=torch.float32, plain=False):
    fn = tz.zogy_subtract_plain if plain else tz.zogy_subtract
    out = fn(*(torch.as_tensor(sc[k]).to(dtype) for k in ARGS[:4]),
             sc['sigma_new'], sc['sigma_ref'])
    return {k: v.numpy() for k, v in out.items()}


SCENES = {'stars': star_scene, 'noise': noise_scene,
          'noise_250x197': lambda: noise_scene(250, 197)}


@pytest.fixture(scope='module')
def runs():
    out = {}
    for name, make in SCENES.items():
        sc = make()
        out[name] = (sc, run_jax(sc), run_port(sc),
                     run_port(sc, torch.float64, plain=True))
    return out


# ---- _psf_to_otf --------------------------------------------------------------

@pytest.mark.parametrize('shape,size,sigma', [((256, 256), 25, 2.2),
                                              ((250, 197), 25, 1.5),
                                              ((64, 81), 15, 3.0)])
def test_psf_to_otf(shape, size, sigma):
    psf = gauss_psf(size, sigma)
    want = np.asarray(jz._psf_to_otf(jnp.asarray(psf), shape))
    got = tz._psf_to_otf(torch.as_tensor(psf), shape).numpy()
    assert got.shape == want.shape == (shape[0], shape[1] // 2 + 1)
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


# ---- estimate_psf_from_stars ------------------------------------------------

def psf_scene():
    """test_zogy.py's PSF scene: 20 stars of 50000, sigma 1.8, noise 1."""
    rng = np.random.default_rng(SEED)
    H = W = 256
    xs = rng.uniform(30, W - 30, 20)
    ys = rng.uniform(30, H - 30, 20)
    img = render(H, W, xs, ys, np.full(20, 50000.0), 1.8, rng, noise=1.0)
    return img, xs.astype('f4'), ys.astype('f4'), np.ones(20, bool)


HARD = dict(regular=40, border=3, padding=4)


def hard_scene(cosmic=True):
    """40 stars of 50000 at sigma 1.8 (those with a neighbour in their
    stamp fall to the clip); three stars within 5 px of a border (their
    corners clamp); a 'star' of -50000 (its stamp's total is negative); a
    hot pixel of +20000 beside star 0, which has no neighbour within 20 px
    (the 5 sigma clip must drop it: among 43 good stamps one outlier can
    reach 6.4 sigma); four padding rows at (0, 0) with valid False."""
    rng = np.random.default_rng(23)
    H = W = 256
    n = HARD['regular']
    xs = list(rng.uniform(30, W - 30, n))
    ys = list(rng.uniform(30, H - 30, n))
    fluxes = [50000.0] * n
    xs += [4.3, 250.6, 128.2]
    ys += [100.7, 60.1, 252.4]
    fluxes += [50000.0] * 3
    img = render(H, W, xs, ys, fluxes, 1.8, rng, noise=1.0)
    neg = (200.4, 200.6)
    img -= render(H, W, [neg[0]], [neg[1]], [50000.0], 1.8, rng,
                  noise=0.0)
    if cosmic:
        img[int(round(ys[0])) + 2, int(round(xs[0])) + 3] += 20000.0
    xs += [neg[0]] + [0.0] * HARD['padding']
    ys += [neg[1]] + [0.0] * HARD['padding']
    valid = np.ones(len(xs), bool)
    valid[-HARD['padding']:] = False
    return (img.astype('f4'), np.array(xs, 'f4'), np.array(ys, 'f4'),
            valid)


def psf_with(stamps, good):
    g = good[:, None, None].astype('f4')
    psf = np.maximum((stamps * g).sum(0) / max(g.sum(), 1.0), 0.0)
    return psf / max(psf.sum(), 1e-20)


def check_psf(img, xs, ys, valid):
    want = np.asarray(jz.estimate_psf_from_stars(
        *(jnp.asarray(a) for a in (img, xs, ys, valid))))
    t = [torch.as_tensor(a) for a in (img, xs, ys, valid)]
    got = tz.estimate_psf_from_stars(*t).numpy()
    assert got.shape == (25, 25)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(tz.estimate_psf_plain(*t).numpy(), got)
    stamps, good0 = tz.psf_stamps_plain(*t)
    psf, good = tz.psf_clip_plain(stamps, good0)
    np.testing.assert_array_equal(psf.numpy(), got)
    # the reference's good, through its PSF: each flip moves it past 2e-7
    stamps, good = stamps.numpy(), good.numpy()
    for s in range(len(good)):
        flip = good.copy()
        flip[s] = not flip[s]
        assert np.abs(psf_with(stamps, flip) - got).max() > 2e-7, s
    return got, good0.numpy(), good


def test_estimate_psf_scene():
    img, xs, ys, valid = psf_scene()
    psf, good0, good = check_psf(img, xs, ys, valid)
    assert psf.sum() == pytest.approx(1.0, abs=1e-5)
    assert np.abs(psf - gauss_psf(25, 1.8)).max() < 0.01
    assert good0.all()


def test_estimate_psf_border_padding_negative_and_cosmic_ray():
    img, xs, ys, valid = hard_scene()
    psf, good0, good = check_psf(img, xs, ys, valid)
    n, nb = HARD['regular'], HARD['border']
    # the negative star and the padding rows never count; the cosmic ray
    # is clipped, the regular stars stay
    assert not good0[n + nb:].any() and good0[:n + nb].all()
    assert not good[0] and not good[n + nb:].any() and good.sum() >= 15
    clean = [torch.as_tensor(a) for a in hard_scene(cosmic=False)]
    assert tz.psf_clip_plain(*tz.psf_stamps_plain(*clean))[1][0]
    x0, _ = clamped_corners(torch.as_tensor(xs), torch.as_tensor(ys),
                               25, *img.shape)
    assert x0[n] == 0 and x0[n + 1] == img.shape[1] - 25
    assert np.abs(psf - gauss_psf(25, 1.8)).max() < 0.01


def test_nan_under_a_padding_row_spoils_the_psf():
    """A padding row is cut at corner (0, 0) and multiplied by 0 in the
    means: a NaN there spreads, in the reference and in the port."""
    img, xs, ys, valid = hard_scene()
    img = img.copy()
    img[3, 3] = np.nan
    want = np.asarray(jz.estimate_psf_from_stars(
        *(jnp.asarray(a) for a in (img, xs, ys, valid))))
    t = [torch.as_tensor(a) for a in (img, xs, ys, valid)]
    stamps, good0 = tz.psf_stamps_plain(*t)
    assert torch.isnan(stamps[-1]).all() and not good0[-1]
    got = tz.estimate_psf_from_stars(*t).numpy()
    assert np.isnan(want).all() and np.isnan(got).all()


# ---- zogy_subtract ----------------------------------------------------------

@pytest.mark.parametrize('name', list(SCENES))
def test_zogy_subtract_against_the_reference(runs, name):
    sc, j, t, f64 = runs[name]
    H, W = sc['new'].shape
    for key in ('d', 'psf_d', 's_corr'):
        assert t[key].shape == (H, W) and t[key].dtype == np.float32
    np.testing.assert_allclose(t['psf_d'], j['psf_d'], rtol=0, atol=1e-7)
    np.testing.assert_allclose(t['f_d'], j['f_d'], rtol=1e-6)
    assert t['f_d'].dtype == np.float32 and t['f_d'].shape == ()
    np.testing.assert_allclose(t['s_corr'], j['s_corr'], rtol=0, atol=1e-3)
    port_err = np.abs(t['d'] - f64['d']).max()
    jax_err = np.abs(j['d'] - f64['d']).max()
    assert port_err <= 2 * jax_err + 1e-3, (port_err, jax_err)
    assert np.abs(t['d'] - j['d']).max() < 0.1 * j['d'].std()


def test_zogy_properties_hold_for_the_port(runs):
    """test_zogy.py's assertions on the port's output."""
    sc, _, t, _ = runs['stars']
    s = t['s_corr']
    assert s[140, 130] > 20.0
    peak = np.unravel_index(np.argmax(s), s.shape)
    assert abs(peak[0] - 140) <= 1 and abs(peak[1] - 130) <= 1
    xs, ys = sc['stars']
    for x, y in zip(xs[:10], ys[:10]):
        assert abs(s[int(y), int(x)]) < 6.0
    for name in ('noise', 'noise_250x197'):
        t = runs[name][2]
        assert t['s_corr'].std() == pytest.approx(1.0, rel=0.1)
        assert np.isfinite(t['d']).all()


def test_whitened_d_pinned_in_both(runs):
    """The reference's d is whitened (std ~0.92 on noise of sigma 3 in
    both frames) while the sub's rms is the unwhitened sqrt(3^2 + 3^2):
    a divergence of the reference (ROADMAP section 3), kept by the port."""
    _, j, t, _ = runs['noise']
    for d in (j['d'], t['d']):
        assert 0.90 < d.std() < 0.94
    assert abs(t['d'].std() - j['d'].std()) < 1e-3
    assert np.hypot(3.0, 3.0) / t['d'].std() > 4.5


# ---- the reference's f32 roundings ------------------------------------------

@pytest.mark.parametrize('sig', [(1.0, 1.0, 1.0, 1.0), (4.87, 3.21, 1.0, 1.0),
                                 (0.37, 1e-3, 1.3, 0.77)])
def test_scalars_are_formed_in_f32(sig):
    sc = tz.zogy_scalars(*sig)
    new = np.zeros((8, 8), 'f4')
    psf = gauss_psf(3, 1.0)
    out = jz.zogy_subtract(*(jnp.asarray(a) for a in (new, new, psf, psf)),
                           *sig)
    jf = np.float32(out['f_d'])
    assert abs(np.float32(sc['f_d']) - jf) <= np.spacing(jf)
    for key, v in sc.items():
        assert float(np.float32(v)) == v, key
    fn, fr = np.float32(sig[2]), np.float32(sig[3])
    assert sc['c_r'] == float((np.float32(sig[0]) ** 2) * (fr * fr))


@pytest.mark.parametrize('n', [24, 25, 31])
def test_fftfreq_is_the_reference_quotient(n):
    assert np.array_equal(
        tz._fftfreq(n, torch.float32, 'cpu').numpy(),
        np.asarray(jnp.fft.fftfreq(n)))


def test_median_rows_is_jnp_median():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 100)).astype('f4')
    x[1, :50] = x[1, 50:]                    # ties
    x[2, 7] = np.nan
    x[3, :] = np.round(x[3, :])
    want = np.asarray(jnp.median(jnp.asarray(x), axis=1))
    got = tz._median_rows(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[2]) and not np.isnan(got[[0, 1, 3, 4, 5]]).any()
    odd = x[:, :99]
    np.testing.assert_array_equal(
        tz._median_rows(torch.as_tensor(np.ascontiguousarray(odd))).numpy(),
        np.asarray(jnp.median(jnp.asarray(odd), axis=1)))


def test_cabs_is_xlas_complex_abs():
    """XLA's |z| (max * sqrt(fma(r, r, 1)), r = min / max) bit for bit over
    sixty decades, with its zeros, infinities and NaN; torch.hypot rounds
    otherwise on ~1 in 10 values. Denormals are left out: XLA:CPU flushes
    them."""
    rng = np.random.default_rng(0)
    n = 100000
    z = (rng.normal(size=n) * np.exp(rng.uniform(-30, 30, n)) + 1j
         * rng.normal(size=n) * np.exp(rng.uniform(-30, 30, n))
         ).astype(np.complex64)
    z[:6] = [0, 3 + 4j, -2j, np.inf + 1j, np.inf + np.inf * 1j,
             np.nan + 1j]
    want = np.asarray(jnp.abs(jnp.asarray(z)))
    got = tz._cabs(torch.as_tensor(z.real), torch.as_tensor(z.imag)).numpy()
    np.testing.assert_array_equal(got, want)
    hyp = torch.hypot(torch.as_tensor(z.real), torch.as_tensor(z.imag))
    assert (hyp.numpy() != want).mean() > 0.05


def test_wrappers_refuse_cpu_tensors():
    c = torch.zeros((4, 3), dtype=torch.complex64)
    with pytest.raises(ValueError, match='CUDA'):
        launch.zogy_spectral(c, c, c, c, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    f = torch.zeros((4, 4))
    with pytest.raises(ValueError, match='CUDA'):
        launch.zogy_normalize(f, f, 1.0)
    xs = torch.zeros(2)
    with pytest.raises(ValueError, match='CUDA'):
        launch.psf_stamps(f, xs, xs, torch.ones(2, dtype=torch.bool), 3)
    with pytest.raises(ValueError, match='CUDA'):
        launch.psf_clip(torch.zeros((2, 3, 3)),
                        torch.ones(2, dtype=torch.bool), 2)


def test_spectral_wrapper_takes_any_shared_dense_layout():
    # H15 is elementwise: the wrapper takes the four spectra in any dense
    # layout (cuFFT's rfft2 gives a transposed one), never a strided view
    c = torch.zeros((8, 5), dtype=torch.complex64)
    assert launch._dense(c) and launch._dense(c.t().contiguous().t())
    assert launch._dense(c[:4]) and launch._dense(torch.zeros((1, 5))[:, :])
    assert not launch._dense(c[:, :3])
    assert not launch._dense(torch.zeros((8, 10))[:, ::2])
    assert not launch._dense(c.expand(2, 8, 5))
