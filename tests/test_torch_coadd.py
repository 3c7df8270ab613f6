"""The port's coadd path against the JAX package on the CPU: the combine
ops, the epoch feed, ``CoaddPipeline``, ``Coadd.from_images``, the stack
worker and the image catalog, from the same numpy inputs made from a seed.

Tolerances:
- ``clipped_coadd``: ``nexp`` and ``nclip`` equal, ``coadd`` and
  ``weight`` rtol 2e-6 (the sums run in the reference's order; with
  FLXSCALE the reference's products differ from ``w * x`` in the last
  bit). XLA:CPU evaluates ``1/sqrt(w)`` with an approximate ``rsqrt`` (one
  ulp off for about a quarter of all weights), so the on-threshold test
  uses weights of 1/16, whose sigma is 4 in both packages;
- ``combine_masks``, ``embed_roll``, the epoch feed's grids, bounds, roll
  and scale: bit-equal;
- ``clipped_coadd_scan``: counts equal, sums rtol 2e-6;
- ``CoaddPipeline`` at 256^2: ``nexp`` and ``mask`` equal but for clip
  ties, coadd within the warp's 5e-3 counts but for star cores (where a
  clip decision within an ulp of its threshold moves the mean); the
  share of pixels past either is bounded at 1e-3;
- ``Coadd.from_images`` on 4 epochs of 512^2: header cards equal, the
  ``weight > 0`` maps agree on >= 0.9999 of the pixels, median |delta|
  < 0.01 counts, under 1e-3 of the pixels past 0.05 counts;
- the image catalog on a 256^2 frame: the same rows, positions within
  0.01 px, fluxes rtol 1e-4.
"""
import os
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

from zuds_tpu import catalog as jcatalog  # noqa: E402
from zuds_tpu import coadd as jcoadd  # noqa: E402
from zuds_tpu import utils as jutils  # noqa: E402
from zuds_tpu.fits import HDU as JHDU  # noqa: E402
from zuds_tpu.fits import Header as JHeader  # noqa: E402
from zuds_tpu.fits import read_fits as jread  # noqa: E402
from zuds_tpu.fits import write_fits as jwrite  # noqa: E402
from zuds_tpu.image import ScienceImage as JSci  # noqa: E402
from zuds_tpu.ops import coadd as jops  # noqa: E402
from zuds_tpu.parallel import pipeline as jp  # noqa: E402
from zuds_tpu.wcs import TPVWCS as JWCS  # noqa: E402
from zuds_tpu_torch import catalog as tcatalog  # noqa: E402
from zuds_tpu_torch import coadd as tcoadd  # noqa: E402
from zuds_tpu_torch import inputs, stack  # noqa: E402
from zuds_tpu_torch import utils as tutils  # noqa: E402
from zuds_tpu_torch.fits import Header  # noqa: E402
from zuds_tpu_torch.image import ScienceImage as TSci  # noqa: E402
from zuds_tpu_torch.ops import coadd as tops  # noqa: E402
from zuds_tpu_torch.parallel import pipeline as tp  # noqa: E402
from zuds_tpu_torch.wcs import TPVWCS  # noqa: E402

torch.set_num_threads(2)

T = torch.as_tensor


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _stack(n, shape=(96, 80), seed=0):
    """A warped stack with the cases the combine must get right: zero-weight
    regions, a pixel no epoch covers, even and odd counts, outliers."""
    rng = np.random.default_rng(seed)
    H, W = shape
    imgs = rng.normal(100.0, 5.0, (n, H, W)).astype('f4')
    w = rng.uniform(0.02, 0.06, (n, H, W)).astype('f4')
    w[rng.random((n, H, W)) < 0.15] = 0.0
    w[:, :8, :] = 0.0                   # cnt == 0
    w[0, 8:20, :] = 0.0                 # one epoch less: the other parity
    imgs[1, 30:40, 30:40] += 500.0      # outliers in one epoch
    imgs[rng.random((n, H, W)) < 0.01] += 200.0
    w[2, H // 2, W // 2] = -1.0         # a negative weight is no data
    scales = rng.uniform(0.2, 0.5, n).astype('f4')
    return imgs, w, scales


@pytest.mark.parametrize('scaled', [False, True])
@pytest.mark.parametrize('n', [4, 5, 8])
def test_clipped_coadd_matches(n, scaled):
    imgs, w, scales = _stack(n, seed=n)
    j = _np(jops.clipped_coadd(jnp.asarray(imgs), jnp.asarray(w),
                               jnp.asarray(scales) if scaled else None))
    t = _np(tops.clipped_coadd(T(imgs), T(w), T(scales) if scaled else None))
    assert t['nexp'].dtype == np.int32 and t['nclip'].dtype == np.int32
    np.testing.assert_array_equal(t['nexp'], j['nexp'])
    np.testing.assert_array_equal(t['nclip'], j['nclip'])
    np.testing.assert_allclose(t['weight'], j['weight'], rtol=2e-6, atol=0)
    np.testing.assert_allclose(t['coadd'], j['coadd'], rtol=2e-6, atol=0)
    assert (t['nexp'] == 0).any() and (t['nclip'] > 0).any()
    assert (t['coadd'][t['nexp'] == 0] == 0).all()
    if not scaled:      # every sum in the reference's order: bit-equal
        np.testing.assert_array_equal(t['weight'], j['weight'])
        np.testing.assert_array_equal(t['coadd'], j['coadd'])


def test_clipped_coadd_on_the_threshold():
    """Third epochs placed exactly on the clip threshold (kept) and one ulp
    past it (clipped), with weights of 1/16 (sigma exactly 4)."""
    rng = np.random.default_rng(5)
    f4 = np.float32
    med = rng.uniform(8.0, 60.0, 4000).astype('f4')
    tol = (f4(4.0) * f4(4.0) + f4(0.3) * np.abs(med)).astype('f4')
    on = (med + tol).astype('f4')
    past = np.nextafter(on, f4(np.inf))
    exact = ((on - med).astype('f4') == tol) \
        & ((past - med).astype('f4') > tol)
    assert exact.sum() > 500
    med, on, past = med[exact], on[exact], past[exact]
    n = len(med)
    imgs = np.stack([np.concatenate([med - 1, med - 1]),
                     np.concatenate([med, med]),
                     np.concatenate([on, past])])[:, None, :]
    w = np.full(imgs.shape, 1.0 / 16.0, 'f4')
    j = _np(jops.clipped_coadd(jnp.asarray(imgs), jnp.asarray(w)))
    t = _np(tops.clipped_coadd(T(imgs), T(w)))
    np.testing.assert_array_equal(t['nclip'], j['nclip'])
    np.testing.assert_array_equal(t['coadd'], j['coadd'])
    assert (t['nclip'][0, :n] == 0).all() and (t['nclip'][0, n:] == 1).all()


@pytest.mark.parametrize('n', [33, 64])
def test_clipped_coadd_deep_stack_windows(n):
    """Past 32 epochs the sums run in XLA:CPU's windows of 32 and the
    threshold is one FMA: weight and coadd bit-equal without FLXSCALE."""
    imgs, w, _ = _stack(n, shape=(40, 48), seed=n)
    j = _np(jops.clipped_coadd(jnp.asarray(imgs), jnp.asarray(w)))
    t = _np(tops.clipped_coadd(T(imgs), T(w)))
    for k in ('nexp', 'nclip', 'weight', 'coadd'):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize('mode', ['and', 'or'])
@pytest.mark.parametrize('with_cov', [False, True])
def test_combine_masks_bit_equal(mode, with_cov):
    rng = np.random.default_rng(7)
    masks = rng.integers(0, 1 << 18, (5, 40, 36)).astype(np.int32)
    masks[rng.random(masks.shape) < 0.5] = 0
    masks[:, 3, 3] = 0x7FFFFFFF
    cov = rng.random(masks.shape) < 0.7
    cov[:, :4, :] = False
    j = np.asarray(jops.combine_masks(
        jnp.asarray(masks.astype(np.uint32)),
        jnp.asarray(cov) if with_cov else None, mode=mode))
    t = tops.combine_masks(T(masks), T(cov) if with_cov else None,
                           mode=mode).numpy()
    assert t.dtype == np.int32
    np.testing.assert_array_equal(t.view(np.uint32), j)
    with pytest.raises(ValueError, match='mode'):
        tops.combine_masks(T(masks), mode='xor')


@pytest.mark.parametrize('with_med', [False, True])
def test_clipped_coadd_scan_matches(with_med):
    imgs, w, scales = _stack(6, seed=11)
    med = np.full(imgs.shape[1:], 100.0, 'f4') if with_med else None
    j = _np(jops.clipped_coadd_scan(
        jnp.asarray(imgs), jnp.asarray(w), jnp.asarray(scales),
        med=None if med is None else jnp.asarray(med)))
    t = _np(tops.clipped_coadd_scan(T(imgs), T(w), T(scales),
                                    med=None if med is None else T(med)))
    np.testing.assert_array_equal(t['nexp'], j['nexp'])
    np.testing.assert_array_equal(t['nclip'], j['nclip'])
    np.testing.assert_allclose(t['weight'], j['weight'], rtol=2e-6)
    np.testing.assert_allclose(t['coadd'], j['coadd'], rtol=2e-6, atol=1e-6)


def test_clipped_combine_plain_is_the_composition():
    """H9's plain version: clipped_coadd + the mask AND + the no-data bit,
    as the reference's pipeline composes them (pipeline.py:497-501)."""
    imgs, w, scales = _stack(4, seed=3)
    rng = np.random.default_rng(3)
    masks = rng.integers(0, 1 << 16, imgs.shape).astype(np.int32)
    cov = w > 0
    out = jops.clipped_coadd(jnp.asarray(imgs), jnp.asarray(w),
                             jnp.asarray(scales))
    jm = jops.combine_masks(jnp.asarray(masks.astype(np.uint32)),
                            jnp.asarray(cov), mode='and')
    jm = np.asarray(jnp.where(out['weight'] == 0,
                              jm | jnp.uint32(1 << 16), jm))
    t = tops.clipped_combine(T(imgs), T(w), T(masks), T(cov), T(scales))
    np.testing.assert_array_equal(t['mask'].numpy().view(np.uint32), jm)
    np.testing.assert_array_equal(t['nexp'].numpy(), np.asarray(out['nexp']))
    assert (t['mask'].numpy()[t['weight'].numpy() == 0] >> 16 & 1).all()


def test_fluxscale_and_mjd_match():
    for zp in (26.3, 25.0, 24.123, 27.9):
        assert tops.fluxscale(zp) == jops.fluxscale(zp)
    assert tops.fluxscale(26.3, 24.0) == jops.fluxscale(26.3, 24.0)
    for cards in ({'MJD-OBS': 58300.25}, {'OBSMJD': 58301},
                  {'DATE-OBS': '2018-08-15T12:34:56.5'},
                  {'DATE': '2018-08-15'}, {'MJD': 'junk', 'DATE': '2020-02-29'
                                           ' 06:00:00'}):
        assert tutils.mjd_from_header(cards) == jutils.mjd_from_header(cards)
    with pytest.raises(KeyError):
        tutils.mjd_from_header({'SEEING': 2.0})
    assert tutils._TIME_KEYS == jutils._TIME_KEYS

    class Im:
        def __init__(self, field):
            self.field, self.ccdid, self.qid, self.fid = field, 1, 2, 2
    tutils.ensure_images_have_the_same_properties([Im(1), Im(1)],
                                                  ['field', 'fid'])
    with pytest.raises(ValueError, match='field'):
        tutils.ensure_images_have_the_same_properties([Im(1), Im(2)],
                                                      ['field', 'fid'])


@pytest.mark.parametrize('shape,canvas,roll', [
    ((60, 50), (64, 64), (3, -2)), ((64, 64), (64, 64), (0, 0)),
    ((70, 50), (64, 64), (-5, 7))])
def test_embed_roll_bit_equal(shape, canvas, roll):
    rng = np.random.default_rng(1)
    img = rng.normal(size=shape).astype('f4')
    mask = rng.integers(0, 1 << 16, shape).astype(np.uint16)
    jc, jm = jp._embed_roll_device(jnp.asarray(img), jnp.asarray(mask),
                                   canvas[0], canvas[1], roll[0], roll[1],
                                   bit=16)
    tc, tm = tp.embed_roll(T(img), inputs.upload_mask(mask, shape, 'cpu'),
                           canvas[0], canvas[1], roll[0], roll[1], bit=16)
    assert tm.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


# ---- epochs on disk --------------------------------------------------------

H = W = 512
NEP = 4


@pytest.fixture(scope='module')
def epochs(tmp_path_factory):
    """tests/test_coadd_fused.py's epochs (4 of 512^2, 50 stars, seed 13)
    written by the port's writer, and the same arrays and cards written by
    the JAX package's writer into a second directory."""
    td = tmp_path_factory.mktemp('coadd_torch')
    jd = tmp_path_factory.mktemp('coadd_jax')
    tpaths, _ = inputs.write_coadd_epochs(str(td), NEP, H, W, seed=13,
                                          nstars=50)
    jpaths = []
    for p in tpaths:
        for q in (p, p.replace('sciimg', 'mskimg')):
            hdu = next(h for h in jread(q) if h.data is not None)
            h = JHeader()
            for k in hdu.header.keys():
                if k not in ('SIMPLE', 'BITPIX', 'NAXIS', 'NAXIS1', 'NAXIS2',
                             'EXTEND', 'BZERO', 'BSCALE'):
                    h.set(k, hdu.header[k])
            jwrite(str(jd / os.path.basename(q)), [JHDU(h, hdu.data)])
        jpaths.append(str(jd / os.path.basename(p)))
    return tpaths, jpaths


def _images(epochs):
    tpaths, jpaths = epochs
    return ([TSci.from_file(p) for p in tpaths],
            [JSci.from_file(p, use_existing_record=False) for p in jpaths])


def test_write_coadd_epochs_is_the_reference_scene(epochs):
    """The port's epoch writer draws tests/test_coadd_fused.py's scene."""
    sys.path.insert(0, str(ROOT / 'tests'))
    from test_coadd_fused import _write_epochs
    tpaths, _ = epochs
    d = Path(tpaths[0]).parent.parent / 'coadd_ref_scene'
    d.mkdir()
    rpaths = _write_epochs(str(d))
    for tpth, rpth in zip(tpaths, rpaths):
        a = next(h for h in jread(tpth) if h.data is not None)
        b = next(h for h in jread(rpth) if h.data is not None)
        np.testing.assert_array_equal(a.data, b.data)
        for k in ('CRPIX1', 'CRPIX2', 'MAGZP', 'OBSMJD', 'SATURATE',
                  'SEEING', 'FILENAME'):
            assert a.header[k] == b.header[k], k
        m = next(h for h in jread(tpth.replace('sciimg', 'mskimg'))
                 if h.data is not None)
        assert m.data.dtype == np.uint16 and not m.data.any()


def test_coadd_grid_and_epoch_inputs_equal(epochs):
    timgs, jimgs = _images(epochs)
    twcs, tshape = tcoadd.coadd_grid(timgs)
    jwcs, jshape = jcoadd.coadd_grid(jimgs)
    assert tshape == jshape
    np.testing.assert_array_equal(twcs.crpix, jwcs.crpix)
    np.testing.assert_array_equal(twcs.crval, jwcs.crval)
    np.testing.assert_array_equal(twcs.cd, jwcs.cd)
    Hb, Wb = (-(-s // 128) * 128 for s in tshape)
    for ti, ji in zip(timgs, jimgs):
        t = tp.prepare_epoch_inputs(ti, twcs, tp.PipelineConfig(
            height=Hb, width=Wb), device='cpu')
        j = jp.prepare_epoch_inputs(ji, jwcs, jp.PipelineConfig(
            height=Hb, width=Wb))
        assert set(t) == set(j)
        assert t['mask'].dtype == torch.int32
        for k in j:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]),
                                          err_msg=k)
            assert np.asarray(t[k]).dtype == np.asarray(j[k]).dtype, k
        # the canvas padding carries the no-data bit
        assert (t['mask'].numpy() == 1 << 16).any()


def test_epoch_past_the_bucket_raises(epochs):
    timgs, jimgs = _images(epochs)
    out = TPVWCS.simple(crval=(150.1, 35.2), crpix=(W / 2 + .5, H / 2 + .5),
                        scale_deg=1.01 / 3600.0, rot_deg=2.0)
    jout = JWCS.simple(crval=(150.1, 35.2), crpix=(W / 2 + .5, H / 2 + .5),
                       scale_deg=1.01 / 3600.0, rot_deg=2.0)
    with pytest.raises(ValueError, match='max_shift'):
        tp.prepare_epoch_inputs(timgs[0], out, tp.PipelineConfig(
            height=H, width=W), device='cpu')
    with pytest.raises(ValueError, match='max_shift'):
        jp.prepare_epoch_inputs(jimgs[0], jout, jp.PipelineConfig(
            height=H, width=W))


# ---- the pipeline -----------------------------------------------------------

PH = PW = 256


def _pipeline_inputs(seed=4, nreal=3):
    """Three dithered 256^2 epochs (stars, noise, a sky level per epoch, a
    bad column, a saturated star, 16-bit masks) plus one padded epoch with
    ``valid = 0``, as ``_coadd_fused`` pads a stack (coadd.py:83-100)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:PH, 0:PW]
    stars = [(rng.uniform(20, PW - 20), rng.uniform(20, PH - 20),
              rng.uniform(3e3, 4e4)) for _ in range(25)]
    step = 32
    ny, nx = (PH - 1) // step + 2, (PW - 1) // step + 2
    gx = (np.arange(nx, dtype='f4') * step)[None, :]
    gy = (np.arange(ny, dtype='f4') * step)[:, None]
    imgs, masks, gus, gvs = [], [], [], []
    for e in range(nreal):
        dx, dy = rng.uniform(-1.5, 1.5, 2)
        img = np.full((PH, PW), 150.0 + 20 * e)
        for x, y, f in stars:
            img += f / (2 * np.pi * 0.85 ** 2) * np.exp(
                -((xx - x - dx) ** 2 + (yy - y - dy) ** 2) / (2 * 0.85 ** 2))
        img += rng.normal(0, 5.0, (PH, PW))
        m = np.zeros((PH, PW), np.int32)
        m[:, 100 + e] = 1 << 2          # a bad column, moving with the epoch
        m[40:44, 40:44] = 1 << 1        # a harmless bit in every epoch
        imgs.append(img.astype('f4'))
        masks.append(m)
        gus.append(np.broadcast_to(gx + np.float32(dx), (ny, nx)).copy())
        gvs.append(np.broadcast_to(gy + np.float32(dy), (ny, nx)).copy())
    imgs[0][200, 60] = 7e4              # saturated: weight 0 in epoch 0
    pad = lambda a, v: np.concatenate(  # noqa: E731
        [np.stack(a), np.full((1,) + a[0].shape, v, a[0].dtype)])
    covb = np.asarray([[2, PW - 3, 2, PH - 3]] * (nreal + 1), 'f4')
    covb[-1] = 0
    return (pad(imgs, 0.0), np.asarray([6e4] * nreal + [3e38], 'f4'),
            pad(masks, 0), pad(gus, 0.0), pad(gvs, 0.0), covb,
            np.asarray([0.3, 0.28, 0.33, 1.0], 'f4')[:nreal + 1],
            np.asarray([1.0] * nreal + [0.0], 'f4'))


@pytest.mark.parametrize('subtract_back,compute_weight', [
    (True, True), (False, True), (True, False)])
def test_coadd_pipeline_matches(subtract_back, compute_weight):
    args = _pipeline_inputs()
    jcfg = jp.PipelineConfig(height=PH, width=PW, box=64)
    tcfg = tp.PipelineConfig(height=PH, width=PW, box=64)
    j = _np(jp.make_coadd_pipeline(jcfg, len(args[0]),
                                   subtract_back=subtract_back,
                                   compute_weight=compute_weight)(
        *(jnp.asarray(a) for a in args)))
    pipe = tp.CoaddPipeline(tcfg, subtract_back=subtract_back,
                            compute_weight=compute_weight)
    t = _np(pipe(*inputs.to_torch(args, 'cpu')))
    assert set(t) == set(j) == {'coadd', 'weight', 'mask', 'nexp'}
    for k in j:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    npx = PH * PW
    # a clip decision within an ulp of its threshold is the one way to
    # differ in nexp/mask: bounded, and none on this scene's sky
    assert (t['nexp'] != j['nexp']).sum() <= 1e-3 * npx
    assert (t['mask'] != j['mask']).sum() <= 1e-3 * npx
    assert ((t['weight'] > 0) == (j['weight'] > 0)).mean() >= 0.9999
    err = np.abs(t['coadd'] - j['coadd'])
    far = err > 5e-3
    assert far.mean() <= 1e-3, far.mean()
    np.testing.assert_allclose(t['weight'], j['weight'], rtol=2e-3)
    # the padded epoch changes no output: the same stack without it
    t3 = _np(pipe(*inputs.to_torch(tuple(a[:-1] for a in args), 'cpu')))
    for k in t:
        np.testing.assert_array_equal(t3[k], t[k], err_msg=k)
    # the scene exercises the gates
    assert (t['nexp'] == 3).mean() > 0.8 and (t['nexp'] < 3).any()
    assert (t['mask'] >> 16 & 1).any() and (t['mask'] & 2).any()
    # the AND drops the moving column wherever all three epochs cover
    assert not (t['mask'][8:-8] & 4).any()


def test_to_torch_takes_the_coadd_inputs():
    args = _pipeline_inputs()
    t = inputs.to_torch(args, 'cpu')
    assert len(t) == len(inputs.COADD_INPUT_NAMES) == 8
    for name, a in zip(inputs.COADD_INPUT_NAMES, t):
        assert a.dtype == (torch.int32 if name == 'masks'
                           else torch.float32), name
    again = inputs.to_torch(t, 'cpu')       # tensors pass through
    assert all(torch.equal(a, b) for a, b in zip(t, again))
    with pytest.raises(ValueError, match='inputs'):
        inputs.to_torch(args[:5], 'cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA card'):
            inputs.to_torch(args)


# ---- from_images, the worker, the catalog ----------------------------------

@pytest.fixture(scope='module')
def coadds(epochs):
    tpaths, jpaths = epochs
    timgs, jimgs = _images(epochs)
    stats = {}
    t = tcoadd.ReferenceImage.from_images(
        timgs, os.path.join(os.path.dirname(tpaths[0]), 'ref.fits'),
        calculate_seeing=False, device='cpu', stats=stats)
    j = jcoadd.ReferenceImage.from_images(
        jimgs, os.path.join(os.path.dirname(jpaths[0]), 'ref.fits'),
        calculate_seeing=False)
    return t, j, stats


def test_from_images_matches(coadds):
    t, j, stats = coadds
    assert t.data.shape == j.data.shape and t.data.dtype == j.data.dtype
    assert list(t.header.keys()) == list(j.header.keys())
    for k in j.header.keys():
        assert t.header[k] == j.header[k], k
    assert t.header['MAGZP'] == 25.0 and t.header['NCOADD'] == NEP
    assert t.header['NAXIS1'] == t.data.shape[1]
    assert t.header['MJD-OBS'] == t.header['OBSMJD'] == 58301.5
    tw, jw = t.weight_image.data, j.weight_image.data
    assert ((tw > 0) == (jw > 0)).mean() >= 0.9999
    both = (tw > 0) & (jw > 0)
    d = np.abs(t.data - j.data)[both]
    assert np.median(d) < 0.01, np.median(d)
    assert (d > 0.05).mean() < 1e-3, (d > 0.05).mean()
    tm, jm = t.mask_image.data, j.mask_image.data
    assert tm.dtype == jm.dtype == np.int32
    assert (tm != jm).mean() < 1e-4
    # the no-data bit exactly where the weight is 0
    np.testing.assert_array_equal((tm >> 16 & 1) == 1, tw == 0)
    for a in ('field', 'ccdid', 'qid', 'fid', 'basename', 'mjd', 'min_mjd',
              'max_mjd', 'version', '__ztf_type__'):
        assert getattr(t, a) == getattr(j, a), a
    assert t.mask_image.basename == j.mask_image.basename == 'ref.mask.fits'
    for suffix in ('.fits', '.mask.fits', '.weight.fits'):
        assert os.path.exists(t.local_path.replace('.fits', suffix))
    assert all(stats[k] > 0 for k in ('prepare_s', 'pipeline_s', 'fetch_s',
                                      'write_s', 'upload_bytes'))
    inner = t.data[32:-32, 32:-32]
    sky = inner[np.abs(inner - np.median(inner)) < 20]
    assert sky.std() < 5.0 / np.sqrt(NEP) * 0.302 * 1.25


def test_from_image_catalog_matches(coadds):
    """``PipelineFITSCatalog.from_image`` and ``estimate_seeing`` on the
    same 256^2 image (a crop of the JAX coadd with its weight map and
    mask) in both packages."""
    from zuds_tpu.seeing import estimate_seeing as jsee
    from zuds_tpu_torch.seeing import estimate_seeing as tsee
    _, j, _ = coadds
    crop = np.s_[100:356, 120:376]
    cats = {}
    for pkg, cls, mod in (('jax', jcoadd.ReferenceImage, jcatalog),
                          ('torch', tcoadd.ReferenceImage, tcatalog)):
        im = cls()
        im.header = (JHeader if pkg == 'jax' else Header)()
        for k in ('MAGZP', 'CRVAL1', 'CRVAL2', 'CRPIX1', 'CRPIX2', 'CD1_1',
                  'CD1_2', 'CD2_1', 'CD2_2', 'CTYPE1', 'CTYPE2'):
            im.header.set(k, j.header[k])
        im.data = np.ascontiguousarray(j.data[crop])
        im.basename = 'crop.fits'
        im._set_product('_weightimg', j.weight_image.data[crop])
        if pkg == 'torch':
            im.device = 'cpu'
        cats[pkg] = (mod.PipelineFITSCatalog.from_image(im), im)
    (jc, jim), (tc, tim) = cats['jax'], cats['torch']
    assert len(tc.data) == len(jc.data) > 10
    assert tc.data.dtype == jc.data.dtype
    for name in jc.data.dtype.names:
        a, b = tc.data[name], jc.data[name]
        if name in ('NUMBER', 'FLAGS', 'FLAGS_WEIGHT', 'IMAFLAGS_ISO',
                    'GOODCUT', 'NEGPIX', 'ISOAREA_IMAGE'):
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif name.endswith('_WORLD') and not name.startswith('ERR'):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)
        elif name in ('X_IMAGE', 'Y_IMAGE', 'XWIN_IMAGE', 'YWIN_IMAGE'):
            np.testing.assert_allclose(a, b, rtol=0, atol=0.01, err_msg=name)
        elif name in ('THETA_IMAGE', 'ERRTHETAWIN_IMAGE', 'ERRTHETA_WORLD'):
            continue    # the angle of a round source is free
        else:
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4,
                                       equal_nan=True, err_msg=name)
    np.testing.assert_allclose(tc.data['FLUX_APER'], jc.data['FLUX_APER'],
                               rtol=1e-4)
    np.testing.assert_array_equal(tim.segm_image.data, jim.segm_image.data)
    assert abs(tsee(tim) - jsee(jim)) < 1e-3
    assert tim.header['NSTARSEE'] == jim.header['NSTARSEE']


def test_stack_do_one_end_to_end(epochs, tmp_path):
    """``python -m zuds_tpu_torch.stack``'s job: a work line -> a saved
    ScienceCoadd with its bin edges and a measured SEEING."""
    tpaths, _ = epochs
    out = str(tmp_path / 'stack.fits')
    line = f'{out} 58300.0 58307.0 ' + ' '.join(tpaths)
    coadd = stack.do_one(line, device='cpu')
    assert isinstance(coadd, tcoadd.ScienceCoadd)
    assert coadd.binleft == '58300.0' and coadd.binright == '58307.0'
    assert coadd.data.shape[0] >= H
    back = tcoadd.ScienceCoadd.from_file(out)
    assert back.header['BINLEFT'] == '58300.0'
    assert back.header['NCOADD'] == NEP and back.header['MAGZP'] == 25.0
    # the scene's seeing is 2.0 px; the Lanczos warp widens it a little
    assert 1.8 < back.header['SEEING'] < 2.4
    assert back.header['NSTARSEE'] >= 5
    assert os.path.exists(out.replace('.fits', '.cat'))
    np.testing.assert_array_equal(back.data, coadd.data)
    assert stack.main(['stack']) == 2


def test_waiting_paths_raise(epochs):
    timgs, _ = _images(epochs)
    out = os.path.join(os.path.dirname(epochs[0][0]), 'never.fits')
    for kw, item in (({'solve_astrometry': True}, 'item 6, scamp'),
                     ({'db': True}, 'item 5, persistence')):
        with pytest.raises(NotImplementedError, match=item):
            tcoadd.Coadd.from_images(timgs, out, device='cpu', **kw)
    assert not os.path.exists(out)
    timgs[0].fid = 3
    with pytest.raises(ValueError, match='fid'):
        tcoadd.Coadd.from_images(timgs, out, device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA card'):
            tcoadd.Coadd.from_images(_images(epochs)[0], out)


@pytest.fixture(scope='module')
def loop_coadds(epochs, tmp_path_factory):
    """The per-epoch loop in both packages: ``fused=False`` over the four
    epochs, the third one rotated by 2 degrees (past the planned warp's 8
    px, so the gather warp runs for it and the planned warp for the rest)."""
    d = tmp_path_factory.mktemp('loop')
    timgs, jimgs = _images(epochs)
    outs = {}
    for pkg, imgs, wcs_cls, cls in (('jax', jimgs, JWCS, jcoadd.ScienceCoadd),
                                    ('torch', timgs, TPVWCS,
                                     tcoadd.ScienceCoadd)):
        imgs[2].wcs = wcs_cls.simple(
            crval=(150.1, 35.2), crpix=(W / 2 + .5, H / 2 + .5),
            scale_deg=1.01 / 3600.0, rot_deg=2.0)
        kw = {'device': 'cpu'} if pkg == 'torch' else {}
        outs[pkg] = cls.from_images(imgs, str(d / f'{pkg}_loop.fits'),
                                    fused=False, calculate_seeing=False,
                                    **kw)
    return outs


def test_coadd_loop_matches(loop_coadds):
    j, t = loop_coadds['jax'], loop_coadds['torch']
    assert t.data.shape == np.asarray(j.data).shape
    tm, jm = t.mask_image.data, np.asarray(j.mask_image.data)
    np.testing.assert_array_equal(tm, jm)
    tw, jw = t.weight_image.data, np.asarray(j.weight_image.data)
    np.testing.assert_allclose(tw, jw, rtol=2e-3, atol=1e-7)
    far = np.abs(t.data - np.asarray(j.data)) > 5e-3
    assert far.mean() <= 1e-3, far.mean()
    for key in ('NCOADD', 'MAGZP', 'NAXIS1', 'NAXIS2', 'OBSMJD'):
        assert t.header[key] == j.header[key]
    assert (tm >> 16 & 1 == 1).sum() == (tw == 0).sum() > 0
    # both warps ran: a plan for the dithered epochs, none for the rotated
    from zuds_tpu_torch.ops.resample import plan_warp
    from zuds_tpu_torch.wcs import pixel_mapping
    plans = [plan_warp(pixel_mapping(im.wcs, t.wcs, t.data.shape),
                       t.data.shape, im.data.shape)
             for im in t.input_images]
    assert [p is None for p in plans] == [False, False, True, False]


def test_fused_route_past_the_bucket_falls_back_to_the_loop(epochs, capsys,
                                                            tmp_path):
    """An epoch past the warp bucket: the fused route prints the
    reference's line and the per-epoch loop builds the stack."""
    timgs, _ = _images(epochs)
    timgs[1].wcs = TPVWCS.simple(
        crval=(150.1, 35.2), crpix=(W / 2 + .5, H / 2 + .5),
        scale_deg=1.01 / 3600.0, rot_deg=2.0)
    stats = {}
    out = str(tmp_path / 'fallback.fits')
    coadd = tcoadd.Coadd.from_images(timgs, out, device='cpu',
                                     calculate_seeing=False, stats=stats)
    printed = capsys.readouterr().out
    assert 'coadd: fused path unavailable (' in printed
    assert 'per-epoch fallback' in printed
    assert stats['loop_s'] > 0 and os.path.exists(out)
    assert coadd.header['NCOADD'] == NEP
    inner = coadd.data[40:-40, 40:-40]
    assert abs(np.median(inner) - 150.0) < 1.0


def test_from_image_parameter_order():
    """``from_image`` keeps the reference's parameter order, ``tmpdir``
    third, and adds ``device`` last."""
    import inspect
    jpar = list(inspect.signature(
        jcatalog.PipelineFITSCatalog.from_image).parameters)
    tpar = list(inspect.signature(
        tcatalog.PipelineFITSCatalog.from_image).parameters)
    assert jpar == ['image', 'kill_flagged', 'tmpdir', 'nsigma', 'max_det']
    assert tpar == jpar + ['device']
