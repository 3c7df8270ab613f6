"""The port's per-pair subtraction against the JAX package on the CPU.

* ``propagate_ref_var`` (rtol 1e-5) and ``subtract_frames`` with the
  reference's fitted coefficients passed to both (diff within the model's
  contract, atol 1e-3 plus rtol 1e-4 of the model it subtracts; rms rtol
  1e-5; the sentinel and ``BIG_RMS`` at the same pixels), on ``synth_inputs`` at 256^2, order 2 over 2x2
  regions, with a reference rms map that varies over the frame.
* ``SubtractDetectPipeline`` at ``ref_rms_mesh=True`` against the JAX
  pipeline, as ``tests/test_torch_pipeline.py`` holds the default: submask
  equal, ``diff`` within twice the reference's own spread under relative
  perturbations of ``sci`` by 1e-7, -1e-7 and 2e-7 (the largest of the
  three at each percentile), ``rms`` (which carries the fitted kernels'
  sum of squares) within twice that spread and rtol 2e-3.
* ``quick_background_estimate`` and ``prepare_hotpants`` equal (without a
  mask: with one the reference raises, ROADMAP section 3).
* ``Subtraction.from_images`` on ``tests/test_pipeline_e2e.py``'s scene at
  256^2 (30 stars, a reference dithered by (+4.1, -3.7) px and rotated by
  0.03 degrees, one transient of flux 3e4), written by each package's own
  FITS writer, at ``nreg_side=1, spatial_order=1``: the submask equal, the
  header cards equal, the aligned reference within the warp contract
  (rtol 3e-5 / atol 5e-3, plus the local gradient times the 2e-4 px by
  which the packages' upsampled mappings may differ), ``diff`` within the reference's own spread, the
  transient recovered in both, the same files on disk.
* ``Subtraction.from_images(method='zogy')`` on the same scene in both
  packages: the submask equal, the rms within a few ulp (rtol 1e-6; the
  two packages' background rms and aligned reference rms differ there),
  the header cards and the basenames of the sub, its mask and its
  ``scorr_image`` equal, the same files on disk, and
  ``tests/test_pipeline_e2e.py::test_zogy_path``'s transient peak (> 10
  sigma within 2 px) in both. Against the JAX engine run on the port's own
  inputs (the background-subtracted science frame, the aligned reference,
  the 64 stamps, the rms medians): ``diff`` within twice the JAX output's
  own error against a float64 run plus 1e-3 (``d`` is ill-conditioned in
  the reference, ``tests/test_torch_zogy.py``), ``scorr_image`` within
  1e-3, the rms bit-equal. Against the JAX package's own product, where
  the aligned references differ by the warp contract (up to ~0.26 counts
  at the star cores): 99% of the pixels within 5e-3 and all within 0.1 in
  both ``diff`` and ``scorr_image``.
* ``sub.do_one`` and ``python -m zuds_tpu_torch.sub``: the GOODCUT rows
  equal to the reference's ``do_one`` at ``ml=False`` in number and, row by
  row, in position (0.02 px) and aperture flux (rtol 2e-3: the fit moves
  at the ulp, ROADMAP section 3).
* ``MultiEpochSubtraction.from_images`` on the two single-epoch
  subtractions of a two-epoch science stack: the stack of subtractions
  through the per-epoch loop without a background, the mask equal and the
  pixels within 0.05 rms of the reference's at 99.9% of the unmasked pixels
  (the two subtractions carry the fit's ulp spread).
"""
import inspect
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'scripts'))

import dosub as jdosub  # noqa: E402
from zuds_tpu import hotpants as jhot  # noqa: E402
from zuds_tpu import utils as jutils  # noqa: E402
from zuds_tpu.coadd import ReferenceImage as JRef  # noqa: E402
from zuds_tpu.coadd import ScienceCoadd as JStack  # noqa: E402
from zuds_tpu.fits import HDU as JHDU, Header as JHeader  # noqa: E402
from zuds_tpu.fits import write_fits as jwrite  # noqa: E402
from zuds_tpu.image import ScienceImage as JSci  # noqa: E402
from zuds_tpu.ops import subtract as js  # noqa: E402
from zuds_tpu.ops import zogy as jz  # noqa: E402
from zuds_tpu.parallel import pipeline as jp  # noqa: E402
from zuds_tpu.subtraction import MultiEpochSubtraction as JMulti  # noqa
from zuds_tpu.subtraction import SingleEpochSubtraction as JSub  # noqa
from zuds_tpu.wcs import TPVWCS as JWCS  # noqa: E402
from zuds_tpu_torch import hotpants as thot  # noqa: E402
from zuds_tpu_torch import inputs  # noqa: E402
from zuds_tpu_torch import sub as tsubmod  # noqa: E402
from zuds_tpu_torch import subtraction as tsubtraction  # noqa: E402
from zuds_tpu_torch import utils as tutils  # noqa: E402
from zuds_tpu_torch.coadd import ReferenceImage as TRef  # noqa: E402
from zuds_tpu_torch.coadd import ScienceCoadd as TStack  # noqa: E402
from zuds_tpu_torch.constants import (BAD_SUM, BIG_RMS, BKG_VAL,  # noqa
                                      SUB_NODATA_SENTINEL)
from zuds_tpu_torch.fits import HDU as THDU, Header as THeader  # noqa
from zuds_tpu_torch.fits import write_fits as twrite  # noqa: E402
from zuds_tpu_torch.image import ScienceImage as TSci  # noqa: E402
from zuds_tpu_torch.ops import subtract as ts  # noqa: E402
from zuds_tpu_torch.ops import zogy as tz  # noqa: E402
from zuds_tpu_torch.parallel import pipeline as tp  # noqa: E402
from zuds_tpu_torch.subtraction import MultiEpochSubtraction as TMulti  # noqa
from zuds_tpu_torch.subtraction import SingleEpochSubtraction as TSub  # noqa
from zuds_tpu_torch.wcs import TPVWCS as TWCS  # noqa: E402

torch.set_num_threads(2)

H = W = 256
SENTINEL = np.float32(SUB_NODATA_SENTINEL)


def T(a):
    return torch.as_tensor(np.array(a))


# ---- K20 on synthetic frames ------------------------------------------------

@pytest.fixture(scope='module')
def frames():
    """synth_inputs at 256^2 with a JAX fit at order 2 over 2x2 regions, a
    smooth reference rms map, a science rms map and a bad-pixel map."""
    cfg = SimpleNamespace(smax=64, map_step=32, ksize=9)
    a = inputs.synth_inputs(1, H, W, cfg, seed=3)
    sci, _, ref, _, _, _, sx, sy, sv, gx, gy, sums, b0, _ = (x[0] for x in a)
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:H, 0:W]
    ref_rms = (3.0 + np.sin(xx / 40.0) * np.cos(yy / 55.0)
               + rng.uniform(0, 0.3, (H, W))).astype('f4')
    sci_rms = rng.uniform(4.5, 5.5, (H, W)).astype('f4')
    bad = rng.random((H, W)) < 0.02
    ivar = (1.0 / (sci_rms ** 2 + ref_rms ** 2)).astype('f4')
    basis = js.KernelBasis(9, seeing_sigma=2.0 / 2.355)
    fit = js.fit_kernel(*(jnp.asarray(x) for x in (
        ref, sci, ivar, sx, sy, sv, gx, gy, sums, b0)), stamp=25, order=2,
        nreg=2)
    return SimpleNamespace(sci=sci, ref=ref, ref_rms=ref_rms, sci_rms=sci_rms,
                           bad=bad, fit=fit, basis=basis,
                           tables=(gx, gy, sums, b0))


def test_propagate_ref_var(frames):
    f = frames
    want = np.asarray(js.propagate_ref_var(
        jnp.asarray(f.ref_rms), f.fit['coeffs'],
        *(jnp.asarray(t) for t in f.tables), order=2, nreg=2))
    coeffs = T(f.fit['coeffs'])
    got = ts.propagate_ref_var(T(f.ref_rms), coeffs,
                               *(T(t) for t in f.tables), order=2, nreg=2)
    assert got.shape == (H, W) and want.std() > 0.1 * want.mean()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    tbasis = ts.KernelBasis(9, seeing_sigma=2.0 / 2.355)
    shim = ts._propagate_ref_var(T(f.ref_rms), {'coeffs': coeffs}, tbasis, 2,
                                 2, (H, W))
    assert torch.equal(shim, got)
    # a constant sigma gives var * sum(K^2) away from the frame's edges
    kerns = ts.center_kernels(coeffs, *(T(t) for t in f.tables), order=2,
                              nreg=2)
    flat = ts.propagate_ref_var_plain(torch.full((H, W), 2.0), kerns)
    np.testing.assert_allclose(float(flat[20, 20]),
                               4.0 * float((kerns[0] ** 2).sum()), rtol=1e-5)


def test_subtract_frames_with_reference_coefficients(frames):
    f = frames
    jd, jr_ = js.subtract_frames(
        *(jnp.asarray(x) for x in (f.sci, f.ref, f.sci_rms, f.ref_rms,
                                   f.bad)), f.fit, f.basis, order=2, nreg=2)
    jd, jr_ = np.asarray(jd), np.asarray(jr_)
    tbasis = ts.KernelBasis(9, seeing_sigma=2.0 / 2.355)
    td, tr_ = ts.subtract_frames(
        *(T(x) for x in (f.sci, f.ref, f.sci_rms, f.ref_rms, f.bad)),
        {'coeffs': T(f.fit['coeffs'])}, tbasis, order=2, nreg=2)
    td, tr_ = td.numpy(), tr_.numpy()
    assert f.bad.sum() > 500
    np.testing.assert_array_equal(td == SENTINEL, f.bad)
    np.testing.assert_array_equal(jd == SENTINEL, f.bad)
    np.testing.assert_array_equal(tr_ == np.float32(BIG_RMS), f.bad)
    np.testing.assert_array_equal(tr_[f.bad], jr_[f.bad])
    ok = ~f.bad
    # the model's contract, on the model's scale: at a star core the model
    # is ~1e4 counts (one f32 ulp there is 1e-3) and the difference ~0
    model = np.abs(f.sci - jd)
    assert (np.abs(td - jd)[ok] <= (1e-3 + 1e-4 * model)[ok]).all()
    assert np.abs(td - jd)[ok].max() < 5e-3
    np.testing.assert_allclose(tr_[ok], jr_[ok], rtol=1e-5)


@pytest.mark.parametrize('contract', [False, True])
def test_subtract_epilogue_plain(frames, contract):
    """The epilogue's roundings: the eager per-pair path squares, rounds
    and adds; the jitted pipeline's sum is one FMA. With a submask the
    no-data bit lands exactly on the sentinel."""
    f = frames
    rng = np.random.default_rng(4)
    model = (f.sci + rng.normal(0, 5, (H, W))).astype('f4')
    var = (f.ref_rms ** 2).astype('f4')
    submask = np.where(f.bad, 1 << 3, 0).astype('i4')
    d, r, m = ts.subtract_epilogue(T(f.sci), T(model), T(f.sci_rms), T(var),
                                   T(f.bad), T(submask), contract=contract)
    d2, r2 = ts.subtract_epilogue_plain(T(f.sci), T(model), T(f.sci_rms),
                                        T(var), T(f.bad), contract=contract)
    assert torch.equal(d, d2) and torch.equal(r, r2)
    np.testing.assert_array_equal(m.numpy(), submask | (f.bad << 17))
    exact = np.sqrt(f.sci_rms.astype('f8') ** 2 + var.astype('f8'))
    two = np.sqrt((f.sci_rms * f.sci_rms + var).astype('f4'))
    want = np.where(f.bad, np.float32(BIG_RMS),
                    exact.astype('f4') if contract else two)
    # the CPU build's sqrt is up to one ulp off the rounded root
    np.testing.assert_allclose(r.numpy(), want, rtol=1.2e-7)
    r_other = ts.subtract_epilogue_plain(
        T(f.sci), T(model), T(f.sci_rms), T(var), T(f.bad),
        contract=not contract)[1]
    assert not torch.equal(r, r_other)
    np.testing.assert_array_equal(d.numpy()[~f.bad], (f.sci - model)[~f.bad])


# ---- the pipeline at ref_rms_mesh=True --------------------------------------

KW = dict(height=H, width=W, ksize=9, stamp=25, smax=32, order=2, nreg=2,
          max_det=128, box=64, deblend=False, ref_rms_mesh=True)


@pytest.fixture(scope='module')
def mesh_runs():
    args, planted = inputs.plant_sources(
        inputs.synth_inputs(2, H, W, tp.PipelineConfig(**KW), seed=0),
        n=3, flux=2e4, seed=1)
    jfn = jp.make_subtract_detect_pipeline(jp.PipelineConfig(**KW))
    j = {k: np.asarray(v) for k, v in
         jfn(*(jnp.asarray(a) for a in args)).items()}
    jpert = []
    for e in (1e-7, -1e-7, 2e-7):
        out = jfn(jnp.asarray((args[0] * np.float32(1 + e)).astype('f4')),
                  *(jnp.asarray(a) for a in args[1:]))
        jpert.append((np.asarray(out['diff']), np.asarray(out['rms'])))
    t = tp.SubtractDetectPipeline(tp.PipelineConfig(**KW))(
        *inputs.to_torch(args, 'cpu'))
    return planted, j, jpert, {k: v.numpy() for k, v in t.items()}


def test_pipeline_ref_rms_mesh(mesh_runs):
    planted, j, jpert, t = mesh_runs
    assert set(t) == set(j)
    np.testing.assert_array_equal(t['submask'], j['submask'])
    ok = j['submask'] == 0
    q = [50, 90, 99, 100]
    own = np.max([np.percentile((np.abs(p - j['diff']) / j['rms'])[ok], q)
                  for p, _ in jpert], axis=0)
    port = np.percentile((np.abs(t['diff'] - j['diff']) / j['rms'])[ok], q)
    assert port[0] < 0.01
    assert (port <= 2.0 * own).all(), (port, own)
    # the noise map carries sum(K^2) of the fitted kernels, which move
    # with the fit: within twice the reference's own spread, and 2e-3
    own_rms = max(np.abs(r / j['rms'] - 1)[ok].max() for _, r in jpert)
    port_rms = np.abs(t['rms'] / j['rms'] - 1)[ok].max()
    assert port_rms <= max(2.0 * own_rms, 1e-5) and port_rms < 2e-3, (
        port_rms, own_rms)
    np.testing.assert_array_equal(t['rms'][~ok], j['rms'][~ok])
    assert (np.abs(t['det_n'] - j['det_n']) <= 1).all()
    for b in range(2):
        v = t['det_valid'][b]
        for px, py in planted[b]:
            assert np.hypot(t['det_x'][b][v] - px,
                            t['det_y'][b][v] - py).min() < 1.0


def test_pipeline_ref_rms_mesh_changes_the_noise(mesh_runs):
    _, j, _, t = mesh_runs
    args = inputs.plant_sources(
        inputs.synth_inputs(2, H, W, tp.PipelineConfig(**KW), seed=0),
        n=3, flux=2e4, seed=1)[0]
    base = tp.SubtractDetectPipeline(tp.PipelineConfig(
        **{**KW, 'ref_rms_mesh': False}))(*inputs.to_torch(args, 'cpu'))
    ok = t['submask'] == 0
    assert not np.allclose(base['rms'].numpy()[ok], t['rms'][ok], rtol=1e-4)


# ---- host helpers -----------------------------------------------------------

def test_quick_background_estimate_equal():
    rng = np.random.default_rng(6)
    data = rng.normal(150, 5, (64, 64)).astype('f4')
    data[3, 4] = np.nan
    bad = rng.random((64, 64)) < 0.1
    data[bad] += 400
    assert tutils.quick_background_estimate(data) == \
        jutils.quick_background_estimate(data)
    mask = SimpleNamespace(boolean=SimpleNamespace(data=bad))
    img = SimpleNamespace(data=data)
    # with a mask the reference reads an ndarray's buffer attribute and
    # raises (ROADMAP section 3); the port gives the reference's estimate
    # of the unmasked pixels
    with pytest.raises(AttributeError, match='memoryview'):
        jutils.quick_background_estimate(img, mask_image=mask)
    got = tutils.quick_background_estimate(img, mask_image=mask)
    assert got == jutils.quick_background_estimate(data[~bad])
    assert got == tutils.quick_background_estimate(data, mask_image=bad)
    assert abs(got[0] - 150) < 1 and abs(got[1] - 5) < 1


# ---- the per-pair chain on files --------------------------------------------

SCALE = 1.01 / 3600.0
NSTARS = 30
TRUTH = (130.25, 140.75, 30000.0)
PKG = {'jax': (JHeader, JHDU, jwrite, JWCS, JSci, JRef),
       'torch': (THeader, THDU, twrite, TWCS, TSci, TRef)}


def write_scene(d, pkg, sci_gain=1.0):
    """tests/test_pipeline_e2e.py's pair at 256^2 in directory ``d``,
    written by ``pkg``'s own FITS writer. ``sci_gain`` scales the science
    pixels (the reference's own spread)."""
    header_cls, hdu_cls, write, wcs_cls = PKG[pkg][:4]
    rng = np.random.default_rng(42)
    xs = rng.uniform(20, W - 20, NSTARS)
    ys = rng.uniform(20, H - 20, NSTARS)
    fluxes = rng.uniform(5000, 80000, NSTARS)
    wcs_sci = wcs_cls.simple(crval=(150.1, 35.2),
                             crpix=(W / 2 + 0.5, H / 2 + 0.5),
                             scale_deg=SCALE)
    wcs_ref = wcs_cls.simple(crval=(150.1, 35.2),
                             crpix=(W / 2 + 4.6, H / 2 - 3.2),
                             scale_deg=SCALE, rot_deg=0.03)
    ra, dec = wcs_sci.pix2sky_0(xs, ys)
    rx, ry = wcs_ref.sky2pix_0(ra, dec)
    yy, xx = np.mgrid[0:H, 0:W]

    def render(px, py, seeing, transient=None):
        s = seeing / 2.355
        img = np.full((H, W), 150.0)
        pts = list(zip(px, py, fluxes)) + ([transient] if transient else [])
        for x, y, f in pts:
            img += f / (2 * np.pi * s * s) * np.exp(
                -((xx - x) ** 2 + (yy - y) ** 2) / (2 * s * s))
        img += rng.normal(0, 5.0, (H, W))
        return img.astype('f4')

    def write_frame(path, data, wcs, mjd, seeing):
        h = header_cls()
        wcs.to_header(h)
        for k, v in dict(MAGZP=26.3, OBSMJD=mjd, OBSJD=mjd + 2400000.5,
                         FIELDID=679, CCDID=1, QID=2, FILTERID=2,
                         SATURATE=60000.0, SEEING=seeing).items():
            h.set(k, v)
        h.set('FILENAME', 'ztf_20180815000000_000679_zr_c01_o_q2_sciimg.fits')
        write(path, [hdu_cls(h, data)])
        write(path.replace('sciimg', 'mskimg'),
              [hdu_cls(h.copy(), np.zeros(data.shape, np.uint16))])

    os.makedirs(d, exist_ok=True)
    sci = render(xs, ys, 2.3, TRUTH)
    write_frame(f'{d}/ztf_sci_sciimg.fits',
                (sci * np.float32(sci_gain)).astype('f4'), wcs_sci, 58345.25,
                2.3)
    write_frame(f'{d}/ztf_ref_sciimg.fits', render(rx, ry, 1.6), wcs_ref,
                58300.0, 1.6)
    return f'{d}/ztf_sci_sciimg.fits', f'{d}/ztf_ref_sciimg.fits'


def load_pair(pkg, paths):
    sci_cls, ref_cls = PKG[pkg][4:]
    sci, ref = sci_cls.from_file(paths[0]), ref_cls.from_file(paths[1])
    if pkg == 'torch':
        sci.device = ref.device = 'cpu'
    return sci, ref


@pytest.fixture(scope='module')
def pair_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp('pairs')
    return {k: write_scene(str(d / k), pkg, gain) for k, pkg, gain in (
        ('jax', 'jax', 1.0), ('torch', 'torch', 1.0),
        ('jpert', 'jax', 1.0 + 1e-7), ('jdo', 'jax', 1.0),
        ('tdo', 'torch', 1.0), ('tmain', 'torch', 1.0),
        ('jml', 'jax', 1.0), ('tml', 'torch', 1.0),
        ('jzogy', 'jax', 1.0), ('tzogy', 'torch', 1.0))}


@pytest.fixture(scope='module')
def subs(pair_dirs):
    """from_images at nreg_side=1, spatial_order=1 in both packages, and
    the reference again on a science frame scaled by 1 + 1e-7."""
    out = {}
    for key, pkg in (('jax', 'jax'), ('jpert', 'jax'), ('torch', 'torch')):
        sci, ref = load_pair(pkg, pair_dirs[key])
        cls, kw = ((JSub, {}) if pkg == 'jax' else (TSub, {'device': 'cpu'}))
        out[key] = (cls.from_images(sci, ref, nreg_side=1, spatial_order=1,
                                    **kw), sci, ref)
    return out


def test_prepare_hotpants_equal(pair_dirs):
    jsci, jref = load_pair('jax', pair_dirs['jax'])
    tsci, tref = load_pair('torch', pair_dirs['torch'])
    masked = thot.prepare_hotpants(tsci, tref)
    # the reference's background estimate raises for a frame with a mask
    # (test_quick_background_estimate_equal): compare without one
    jsci.mask_image = tsci.mask_image = None
    want = jhot.prepare_hotpants(jsci, jref, hotpants_kws={'ko': 2})
    got = thot.prepare_hotpants(tsci, tref, hotpants_kws={'ko': 2})
    assert got == want and got['ko'] == 2 and got['nrx'] == 3
    assert masked == {**got, 'ko': 4}       # the scene's mask is empty
    assert got['r'] == 2.5 * 2.3 and got['il'] < 150 < got['tu']
    assert list(inspect.signature(thot.prepare_hotpants).parameters) == \
        list(inspect.signature(jhot.prepare_hotpants).parameters)


def test_from_images_header_mask_and_files(subs, pair_dirs):
    (jsub, jsci, _), (tsub, tsci, tref) = subs['jax'], subs['torch']
    assert isinstance(tsub, TSub) and tsub.basename == jsub.basename
    assert tsub.basename == 'sub.ztf_sci_sciimg_ztf_ref_sciimg.fits'
    for key in ('SUBMETH', 'SUBKO', 'SUBNRX', 'SEEING', 'MAGZP', 'FIELDID',
                'OBSMJD'):
        assert tsub.header[key] == jsub.header[key], key
    assert tsub.header['SUBMETH'] == 'hotpants'
    # 26 stamps for 50 unknowns per order-0 region: the guard lowers the
    # order from 1 to 0
    assert (tsub.header['SUBKO'], tsub.header['SUBNRX']) == (0, 1)
    tm, jm = tsub.mask_image.data, np.asarray(jsub.mask_image.data)
    assert tm.dtype == np.int32
    np.testing.assert_array_equal(tm, jm)
    td = tsub.data
    np.testing.assert_array_equal((tm >> 17 & 1) == 1, td == SENTINEL)
    assert 0 < (tm >> 16 & 1).sum() < 0.1 * tm.size
    assert tsub.target_image is tsci and tsub.reference_image is tref
    assert tsub.mjd == jsub.mjd == 58345.25
    assert tsub.field == 679 and tsub.ra == pytest.approx(150.1, abs=1e-6)
    for kind in ('jax', 'torch'):
        d = os.path.dirname(pair_dirs[kind][0])
        assert sorted(os.listdir(d)) == sorted(
            os.listdir(os.path.dirname(pair_dirs['jax'][0])))
    back = TSub.from_file(tsub.local_path)
    np.testing.assert_array_equal(back.data, td)
    assert os.path.exists(tsub.local_path.replace('.fits', '.mask.fits'))
    np.testing.assert_allclose(tsub.rms_image.data,
                               np.asarray(jsub.rms_image.data), rtol=1e-4)


def test_from_images_aligned_reference(subs):
    (_, jsci, jref), (_, tsci, tref) = subs['jax'], subs['torch']
    ja, ta = jref.aligned_to(jsci), tref.aligned_to(tsci)
    np.testing.assert_array_equal(ta.coverage, np.asarray(ja.coverage))
    # the warp contract, plus what a 2e-4 px shift of the mapping moves:
    # the two packages' bilinear upsamples of the grid differ by up to
    # 1e-4 px (XLA contracts a*b + c, tests/test_torch_resample.py)
    want = np.asarray(ja.data)
    gy, gx = np.gradient(want)
    tol = 5e-3 + 3e-5 * np.abs(want) + 2e-4 * (np.abs(gx) + np.abs(gy))
    assert (np.abs(ta.data - want) <= tol).all()
    assert np.abs(ta.data - want).max() < 0.5
    jm = jref.mask_image.aligned_to(jsci)
    tm = tref.mask_image.aligned_to(tsci, device='cpu')
    np.testing.assert_array_equal(tm.data, np.asarray(jm.data))


def test_from_images_diff_within_reference_spread(subs):
    jsub, jpert, tsub = (subs[k][0] for k in ('jax', 'jpert', 'torch'))
    jd, jr_ = np.asarray(jsub.data), np.asarray(jsub.rms_image.data)
    ok = np.asarray(jsub.mask_image.data) == 0
    q = [50, 90, 99, 100]
    own = np.percentile((np.abs(np.asarray(jpert.data) - jd) / jr_)[ok], q)
    port = np.percentile((np.abs(tsub.data - jd) / jr_)[ok], q)
    assert port[0] < 0.01
    assert (port <= 2.0 * own).all(), (port, own)


def test_from_images_recovers_the_transient(subs):
    tx, ty, tf = TRUTH
    for key in ('jax', 'torch'):
        d = np.asarray(subs[key][0].data)
        box = d[int(ty) - 7:int(ty) + 8, int(tx) - 7:int(tx) + 8]
        assert box.sum() == pytest.approx(tf, rel=0.15), key
        inner = d[32:-32, 32:-32]
        sig = 1.4826 * np.median(np.abs(inner - np.median(inner)))
        assert sig < 12.5, key


def test_from_images_signature_and_waiting_options(subs, zogy_subs):
    _, tsci, tref = subs['torch']
    jpar = list(inspect.signature(JSub.from_images).parameters)
    tpar = list(inspect.signature(TSub.from_images).parameters)
    assert tpar[:len(jpar) - 1] == jpar[:-1]
    assert tpar[len(jpar) - 1:] == ['device', 'stats', 'kwargs']
    jasm = list(inspect.signature(JSub.assemble).parameters)
    tasm = list(inspect.signature(TSub.assemble).parameters)
    assert tasm == jasm + ['device']
    with pytest.raises(NotImplementedError, match='item 5'):
        TSub.from_images(tsci, tref, device='cpu', data_product=True)
    # method='zogy' runs (the zogy_subs fixture): a product with a score
    zsub = zogy_subs['torch'][0]
    assert isinstance(zsub, TSub) and zsub.header['SUBMETH'] == 'zogy'
    assert zsub.scorr_image.data.shape == zsub.data.shape
    with pytest.raises(ValueError, match='method'):
        TSub.from_images(tsci, tref, device='cpu', method='sfft')
    with pytest.raises(NotImplementedError, match='item 5'):
        tsubtraction.overlapping_subtractions(tsci, tref)


# ---- from_images(method='zogy') --------------------------------------------

@pytest.fixture(scope='module')
def zogy_subs(pair_dirs):
    """from_images(method='zogy') in both packages on the scene at its
    defaults (the guard lowers the order as for hotpants)."""
    out = {}
    for key, pkg in (('jzogy', 'jax'), ('tzogy', 'torch')):
        sci, ref = load_pair(pkg, pair_dirs[key])
        if pkg == 'jax':
            out[pkg] = (JSub.from_images(sci, ref, method='zogy'), sci, ref,
                        None)
        else:
            stats = {}
            out[pkg] = (TSub.from_images(sci, ref, method='zogy',
                                         device='cpu', stats=stats),
                        sci, ref, stats)
    return out


def test_zogy_from_images_products(zogy_subs, pair_dirs):
    (jsub, _, _, _), (tsub, tsci, tref, stats) = (zogy_subs['jax'],
                                                  zogy_subs['torch'])
    assert tsub.basename == jsub.basename
    assert tsub.scorr_image.basename == jsub.scorr_image.basename == \
        'sub.ztf_sci_sciimg_ztf_ref_sciimg.scorr.fits'
    assert tsub.mask_image.basename == jsub.mask_image.basename
    for key in ('SUBMETH', 'SUBKO', 'SUBNRX', 'SEEING', 'MAGZP', 'FIELDID',
                'OBSMJD'):
        assert tsub.header[key] == jsub.header[key], key
        assert tsub.scorr_image.header[key] == jsub.scorr_image.header[key]
    assert tsub.header['SUBMETH'] == 'zogy'
    assert tsub.target_image is tsci and tsub.reference_image is tref
    tm, jm = tsub.mask_image.data, np.asarray(jsub.mask_image.data)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal((tm >> 17 & 1) == 1, tsub.data == SENTINEL)
    assert 0 < (tm >> 16 & 1).sum() < 0.1 * tm.size
    np.testing.assert_allclose(tsub.rms_image.data,
                               np.asarray(jsub.rms_image.data), rtol=1e-6)
    assert tsub.scorr_image.data.dtype == np.float32
    d = os.path.dirname(pair_dirs['tzogy'][0])
    assert sorted(os.listdir(d)) == sorted(
        os.listdir(os.path.dirname(pair_dirs['jzogy'][0])))
    np.testing.assert_array_equal(TSub.from_file(tsub.local_path).data,
                                  tsub.data)
    assert {'align_s', 'products_s', 'psf_s', 'zogy_s',
            'assemble_s'} <= set(stats)
    assert 'fit_s' not in stats


def test_zogy_from_images_recovers_the_transient(zogy_subs):
    """tests/test_pipeline_e2e.py::test_zogy_path's check, in both."""
    tx, ty, _ = TRUTH
    for pkg in ('jax', 'torch'):
        s = np.asarray(zogy_subs[pkg][0].scorr_image.data)
        assert s[int(ty) - 2:int(ty) + 3, int(tx) - 2:int(tx) + 3].max() \
            > 10.0, pkg


def test_zogy_from_images_matches_the_reference_engine(zogy_subs):
    """The JAX package's PSF estimate and zogy_subtract, and the
    reference's host steps, on the port's own inputs."""
    tsub, tsci, tref, _ = zogy_subs['torch']
    scimbkg = np.ascontiguousarray(
        tsci.background_subtracted_image.data).astype(np.float32) + BKG_VAL
    new = scimbkg - BKG_VAL
    refdata = np.ascontiguousarray(
        tref.aligned_to(tsci, device='cpu').data, 'f4')
    sci_rms = np.ascontiguousarray(tsci.rms_image.data, 'f4')
    ref_rms = np.ascontiguousarray(
        tref.rms_image.aligned_to(tsci, device='cpu').data, 'f4')
    bad = (tsub.mask_image.data & BAD_SUM) > 0
    xs, ys, valid = tsubtraction._select_stamps(tsci, smax=64)
    assert valid.sum() >= 10
    pos = [jnp.asarray(a) for a in (xs, ys, valid)]
    jpsf = [jz.estimate_psf_from_stars(jnp.asarray(a), *pos)
            for a in (new, refdata)]
    sn = float(np.median(sci_rms[~bad]))
    sr = max(float(np.median(ref_rms[~bad])), 1e-3)
    jout = jz.zogy_subtract(jnp.asarray(new), jnp.asarray(refdata), *jpsf,
                            sn, sr)
    tpos = [torch.as_tensor(a) for a in (xs, ys, valid)]
    tpsf = [tz.estimate_psf_from_stars(torch.as_tensor(a), *tpos)
            for a in (new, refdata)]
    for a, b in zip(tpsf, jpsf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-7)
    f64 = tz.zogy_subtract_plain(
        *(torch.as_tensor(a).double() for a in (new, refdata, *tpsf)), sn,
        sr)
    ok = ~bad
    want64 = f64['d'].numpy()
    port_err = np.abs(tsub.data - want64)[ok].max()
    jax_err = np.abs(np.asarray(jout['d']) - want64)[ok].max()
    assert port_err <= 2 * jax_err + 1e-3, (port_err, jax_err)
    np.testing.assert_array_equal(tsub.data[bad], SENTINEL)
    np.testing.assert_allclose(tsub.scorr_image.data,
                               np.asarray(jout['s_corr']), rtol=0, atol=1e-3)
    rms = np.sqrt(sci_rms ** 2 + ref_rms ** 2)
    rms[bad] = BIG_RMS
    np.testing.assert_array_equal(tsub.rms_image.data, rms)


def test_zogy_from_images_against_the_reference(zogy_subs):
    """diff and scorr_image against the JAX package's own product: they
    agree where the two aligned references do; at the star cores those
    differ by up to ~0.26 counts (the warp contract and the mappings'
    2e-4 px), which moves both there."""
    jsub, tsub = zogy_subs['jax'][0], zogy_subs['torch'][0]
    ok = tsub.mask_image.data == 0
    for t, j in ((tsub.data, jsub.data),
                 (tsub.scorr_image.data, jsub.scorr_image.data)):
        err = np.abs(t - np.asarray(j))[ok]
        assert np.percentile(err, 99) < 5e-3 and err.max() < 0.1, (
            np.percentile(err, 99), err.max())


def _rows_match(trows, jrows):
    assert len(trows) == len(jrows)
    order_t = np.argsort(trows['X_IMAGE'])
    order_j = np.argsort(np.asarray(jrows['X_IMAGE']))
    for a, b in zip(trows[order_t], np.asarray(jrows)[order_j]):
        assert abs(a['X_IMAGE'] - b['X_IMAGE']) < 0.02
        assert abs(a['Y_IMAGE'] - b['Y_IMAGE']) < 0.02
        np.testing.assert_allclose(a['FLUX_APER'], b['FLUX_APER'], rtol=2e-3)


@pytest.fixture(scope='module')
def reference_do_one(pair_dirs):
    sub, dets = jdosub.do_one(' '.join(pair_dirs['jdo']), ml=False)
    cat = sub.catalog.data
    return sub, cat[cat['GOODCUT'] == 1], dets


def test_do_one_goodcut_rows(pair_dirs, reference_do_one):
    jsub, jrows, jdets = reference_do_one
    stats = {}
    tsub, trows = tsubmod.do_one(' '.join(pair_dirs['tdo']), ml=False,
                                 device='cpu', stats=stats)
    assert len(jdets) == len(jrows) >= 1
    _rows_match(trows, jrows)
    tx, ty, _ = TRUTH
    assert np.hypot(trows['X_IMAGE'] - 1 - tx,
                    trows['Y_IMAGE'] - 1 - ty).min() < 1.0
    for key in ('SUBKO', 'SUBNRX', 'SUBMETH'):
        assert tsub.header[key] == jsub.header[key]
    d = os.path.dirname(pair_dirs['tdo'][0])
    assert sorted(os.listdir(d)) == sorted(
        os.listdir(os.path.dirname(pair_dirs['jdo'][0])))
    assert os.path.exists(f'{d}/sub.ztf_sci_sciimg_ztf_ref_sciimg.cat')
    assert {'load_s', 'align_s', 'products_s', 'fit_s', 'subtract_s',
            'assemble_s', 'catalog_s', 'filter_s'} <= set(stats)
    assert list(inspect.signature(tsubmod.do_one).parameters)[:3] == \
        list(inspect.signature(jdosub.do_one).parameters)
    assert inspect.signature(tsubmod.do_one).parameters['ml'].default is \
        inspect.signature(jdosub.do_one).parameters['ml'].default is True
    assert tsubmod.MAX_DETS == jdosub.MAX_DETS


def test_do_one_scores_like_the_reference(pair_dirs, tmp_path, monkeypatch):
    """do_one at ml=True in both packages, both load_model_helper reading
    one npz of spread weights: the same GOODCUT rows (as at ml=False), the
    same rows scored, the scores within 1e-4 (the triplets come from the
    two packages' subtractions, which agree within the fit's ulp spread,
    and their aligns); the transient's row scored."""
    from zuds_tpu import filterobjects as jfilter
    from zuds_tpu.models import braai as jbraai
    from zuds_tpu_torch import filterobjects as tfilter
    from zuds_tpu_torch.inputs import spread_braai
    from zuds_tpu_torch.models import braai as tbraai
    model, _ = tbraai.init_braai(0, device='cpu')
    weights = str(tmp_path / 'braai_d6_m9.npz')
    tbraai.save_braai(spread_braai(model.params()), weights)
    monkeypatch.setattr(jfilter, 'load_model_helper',
                        lambda *a, **k: jbraai.load_braai(weights))
    monkeypatch.setattr(tfilter, 'load_model_helper',
                        lambda *a, **k: tbraai.load_braai(
                            weights, device=k.get('device')))
    jsub, jdets = jdosub.do_one(' '.join(pair_dirs['jml']))
    stats = {}
    tsub, tdets = tsubmod.do_one(' '.join(pair_dirs['tml']), device='cpu',
                                 stats=stats)
    jcat, tcat = jsub.catalog.data, tsub.catalog.data
    assert len(jdets) == len(tdets)
    _rows_match(tdets, jcat[jcat['GOODCUT'] == 1])
    scored = tcat['RB'] != -99
    assert stats['scored'] == int(scored.sum()) >= 1
    assert stats['ml_s'] > 0
    assert scored.sum() == (jcat['RB'] != -99).sum()
    _rows_match(tcat[scored], jcat[jcat['RB'] != -99])
    order_t = np.argsort(tcat['X_IMAGE'][scored])
    order_j = np.argsort(jcat['X_IMAGE'][jcat['RB'] != -99])
    np.testing.assert_allclose(tcat['RB'][scored][order_t],
                               jcat['RB'][jcat['RB'] != -99][order_j],
                               rtol=0, atol=1e-4)
    assert np.array_equal(tcat['GOODCUT'] == 1,
                          scored & (tcat['RB'] >= np.float32(0.3)))
    tx, ty, _ = TRUTH
    near = np.hypot(tcat['X_IMAGE'] - 1 - tx, tcat['Y_IMAGE'] - 1 - ty)
    assert near.min() < 1.0 and scored[near.argmin()]


def test_sub_main_runs_a_worklist(pair_dirs, reference_do_one, tmp_path,
                                  monkeypatch):
    """``python -m zuds_tpu_torch.sub``'s ``main`` means the card; with the
    device resolved to the CPU it runs a work list, skips a broken line and
    says so in its exit code."""
    monkeypatch.setattr(inputs, 'resolve_device',
                        lambda device: torch.device(device or 'cpu'))
    monkeypatch.delenv('OMPI_COMM_WORLD_RANK', raising=False)
    good = tmp_path / 'work.txt'
    good.write_text(' '.join(pair_dirs['tmain']) + '\n')
    assert tsubmod.main(['sub', str(good)]) == 0
    d = os.path.dirname(pair_dirs['tmain'][0])
    from zuds_tpu_torch.catalog import PipelineFITSCatalog
    cat = PipelineFITSCatalog.from_file(
        f'{d}/sub.ztf_sci_sciimg_ztf_ref_sciimg.cat').data
    _rows_match(cat[cat['GOODCUT'] == 1], reference_do_one[1])
    broken = tmp_path / 'broken.txt'
    broken.write_text(f'{tmp_path}/missing_sciimg.fits {tmp_path}/none.fits\n')
    assert tsubmod.main(['sub', str(broken)]) == 1
    assert tsubmod.main(['sub']) == 2


# ---- a stack of subtractions ------------------------------------------------

@pytest.fixture(scope='module')
def multi(tmp_path_factory):
    """Three dithered epochs of one 256^2 field (the port's writer; the
    codecs read each other's files): two make the science stack, the third
    is the reference; one subtraction per epoch, then their stack."""
    import shutil
    base = tmp_path_factory.mktemp('multi')
    src = base / 'src'
    src.mkdir()
    inputs.write_coadd_epochs(str(src), 3, H, W, seed=17, nstars=30)
    out = {}
    for pkg, sci_cls, ref_cls, stack_cls, sub_cls, multi_cls, kw in (
            ('jax', JSci, JRef, JStack, JSub, JMulti, {}),
            ('torch', TSci, TRef, TStack, TSub, TMulti, {'device': 'cpu'})):
        d = base / pkg
        shutil.copytree(src, d)
        epochs = [sci_cls.from_file(str(d / f'ep{i}_sciimg.fits'))
                  for i in range(2)]
        ref = ref_cls.from_file(str(d / 'ep2_sciimg.fits'))
        for im in epochs + [ref]:
            if pkg == 'torch':
                im.device = 'cpu'
        stack = stack_cls.from_images(epochs, str(d / 'stack.fits'),
                                      calculate_seeing=False, **kw)
        stack.header.set('SEEING', 2.0)
        subs = [sub_cls.from_images(e, ref, nreg_side=1, spatial_order=0,
                                    **kw) for e in epochs]
        out[pkg] = (multi_cls.from_images(stack, ref,
                                          input_subtractions=subs, **kw),
                    stack, ref, subs)
    return out


def test_multi_epoch_subtraction(multi):
    (jm, jstack, _, jsubs), (tm, tstack, tref, tsubs) = (multi['jax'],
                                                         multi['torch'])
    assert isinstance(tm, TMulti) and tm.basename == jm.basename
    assert tm.basename == 'sub.stack_ep2_sciimg.fits'
    assert tm.reference_image is tref and tm.target_image is tstack
    assert tm.input_images == tsubs
    for key in ('SEEING', 'NCOADD', 'MAGZP', 'NAXIS1', 'NAXIS2'):
        assert tm.header[key] == jm.header[key], key
    assert tm.header['SEEING'] == 2.0 and tm.header['NCOADD'] == 2
    jd, td = np.asarray(jm.data), tm.data
    assert td.shape == jd.shape
    tmask, jmask = tm.mask_image.data, np.asarray(jm.mask_image.data)
    np.testing.assert_array_equal(tmask, jmask)
    ok = tmask == 0
    # no background added back: a difference stack sits at 0
    assert abs(np.median(td[ok])) < 1.0
    rms = 1.4826 * np.median(np.abs(jd[ok] - np.median(jd[ok])))
    far = np.abs(td - jd)[ok] > 0.05 * rms
    assert far.mean() <= 1e-3, far.mean()
    # the weights carry the fitted kernels' sum of squares; a pixel whose
    # clip decision differs has another weight altogether
    jw = np.asarray(jm.weight_image.data)[ok]
    wfar = np.abs(tm.weight_image.data[ok] - jw) > 5e-3 * jw
    assert wfar.mean() <= 1e-3, wfar.mean()
    assert os.path.exists(tm.local_path)
    back = TMulti.from_file(tm.local_path)
    np.testing.assert_array_equal(back.data, td)


def test_multi_epoch_subtraction_checks_its_inputs(multi):
    tm, tstack, tref, tsubs = multi['torch']
    with pytest.raises(TypeError, match='ScienceCoadd'):
        TMulti.from_images(tsubs[0].target_image, tref,
                           input_subtractions=tsubs, device='cpu')
    with pytest.raises(ValueError, match='1 vs 2'):
        TMulti.from_images(tstack, tref, input_subtractions=tsubs[:1],
                           device='cpu')
    with pytest.raises(NotImplementedError, match='item 5'):
        TMulti.from_images(tstack, tref, device='cpu')
    jpar = list(inspect.signature(JMulti.from_images).parameters)
    tpar = list(inspect.signature(TMulti.from_images).parameters)
    assert tpar == jpar[:-1] + ['device', 'kwargs']
