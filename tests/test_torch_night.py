"""The port's host feed and night driver against the JAX package on the
CPU, on ``tests/test_donight.py``'s scene at 256^2: 20 stars, a reference
whose WCS is dithered by (+9.6, -6.2) px (so the integer pre-roll runs), two
science frames with a planted transient each, one without ``SEEING`` (so
the stamp moments set it), uint16 ``mskimg`` siblings.

Tolerances:
- ``prepare_frame_inputs``: frames, masks, grids, coverage bounds and
  stamps bit-equal; the kernel basis bit-equal where SEEING comes from the
  header, and rtol 1e-5 with atol 1e-5 of the table's largest entry (its
  odd moments sum to ~1e-16) where it comes from the stamp moments (those
  agree to 1e-6 relative, tests/test_torch_measure.py);
- the catalog and ``filter_sexcat`` from the same numpy pipeline outputs:
  every column and GOODCUT bit-equal (NaN equal to NaN); where the filter
  reads the frames instead of the pipeline's columns, its r=6 aperture
  sums BPMCUT and RMSCUT to rtol 1e-5 and 1e-4 absolute (225 products
  added in another order than the reference's vmapped sum, and the
  circle-pixel overlap of a pixel that misses the circle comes out as
  +-1 ulp of ~7 px^2 on either side, ROADMAP section 3) and GOODCUT still
  bit-equal;
- ``run_night``: each transient a catalog row within 2 px in both
  packages, the same product names, and the per-frame GOODCUT counts
  within the reference's own spread under 1e-7 relative perturbations of
  the science frame. The frame with SEEING keeps its transient as a
  GOODCUT row. The frame without it does not, in either package: the
  reference's stamp-moment FWHM keeps the positive noise of each 25x25
  stamp and reads ~4.6 px on this 2.3 px frame, and the sharp cut
  (FWHM >= 0.8 SEEING) then removes the transient.
"""
import glob
import inspect
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'scripts'))

import donight as jnight  # noqa: E402
from zuds_tpu import catalog as jcatalog  # noqa: E402
from zuds_tpu import filterobjects as jfilter  # noqa: E402
from zuds_tpu import subtraction as jsub  # noqa: E402
from zuds_tpu.coadd import ReferenceImage as JRef  # noqa: E402
from zuds_tpu.fits import read_fits as jread  # noqa: E402
from zuds_tpu.image import ScienceImage as JSci  # noqa: E402
from zuds_tpu.parallel import pipeline as jp  # noqa: E402
from zuds_tpu_torch import catalog as tcatalog  # noqa: E402
from zuds_tpu_torch import filterobjects as tfilter  # noqa: E402
from zuds_tpu_torch import night as tnight  # noqa: E402
from zuds_tpu_torch import subtraction as tsub  # noqa: E402
from zuds_tpu_torch.coadd import ReferenceImage as TRef  # noqa: E402
from zuds_tpu_torch.fits import HDU, Header, read_fits, write_fits  # noqa
from zuds_tpu_torch.image import ScienceImage as TSci  # noqa: E402
from zuds_tpu_torch.inputs import INPUT_NAMES  # noqa: E402
from zuds_tpu_torch.parallel import pipeline as tp  # noqa: E402
from zuds_tpu_torch.wcs import TPVWCS  # noqa: E402

torch.set_num_threads(2)

H = W = 256
SCALE = 1.01 / 3600.0
KW = dict(height=H, width=W, ksize=9, stamp=25, smax=36, order=1, nreg=1,
          max_det=384, box=64)
TRANSIENT_FLUX = 25000.0


def render(xs, ys, fluxes, seeing, rng, transient=None):
    yy, xx = np.mgrid[0:H, 0:W]
    s = seeing / 2.355
    img = np.full((H, W), 150.0)
    pts = list(zip(xs, ys, fluxes)) + ([transient] if transient else [])
    for x, y, f in pts:
        img += f / (2 * np.pi * s * s) * np.exp(
            -((xx - x) ** 2 + (yy - y) ** 2) / (2 * s * s))
    img += rng.normal(0, 5.0, (H, W))
    return img.astype('f4')


def write_pair_frame(path, data, wcs, mjd, seeing=None):
    h = Header()
    wcs.to_header(h)
    for k, v in dict(MAGZP=26.3, OBSMJD=mjd, OBSJD=mjd + 2400000.5,
                     FIELDID=679, CCDID=1, QID=2, FILTERID=2,
                     SATURATE=60000.0).items():
        h.set(k, v)
    h.set('FILENAME', 'ztf_20180815000000_000679_zr_c01_o_q2_sciimg.fits')
    if seeing:
        h.set('SEEING', seeing)
    write_fits(path, [HDU(h, data)])
    write_fits(path.replace('sciimg', 'mskimg'),
               [HDU(h.copy(), np.zeros(data.shape, np.uint16))])


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp('night')
    xs = rng.uniform(20, W - 20, 20)
    ys = rng.uniform(20, H - 20, 20)
    fluxes = rng.uniform(5000, 80000, 20)
    wcs_sci = TPVWCS.simple(crval=(150.1, 35.2), crpix=(W / 2 + 0.5,
                                                        H / 2 + 0.5),
                            scale_deg=SCALE)
    refs = {'dither': (9.6, -6.2, 0.0), 'near': (0.6, -0.4, 0.0),
            'rotated': (0.0, 0.0, 2.0)}
    for name, (dx, dy, rot) in refs.items():
        wcs_ref = TPVWCS.simple(crval=(150.1, 35.2),
                                crpix=(W / 2 + 0.5 + dx, H / 2 + 0.5 + dy),
                                scale_deg=SCALE, rot_deg=rot)
        ra, dec = wcs_sci.pix2sky_0(xs, ys)
        rx, ry = wcs_ref.sky2pix_0(ra, dec)
        write_pair_frame(str(d / f'ztf_{name}_ref_sciimg.fits'),
                         render(rx, ry, fluxes, 1.6, rng), wcs_ref, 58300.0,
                         seeing=1.6)
    transients = []
    for i, (tx, ty) in enumerate([(60.0, 200.0), (200.0, 100.0)]):
        while np.hypot(xs - tx, ys - ty).min() < 20:
            tx += 9.0
        transients.append((tx, ty))
        write_pair_frame(str(d / f'ztf_night{i}_sciimg.fits'),
                         render(xs, ys, fluxes, 2.3, rng,
                                (tx, ty, TRANSIENT_FLUX)),
                         wcs_sci, 58345.0 + 0.01 * i,
                         seeing=2.3 if i == 0 else None)
    return d, np.asarray(transients)


def load(pkg, d, i, ref='dither'):
    """(sci, ref) image objects of pair ``i`` read by ``pkg``'s driver."""
    mod = {'jax': jnight, 'torch': tnight}[pkg]
    sci_cls, ref_cls = {'jax': (JSci, JRef), 'torch': (TSci, TRef)}[pkg]
    read = (lambda p: next(h for h in read_fits(p) if h.data is not None))
    sp = str(d / f'ztf_night{i}_sciimg.fits')
    rp = str(d / f'ztf_{ref}_ref_sciimg.fits')
    sci = mod._image_from_hdu(sci_cls, sp, read(sp),
                              read(sp.replace('sciimg', 'mskimg')))
    refi = mod._image_from_hdu(ref_cls, rp, read(rp),
                               read(rp.replace('sciimg', 'mskimg')))
    return sci, refi


def star_catalog(img):
    """A small structured catalog of the brightest pixels of ``img``, for
    the catalog branch of the stamp choice."""
    flat = np.argsort(img.ravel())[::-1][:40]
    cat = np.zeros(40, dtype=tcatalog.CATALOG_DTYPE)
    cat['X_IMAGE'] = flat % W + 1.0
    cat['Y_IMAGE'] = flat // W + 1.0
    cat['FLUX_APER'] = img.ravel()[flat] * 10
    cat['FLUXERR_APER'] = 1.0
    cat['FLUX_MAX'] = np.linspace(100, 9000, 40)
    cat['ELONGATION'] = 1.1
    cat['FWHM_IMAGE'] = np.linspace(2.0, 2.6, 40)
    return cat


@pytest.mark.parametrize('i,ref,cache,catalog', [
    (0, 'dither', False, False), (0, 'dither', True, False),
    (1, 'dither', True, False), (1, 'near', False, False),
    (1, 'near', True, True), (0, 'dither', True, True)])
def test_prepare_frame_inputs_equal(scene, i, ref, cache, catalog):
    d, _ = scene
    outs = {}
    for pkg, mod in (('jax', jp), ('torch', tp)):
        sci, refi = load(pkg, d, i, ref)
        if catalog:
            sci._catalog = type('Cat', (), {
                'data': star_catalog(np.asarray(sci.data))})()
        cfg = mod.PipelineConfig(**KW)
        kw = {'ref_cache': {}} if cache else {}
        if pkg == 'torch':
            kw['device'] = 'cpu'
        res = mod.prepare_frame_inputs(sci, refi, cfg, **kw)
        if cache:   # a second pair against the cached reference
            res = mod.prepare_frame_inputs(sci, refi, cfg, **kw)
        outs[pkg] = ({k: np.asarray(v) for k, v in res.items()},
                     float(sci.header['SEEING']))
    (j, jsee), (t, tsee) = outs['jax'], outs['torch']
    assert set(t) == set(INPUT_NAMES) == set(j)
    from_header = i == 0 or catalog
    for k in INPUT_NAMES:
        a, b = j[k], t[k]
        assert a.shape == b.shape, k
        if k.startswith('basis') or k == 'b0':
            if from_header:
                np.testing.assert_array_equal(b, a, err_msg=k)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=1e-5, atol=1e-5 * np.abs(a).max(), err_msg=k)
        else:
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=k)
    if from_header:
        assert tsee == jsee
    else:
        assert abs(tsee - jsee) <= 1e-6 * jsee
    assert t['stamp_valid'].sum() > 0


def test_prepare_caches_the_reference_on_device_key(scene):
    d, _ = scene
    cache = {}
    cfg = tp.PipelineConfig(**KW)
    for i in (0, 1):
        sci, refi = load('torch', d, i)
        tp.prepare_frame_inputs(sci, refi, cfg, ref_cache=cache,
                                device='cpu')
    assert list(cache) == [str(d / 'ztf_dither_ref_sciimg.fits')]
    for n in range(6):
        sci, refi = load('torch', d, 0)
        refi.map_to_local_file(str(d / f'copy{n}_ref_sciimg.fits'))
        tp.prepare_frame_inputs(sci, refi, cfg, ref_cache=cache,
                                device='cpu')
    assert len(cache) == tp.REF_CACHE_SIZE
    assert list(cache)[0].endswith('copy2_ref_sciimg.fits')


def test_prepare_refuses_a_dither_past_the_bucket(scene):
    d, _ = scene
    for pkg, mod in (('jax', jp), ('torch', tp)):
        sci, refi = load(pkg, d, 0, 'rotated')
        kw = {'device': 'cpu'} if pkg == 'torch' else {}
        with pytest.raises(ValueError, match='max_shift'):
            mod.prepare_frame_inputs(sci, refi, mod.PipelineConfig(**KW),
                                     **kw)


@pytest.fixture(scope='module')
def pipeline_outputs(scene):
    """The JAX pipeline's outputs for both pairs as numpy (one batch),
    and the reference's GOODCUT count spread under 1e-7 relative
    perturbations of ``sci``."""
    d, _ = scene
    subdir = _subdir(d)
    cfg = jp.PipelineConfig(**KW)
    frames, seeing = [], []
    for i in (0, 1):
        sci, refi = load('jax', d, i)
        frames.append(jp.prepare_frame_inputs(sci, refi, cfg))
        seeing.append(sci.header['SEEING'])
    args = [np.stack([np.asarray(f[k]) for f in frames]) for k in INPUT_NAMES]
    fn = jp.make_subtract_detect_pipeline(cfg)

    def run(sci):
        return {k: np.asarray(v) for k, v in
                fn(jnp.asarray(sci), *(jnp.asarray(a)
                                       for a in args[1:])).items()}

    def goodcut(out):
        n = []
        for i in (0, 1):
            sci, refi = load('jax', d, i)
            sci.header.set('SEEING', seeing[i])
            sub = jsub.SingleEpochSubtraction.assemble_deferred(
                sci, refi, None, outfile_name=str(subdir / f'sub.p{i}.fits'))
            cat = jcatalog.PipelineFITSCatalog.from_pipeline(
                sub, out, frame=i, save=False)
            jfilter.filter_sexcat(cat, ml=False)
            n.append(int((cat.data['GOODCUT'] == 1).sum()))
        return np.asarray(n)

    out = run(args[0])
    base = goodcut(out)
    spread = np.zeros(2, int)
    for e in (1e-7, -1e-7, 2e-7):
        pert = goodcut(run((args[0] * np.float32(1 + e)).astype('f4')))
        spread = np.maximum(spread, np.abs(pert - base))
    return out, fn, base, spread, seeing


def _subdir(d):
    """A directory beside the scene for products the tests do not read
    back (the scene's own directory is copied for the night runs)."""
    sd = d.parent / f'{d.name}_subs'
    sd.mkdir(exist_ok=True)
    return sd


def _catalogs(scene, out, seeing, frame_branch=False):
    """Catalog + filter of both frames in both packages from the same
    numpy outputs ``out`` and SEEING values; with ``frame_branch`` the precomputed filter
    columns are cleared, so filter_sexcat reads the frames."""
    d, _ = scene
    subdir = _subdir(d)
    cats = {}
    for pkg, sub_mod, cat_mod, filt in (
            ('jax', jsub, jcatalog, jfilter),
            ('torch', tsub, tcatalog, tfilter)):
        cats[pkg] = []
        for i in (0, 1):
            sci, refi = load(pkg, d, i)
            sci.header.set('SEEING', seeing[i])

            def thunk(b=i):
                return (out['diff'][b], out['rms'][b],
                        out['submask'][b].astype(np.uint32))

            sub = sub_mod.SingleEpochSubtraction.assemble_deferred(
                sci, refi, thunk,
                outfile_name=str(subdir / f'sub.{pkg}{i}.fits'))
            cat = cat_mod.PipelineFITSCatalog.from_pipeline(
                sub, out, frame=i, save=False)
            if frame_branch:
                data = cat.data.copy()
                data['NEGPIX'] = -1
                data['BPMCUT'] = np.nan
                cat.data = data
            filt.filter_sexcat(cat, ml=False,
                               **({'device': 'cpu'} if pkg == 'torch'
                                  else {}))
            cats[pkg].append(cat)
    return cats


@pytest.mark.parametrize('frame_branch', [False, True])
def test_catalog_and_filter_bit_equal(scene, pipeline_outputs,
                                      frame_branch):
    out, seeing = pipeline_outputs[0], pipeline_outputs[4]
    cats = _catalogs(scene, out, seeing, frame_branch)
    for jc, tc in zip(cats['jax'], cats['torch']):
        assert jc.data.dtype == tc.data.dtype
        assert len(tc.data) > 0
        for name in jc.data.dtype.names:
            if frame_branch and name in ('BPMCUT', 'RMSCUT'):
                np.testing.assert_allclose(tc.data[name], jc.data[name],
                                           rtol=1e-5, atol=1e-4, err_msg=name)
            else:
                np.testing.assert_array_equal(tc.data[name], jc.data[name],
                                              err_msg=name)
        assert tc.header.keys() == jc.header.keys()
        for k in jc.header.keys():
            assert tc.header[k] == jc.header[k], k
    assert (cats['torch'][0].data['GOODCUT'] == 1).sum() >= 1


@pytest.fixture(scope='module')
def nights(scene, pipeline_outputs):
    """run_night of both pairs in one batch in both packages, each in its
    own copy of the scene (both write their products beside the frames)."""
    d, _ = scene
    fn = pipeline_outputs[1]
    res = {}
    for pkg in ('jax', 'torch'):
        dd = d.parent / f'{d.name}_{pkg}'
        shutil.copytree(d, dd)
        work = [f'{dd}/ztf_night{i}_sciimg.fits '
                f'{dd}/ztf_dither_ref_sciimg.fits' for i in (0, 1)]
        if pkg == 'jax':
            r = jnight.run_night(work, batch=2, ml=False, db=False,
                                 cfg=jp.PipelineConfig(**KW), pipe=fn)
        else:
            stats = {}
            r = tnight.run_night(work, batch=2, ml=False,
                                 cfg=tp.PipelineConfig(**KW), device='cpu',
                                 stats=stats)
            assert stats['ref_cache_hits'] == 1
            assert stats['ref_cache_misses'] == 1
            assert stats['detections'] == [n for _, n in r]
        res[pkg] = (dd, r)
    return res


def test_run_night_recovers_each_transient(scene, nights, pipeline_outputs):
    _, truths = scene
    seeing = pipeline_outputs[4]
    assert seeing[1] > 1.5 * 2.3        # the stamp moments' reading
    for pkg, (dd, res) in nights.items():
        assert len(res) == 2, pkg
        for i, (path, n) in enumerate(res):
            assert not isinstance(n, Exception), (pkg, path, n)
            assert path.endswith(f'night{i}_sciimg.fits')
            cat = {'jax': jcatalog, 'torch': tcatalog}[pkg] \
                .PipelineFITSCatalog.from_file(glob.glob(
                    f'{dd}/sub.ztf_night{i}_*.cat')[0])
            tx, ty = truths[i]
            dist = np.hypot(cat.data['X_IMAGE'] - 1 - tx,
                            cat.data['Y_IMAGE'] - 1 - ty)
            row = cat.data[np.argmin(dist)]
            assert dist.min() < 2.0, (pkg, i)
            if i == 0:
                assert row['GOODCUT'] == 1, pkg
            else:       # the sharp cut, and only it, removes it
                assert row['GOODCUT'] == 0, pkg
                assert row['FWHM_IMAGE'] < 0.8 * seeing[1]
                assert row['FWHM_IMAGE'] / seeing[1] <= 2.0
                assert row['NEGPIX'] == 0 and row['BPMCUT'] <= 0


def test_run_night_counts_and_products_match(nights, pipeline_outputs):
    spread = pipeline_outputs[3]
    (jd, jres), (td, tres) = nights['jax'], nights['torch']
    jn = np.asarray([n for _, n in jres])
    tn = np.asarray([n for _, n in tres])
    assert (np.abs(tn - jn) <= spread).all(), (tn, jn, spread)
    names = {pkg: sorted(os.path.basename(f)
                         for f in glob.glob(f'{dd}/sub.*'))
             for pkg, dd in (('jax', jd), ('torch', td))}
    assert names['torch'] == names['jax'] and len(names['jax']) == 2


def test_run_night_refuses_what_is_not_ported(scene):
    """db=True still raises and names its queue item; ml=True is the
    default of every entry point, as in the reference, and runs
    (test_run_night_scores_like_the_reference)."""
    d, _ = scene
    work = [f'{d}/ztf_night0_sciimg.fits {d}/ztf_dither_ref_sciimg.fits']
    with pytest.raises(NotImplementedError, match='db=True.*item 5'):
        tnight.run_night(work, db=True, device='cpu')
    for port, ref in ((tnight.run_night, jnight.run_night),
                      (tnight._commit_frame, jnight._commit_frame),
                      (tfilter.filter_sexcat, jfilter.filter_sexcat)):
        got = inspect.signature(port).parameters
        want = inspect.signature(ref).parameters
        assert got['ml'].default is want['ml'].default is True
    assert inspect.signature(tnight._commit_frame).parameters[
        'db'].default is False


def test_run_night_scores_like_the_reference(scene, pipeline_outputs,
                                             tmp_path, monkeypatch):
    """run_night at ml=True, db=False on both pairs in both packages, both
    packages' load_model_helper reading one npz of spread weights: the
    per-pair counts equal (within the reference's own spread, as the
    ml=False counts), and in each frame RB set exactly on the rows that
    passed the cuts before the ML cut, GOODCUT exactly where RB >= 0.3,
    the scores within 1e-4 of the reference's (the triplets are cut from
    the two pipelines' diffs and the two packages' warps)."""
    from zuds_tpu.models import braai as jbraai
    from zuds_tpu_torch.inputs import spread_braai
    from zuds_tpu_torch.models import braai as tbraai
    d, truths = scene
    spread = pipeline_outputs[3]
    model, _ = tbraai.init_braai(0, device='cpu')
    weights = str(tmp_path / 'braai_d6_m9.npz')
    tbraai.save_braai(spread_braai(model.params()), weights)
    monkeypatch.setattr(jfilter, 'load_model_helper',
                        lambda *a, **k: jbraai.load_braai(weights))
    monkeypatch.setattr(tfilter, 'load_model_helper',
                        lambda *a, **k: tbraai.load_braai(
                            weights, device=k.get('device')))
    counts, cats, stats = {}, {}, {}
    for pkg in ('jax', 'torch'):
        dd = tmp_path / pkg
        shutil.copytree(d, dd)
        work = [f'{dd}/ztf_night{i}_sciimg.fits '
                f'{dd}/ztf_dither_ref_sciimg.fits' for i in (0, 1)]
        if pkg == 'jax':
            res = jnight.run_night(work, batch=2, ml=True, db=False,
                                   cfg=jp.PipelineConfig(**KW),
                                   pipe=pipeline_outputs[1])
        else:
            res = tnight.run_night(work, batch=2, cfg=tp.PipelineConfig(**KW),
                                   device='cpu', stats=stats)
        counts[pkg] = np.asarray([n for _, n in res])
        cats[pkg] = [tcatalog.PipelineFITSCatalog.from_file(
            f'{dd}/sub.ztf_night{i}_sciimg_ztf_dither_ref_sciimg.cat').data
            for i in (0, 1)]
    assert (np.abs(counts['torch'] - counts['jax']) <= spread).all(), counts
    assert stats['scored'] == [int((c['RB'] != -99).sum())
                               for c in cats['torch']]
    assert len(stats['ml_s']) == 2 and stats['ml_s'][0] > 0
    for i, (jc, tc) in enumerate(zip(cats['jax'], cats['torch'])):
        scored = tc['RB'] != -99
        # frame 1's stamp-moment SEEING drops every row at the sharp cut
        assert scored.sum() >= (1 if i == 0 else 0)
        assert scored.sum() == (jc['RB'] != -99).sum()
        assert np.array_equal(tc['GOODCUT'] == 1,
                              scored & (tc['RB'] >= np.float32(0.3)))
        # rows found in both catalogs (within 0.02 px): the same rows
        # scored, the scores close
        for row in tc[scored]:
            dist = np.hypot(jc['X_IMAGE'] - row['X_IMAGE'],
                            jc['Y_IMAGE'] - row['Y_IMAGE'])
            if dist.min() < 0.02:
                j = int(dist.argmin())
                assert jc['RB'][j] != -99
                assert abs(jc['RB'][j] - row['RB']) < 1e-4, i


def test_run_night_records_the_fallback_past_the_bucket(scene, tmp_path):
    """A pair whose reference is rotated by 2 degrees: the batched feed
    refuses it and the per-pair chain runs instead, in both packages. The
    night records its count, equal in both, and the products land beside
    the science frame."""
    d, transients = scene
    counts, stats = {}, {}
    for pkg in ('jax', 'torch'):
        dd = tmp_path / pkg
        dd.mkdir()
        for f in d.glob('*.fits'):
            shutil.copy(f, dd / f.name)
        work = [f'{dd}/ztf_night0_sciimg.fits '
                f'{dd}/ztf_rotated_ref_sciimg.fits']
        if pkg == 'jax':
            res = jnight.run_night(work, batch=2, ml=False, db=False,
                                   cfg=jp.PipelineConfig(**KW))
        else:
            res = tnight.run_night(work, batch=2, ml=False,
                                   cfg=tp.PipelineConfig(**KW), device='cpu',
                                   stats=stats)
        assert len(res) == 1 and res[0][0] == work[0].split()[0]
        counts[pkg] = res[0][1]
    assert isinstance(counts['jax'], int), counts['jax']
    assert counts['torch'] == counts['jax'] >= 1
    assert stats['fallbacks'] == 1 and stats['fallback_s'] > 0
    assert stats['detections'] == []        # nothing went through the batch
    names = {pkg: sorted(f.name for f in (tmp_path / pkg).glob('sub.*'))
             for pkg in counts}
    assert names['torch'] == names['jax'] and len(names['jax']) == 8
    cat = tcatalog.PipelineFITSCatalog.from_file(
        str(tmp_path / 'torch'
            / 'sub.ztf_night0_sciimg_ztf_rotated_ref_sciimg.cat')).data
    tx, ty = transients[0]
    near = np.hypot(cat['X_IMAGE'] - 1 - tx, cat['Y_IMAGE'] - 1 - ty)
    assert near.min() < 2.0 and cat['GOODCUT'][near.argmin()] == 1


def test_run_night_records_a_failure_inside_the_fallback(scene, tmp_path):
    """The fallback's own exception is the pair's result, as in the
    reference (donight.py:331-335)."""
    d, _ = scene
    shutil.copy(d / 'ztf_night0_sciimg.fits', tmp_path)
    work = [f'{tmp_path}/ztf_night0_sciimg.fits {tmp_path}/missing_ref.fits']
    stats = {}
    res = tnight.run_night(work, batch=2, cfg=tp.PipelineConfig(**KW),
                           device='cpu', stats=stats)
    assert len(res) == 1 and isinstance(res[0][1], FileNotFoundError)
    assert stats['fallbacks'] == 1


def test_bulk_to_host_round_trip():
    rng = np.random.default_rng(3)
    ts = {'f': torch.as_tensor(rng.normal(size=(2, 5)).astype('f4')),
          'i': torch.as_tensor(rng.integers(-9, 9, (3,)).astype('i4')),
          'b': torch.as_tensor(rng.random((2, 3)) < 0.5),
          'l': torch.tensor(7, dtype=torch.int64),
          'e': torch.zeros((0, 4))}
    got = tnight._bulk_to_host(ts)
    for k, t in ts.items():
        assert got[k].dtype == t.numpy().dtype and got[k].shape == t.shape
        np.testing.assert_array_equal(got[k], t.numpy())


def test_loader_and_siblings_match_the_reference(scene):
    d, _ = scene
    sp = str(d / 'ztf_night1_sciimg.fits')
    assert tnight._sibling_mask_path(sp) == jnight._sibling_mask_path(sp)
    loader = tnight.NightLoader(workers=2)
    try:
        hdu = loader.get(loader.submit(sp))
    finally:
        loader.close()
    jhdu = next(h for h in jread(sp) if h.data is not None)
    np.testing.assert_array_equal(hdu.data, jhdu.data)
    sci, _ = load('torch', d, 1)
    jsci, _ = load('jax', d, 1)
    for a in ('field', 'ccdid', 'qid', 'fid', 'basename', 'local_path'):
        assert getattr(sci, a) == getattr(jsci, a), a
    assert sci.mask_image.data.dtype == np.uint16


def test_share_of_work_matches_the_reference(tmp_path, monkeypatch):
    from zuds_tpu import mpi as jmpi
    from zuds_tpu_torch import mpi as tmpi
    f = tmp_path / 'work.txt'
    f.write_text(''.join(f'sci{i}.fits ref.fits\n' for i in range(11)))
    for env in ({}, {'SLURM_ARRAY_TASK_ID': '2',
                     'SLURM_ARRAY_TASK_MAX': '3'},
                {'SLURM_PROCID': '1', 'SLURM_NTASKS': '4'}):
        for k in ('SLURM_ARRAY_TASK_ID', 'SLURM_ARRAY_TASK_MAX',
                  'SLURM_PROCID', 'SLURM_NTASKS'):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        np.testing.assert_array_equal(tmpi.get_my_share_of_work(str(f)),
                                      jmpi.get_my_share_of_work(str(f)))


def test_write_night_pairs_is_bench_recipe(tmp_path):
    """The flagship night scene of chip_smoke.py and profile --night, at a
    smaller size: the JAX package reads it, the science frames carry the
    real TPV distortion, the reference a linear dithered WCS."""
    from zuds_tpu.wcs import TPVWCS as JW
    from zuds_tpu_torch.inputs import NIGHT_SEEING, write_night_pairs
    work, truths = write_night_pairs(
        str(tmp_path), 2, 1400, 1300,
        header_json=ROOT / 'tests' / 'data' / 'ztf_real_header.json',
        no_seeing=(1,))
    assert len(work) == 2 and truths[1] == (757.0, 793.0)
    sci0, ref = work[0].split()
    sci1 = work[1].split()[0]
    hs = [next(h for h in jread(p) if h.data is not None)
          for p in (sci0, sci1, ref)]
    assert hs[0].header['SEEING'] == NIGHT_SEEING[1]
    assert 'SEEING' not in hs[1].header
    assert hs[2].header['SEEING'] == NIGHT_SEEING[0]
    ws, wr = JW.from_header(hs[0].header), JW.from_header(hs[2].header)
    assert np.count_nonzero(ws.pv1) > 3 and np.count_nonzero(wr.pv1) == 1
    # bench.py's CRPIX offsets (+2.1, -1.7) from (W/2, H/2), against the
    # science frame's (W/2 + 0.5, H/2 + 0.5)
    np.testing.assert_allclose(wr.crpix - ws.crpix, [1.6, -2.2])
    for p in (sci0, sci1, ref):
        m = next(h for h in jread(p.replace('sciimg', 'mskimg'))
                 if h.data is not None)
        assert m.data.dtype == np.uint16 and not m.data.any()
    tx, ty = truths[0]
    d = hs[0].data
    assert d[int(ty), int(tx)] > d[int(ty) + 20, int(tx) + 20] + 500


def test_cli_usage_and_card_default(tmp_path, capsys):
    """``python -m zuds_tpu_torch.night <worklist> [batch]``: usage without
    a work list; with one it runs on the card, and a machine without one
    refuses rather than running on the CPU."""
    assert tnight.main(['night']) == 2
    assert 'worklist' in capsys.readouterr().out
    work = tmp_path / 'work.txt'
    work.write_text('a_sciimg.fits b_sciimg.fits\n')
    if torch.cuda.is_available():
        pytest.skip('a card is present: the refusal needs a CPU machine')
    with pytest.raises(RuntimeError, match='no CUDA card'):
        tnight.main(['night', str(work), '2'])
