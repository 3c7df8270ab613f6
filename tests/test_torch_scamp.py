"""scamp's port (``zuds_tpu_torch/scamp.py``) against the JAX package's
``zuds_tpu/scamp.py`` on the CPU, from the same inputs made from a seed.

Tolerances:
- ``match_catalogs``: indices equal (RA wrapping at 0/360, ties, empty
  catalogs included);
- ``fit_wcs_correction``, ``fit_tpv_correction``: on the same matched
  arrays CD, CRPIX, CRVAL, PV1 and PV2 bit-equal (the twin of
  ``tests/test_wcs.py``'s degree-3 recovery, at degrees 1-3, weighted,
  with outliers for the clip);
- ``calibrate_astrometry`` fed the same catalogs (the Gaia cache, the
  first image's stars, an explicit catalog, under 5 stars, the linear
  refit, degree 1): every refit WCS bit-equal and each epoch file the same
  header cards and pixels; the port's file read back gives its WCS to the
  14 digits a FITS card holds;
- ``inputs.write_coadd_epochs(wcs_errors=True)``: the true WCS's pixels,
  header errors within their bounds;
- ``Coadd.from_images(solve_astrometry=True)`` on 6 epochs of 512^2 with
  seeded header WCS errors, each package detecting its own catalogs (their
  rows differ at the ulp): the refit WCS of the two packages within
  ``SOLVE_AGREE_PX`` of each other over the frame, each within
  ``SOLVE_TRUTH_PX`` of the true WCS at the stars; the stacks to
  ``test_torch_coadd.py::test_from_images_matches``' tolerances.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from zuds_tpu import catalog as jcatalog  # noqa: E402
from zuds_tpu import coadd as jcoadd  # noqa: E402
from zuds_tpu import scamp as jscamp  # noqa: E402
from zuds_tpu import secrets as jsecrets  # noqa: E402
from zuds_tpu.image import ScienceImage as JSci  # noqa: E402
from zuds_tpu.wcs import TPVWCS as JWCS  # noqa: E402
from zuds_tpu_torch import catalog as tcatalog  # noqa: E402
from zuds_tpu_torch import coadd as tcoadd  # noqa: E402
from zuds_tpu_torch import inputs  # noqa: E402
from zuds_tpu_torch import scamp as tscamp  # noqa: E402
from zuds_tpu_torch import secrets as tsecrets  # noqa: E402
from zuds_tpu_torch.catalog import CATALOG_DTYPE  # noqa: E402
from zuds_tpu_torch.fits import read_fits  # noqa: E402
from zuds_tpu_torch.image import ScienceImage as TSci  # noqa: E402
from zuds_tpu_torch.wcs import TPVWCS  # noqa: E402

torch.set_num_threads(2)

SCALE = inputs.COADD_SCALE
SOLVE_AGREE_PX = 0.02
SOLVE_TRUTH_PX = 0.1


def _pair(wcs):
    """The same WCS as a JAX package object."""
    return JWCS(wcs.crpix.copy(), wcs.crval.copy(), wcs.cd.copy(),
                wcs.pv1.copy(), wcs.pv2.copy())


def _same_wcs(t, j):
    for a in ('crpix', 'crval', 'cd', 'pv1', 'pv2'):
        np.testing.assert_array_equal(getattr(t, a), getattr(j, a),
                                      err_msg=a)


def _near_wcs(back, w):
    """``back``, read from a FITS header, is ``w`` to the precision of
    a card's 20-character value field."""
    for a in ('crpix', 'crval', 'cd', 'pv1', 'pv2'):
        np.testing.assert_allclose(getattr(back, a), getattr(w, a),
                                   rtol=1e-14, atol=0, err_msg=a)


# ---- match_catalogs ---------------------------------------------------------

def _match_case(name):
    rng = np.random.default_rng(3)
    n = 300
    if name in ('field', 'ties'):
        ra2 = rng.uniform(149.5, 150.5, n)
        dec2 = rng.uniform(34.5, 35.5, n)
    elif name == 'wrap':
        ra2 = np.mod(rng.uniform(-0.5, 0.5, n), 360.0)
        dec2 = rng.uniform(9.5, 10.5, n)
    else:
        ra2 = dec2 = np.array([])
    if len(ra2):
        sel = rng.choice(n, 120, replace=False)
        ra1 = ra2[sel] + rng.normal(0, 0.6 / 3600, 120) / np.cos(
            np.radians(dec2[sel]))
        dec1 = dec2[sel] + rng.normal(0, 0.6 / 3600, 120)
        ra1 = np.mod(np.concatenate([ra1, rng.uniform(120, 121, 20)]), 360)
        dec1 = np.concatenate([dec1, rng.uniform(10, 11, 20)])
    else:
        ra1, dec1 = rng.uniform(149.5, 150.5, 5), rng.uniform(34.5, 35.5, 5)
    if name == 'ties':
        # exact duplicates in the second catalog: the scan order decides
        ra2 = np.concatenate([ra2, ra2[:40]])
        dec2 = np.concatenate([dec2, dec2[:40]])
    if name == 'empty1':
        return np.array([]), np.array([]), ra1, dec1
    return ra1, dec1, ra2, dec2


@pytest.mark.parametrize('name', ['field', 'wrap', 'ties', 'empty1',
                                  'empty2'])
def test_match_catalogs_same_indices(name):
    args = _match_case(name)
    t = tscamp.match_catalogs(*args)
    j = jscamp.match_catalogs(*args)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    if name in ('field', 'wrap', 'ties'):
        assert len(t[0]) >= 100
    else:
        assert len(t[0]) == 0
    if name == 'wrap':
        # pairs on both sides of RA 0 are matched across it
        ra1 = args[0][t[0]]
        assert (ra1 < 1).any() and (ra1 > 359).any()


# ---- the fits ----------------------------------------------------------------

def _distorted_scene(seed=11, n=400, outliers=0):
    """test_wcs.py's degree-3 scene: a frame with known cubic PV terms,
    the stars' pixels and true sky positions, the undistorted guess."""
    rng = np.random.default_rng(seed)
    true = TPVWCS.simple(crval=(150.0, 35.0), crpix=(1536.5, 1540.5),
                         scale_deg=SCALE)
    true.pv1 = true.pv1.copy()
    true.pv2 = true.pv2.copy()
    true.pv1[[0, 2, 4, 5, 7, 9]] = [2e-5, 1.5e-3, 8e-3, -5e-3, 1.2e-2, 6e-3]
    true.pv2[[0, 6, 8, 10]] = [-1e-5, 7e-3, -9e-3, 1.1e-2]
    true.pv2[1] += 2e-3
    xs = rng.uniform(10, 3062, n)
    ys = rng.uniform(10, 3070, n)
    ra, dec = true.pix2sky(xs, ys)
    if outliers:
        ra = ra.copy()
        ra[:outliers] += rng.uniform(3, 6, outliers) / 3600.0
    guess = TPVWCS.simple(crval=(150.0, 35.0), crpix=(1537.1, 1539.8),
                          scale_deg=SCALE, rot_deg=0.004)
    err = rng.uniform(0.005, 0.05, n)
    return guess, xs, ys, ra, dec, 1.0 / err ** 2, true


@pytest.mark.parametrize('degree,weighted,outliers', [
    (3, False, 0), (3, True, 0), (3, True, 12), (2, False, 0),
    (1, True, 0), (3, False, 390)])
def test_fit_tpv_correction_bit_equal(degree, weighted, outliers):
    guess, xs, ys, ra, dec, w, true = _distorted_scene(outliers=outliers)
    kw = dict(degree=degree, weights=w if weighted else None)
    t = tscamp.fit_tpv_correction(guess, xs, ys, ra, dec, **kw)
    j = jscamp.fit_tpv_correction(_pair(guess), xs, ys, ra, dec, **kw)
    _same_wcs(t, j)
    _same_wcs(guess, TPVWCS.simple(crval=(150.0, 35.0),
                                   crpix=(1537.1, 1539.8), scale_deg=SCALE,
                                   rot_deg=0.004))     # not modified
    if degree == 3 and outliers < 100:
        # the clip drops the outliers; the distortion is recovered
        fx, fy = t.sky2pix(*true.pix2sky(xs[outliers:], ys[outliers:]))
        assert np.hypot(fx - xs[outliers:], fy - ys[outliers:]).max() < 0.05


@pytest.mark.parametrize('n', [3, 40])
def test_fit_wcs_correction_bit_equal(n):
    guess, xs, ys, ra, dec, _, true = _distorted_scene(n=n)
    t = tscamp.fit_wcs_correction(guess, xs, ys, ra, dec)
    j = jscamp.fit_wcs_correction(_pair(guess), xs, ys, ra, dec)
    _same_wcs(t, j)
    assert not np.array_equal(t.crpix, guess.crpix)


# ---- calibrate_astrometry on the same catalogs ------------------------------

H = W = 512
NEP = 3


@pytest.fixture()
def config(tmp_path, monkeypatch):
    """Both packages read a config whose ``gaia_cache_directory`` is an
    empty directory of the test's own."""
    cache = tmp_path / 'gaia'
    cache.mkdir()
    cfg = tmp_path / 'config.yaml'
    cfg.write_text(f'gaia_cache_directory: {cache}\n')
    os.chmod(cfg, 0o600)
    monkeypatch.setenv('ZUDS_CONFIG', str(cfg))
    for m in (jsecrets, tsecrets):
        m._manager.cache = None
    yield cache
    for m in (jsecrets, tsecrets):
        m._manager.cache = None


def _catalog(true_wcs, head_wcs, ra, dec, rng, nkeep=None):
    """A catalog of the stars at (ra, dec) on an epoch drawn with
    ``true_wcs`` whose header says ``head_wcs``: 1-based positions within
    0.01 px of the truth, world coordinates through the header's WCS,
    rows that pass ``select_stars``, windowed errors of 0.005-0.05 px."""
    x, y = true_wcs.sky2pix(ra, dec)
    n = len(x) if nkeep is None else nkeep
    cat = np.zeros(n, dtype=CATALOG_DTYPE)
    cat['X_IMAGE'] = x[:n] + rng.normal(0, 0.01, n)
    cat['Y_IMAGE'] = y[:n] + rng.normal(0, 0.01, n)
    wra, wdec = head_wcs.pix2sky(cat['X_IMAGE'].astype(float),
                                 cat['Y_IMAGE'].astype(float))
    cat['X_WORLD'], cat['Y_WORLD'] = wra, wdec
    cat['FLUX_APER'] = rng.uniform(5e3, 5e4, n)
    cat['FLUXERR_APER'] = 20.0
    cat['ELONGATION'] = rng.uniform(1.0, 1.2, n)
    cat['FWHM_IMAGE'] = rng.normal(2.0, 0.05, n)
    cat['ERRAWIN_IMAGE'] = rng.uniform(0.005, 0.05, n)
    return cat


def _epochs(tmp_path):
    """NEP 512^2 epochs of the coadd scene with header WCS errors, in a
    directory for each package."""
    d = {k: tmp_path / k for k in ('torch', 'jax')}
    d['torch'].mkdir()
    paths, true = inputs.write_coadd_epochs(
        str(d['torch']), NEP, H, W, seed=13, nstars=50,
        wcs_errors=True)
    shutil.copytree(d['torch'], d['jax'])
    return paths, true


def _files_equal(a, b):
    ha = next(h for h in read_fits(a) if h.data is not None)
    hb = next(h for h in read_fits(b) if h.data is not None)
    np.testing.assert_array_equal(ha.data, hb.data)
    assert list(ha.header.keys()) == list(hb.header.keys())
    for k in ha.header.keys():
        assert ha.header[k] == hb.header[k], k
    return ha.header


@pytest.mark.parametrize('case', ['cache', 'first', 'catalog', 'few_stars',
                                  'linear', 'degree1'])
def test_calibrate_astrometry_bit_equal(case, config, tmp_path):
    tpaths, true = _epochs(tmp_path)
    jpaths = [p.replace(os.sep + 'torch' + os.sep, os.sep + 'jax' + os.sep)
              for p in tpaths]
    ra, dec = inputs.coadd_stars(H, W, seed=13, nstars=50)
    if case == 'cache':
        inputs.write_gaia_cache(str(config), H, W, seed=13, nstars=50)
    timgs = [TSci.from_file(p) for p in tpaths]
    jimgs = [JSci.from_file(p, use_existing_record=False) for p in jpaths]
    rng = np.random.default_rng(5)
    before = [open(p, 'rb').read() for p in tpaths]
    for i, (ti, ji) in enumerate(zip(timgs, jimgs)):
        nkeep = {'few_stars': 4 if i == 1 else None,
                 'linear': 12}.get(case)
        cat = _catalog(true[i], ti.wcs, ra, dec, rng, nkeep)
        ti.catalog = tcatalog.PipelineFITSCatalog()
        ti.catalog.data = cat
        ji.catalog = jcatalog.PipelineFITSCatalog()
        ji.catalog.data = cat.copy()
        ti.data, ji.data        # read the pixels: the save writes them
    kw = dict(inplace=True)
    if case == 'catalog':
        kw['reference_catalog'] = (ra, dec)
    if case == 'degree1':
        kw['distort_degree'] = 1
    t = tscamp.calibrate_astrometry(timgs, **kw)
    j = jscamp.calibrate_astrometry(jimgs, **kw)
    assert len(t) == len(j) == NEP
    for i, (tw, jw) in enumerate(zip(t, j)):
        _same_wcs(tw, jw)
        kept = case == 'few_stars' and i == 1
        assert (tw is timgs[i].wcs) and (jw is jimgs[i].wcs)
        if kept:
            assert open(tpaths[i], 'rb').read() == before[i]
            continue
        head = _files_equal(tpaths[i], jpaths[i])
        # the port's file carries the refit WCS, to the digits a FITS card
        # holds
        _near_wcs(TPVWCS.from_header(head), tw)
        fit_pv = case in ('cache', 'first', 'catalog', 'few_stars')
        assert ('PV1_7' in head) == fit_pv or i % 2 == 1
        if case in ('cache', 'catalog'):
            # against the true positions: within the catalog's noise
            x, y = true[i].sky2pix(ra, dec)
            fx, fy = tw.sky2pix(ra, dec)
            assert np.hypot(fx - x, fy - y).max() < 0.05


def test_gaia_cache_lookup(config):
    """The cache file is found by the first image's centre, as named by
    ``inputs.write_gaia_cache``; absent, both packages return None."""
    assert tscamp._gaia_cache(150.1, 35.2) is None
    assert jscamp._gaia_cache(150.1, 35.2) is None
    path = inputs.write_gaia_cache(str(config), H, W, seed=13, nstars=50)
    assert os.path.basename(path) == 'gaia_150_35.npz'
    t, j = tscamp._gaia_cache(150.6, 35.9), jscamp._gaia_cache(150.6, 35.9)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t[0], inputs.coadd_stars(H, W, 13, 50)[0])


def test_header_errors_leave_the_pixels(tmp_path):
    """``write_coadd_epochs(wcs_errors=True)``: the pixels are those of the
    true WCS; each header's CRPIX is off by at most WCS_ERR_CRPIX_PX, its
    CD rotated by at most WCS_ERR_ROT_DEG, and every second epoch's cubic
    terms move a frame corner by WCS_ERR_DISTORT_PX at most, one corner by
    exactly that."""
    a, b = tmp_path / 'a', tmp_path / 'b'
    a.mkdir()
    b.mkdir()
    pa, true = inputs.write_coadd_epochs(str(a), 4, 96, 128, seed=2,
                                         nstars=6)
    pb, true_b = inputs.write_coadd_epochs(str(b), 4, 96, 128, seed=2,
                                           nstars=6, wcs_errors=True)
    for i, (x, y) in enumerate(zip(pa, pb)):
        ha = next(h for h in read_fits(x) if h.data is not None)
        hb = next(h for h in read_fits(y) if h.data is not None)
        np.testing.assert_array_equal(ha.data, hb.data)
        _same_wcs(true[i], true_b[i])
        head = TPVWCS.from_header(hb.header)
        assert 0 < np.hypot(*(head.crpix - true[i].crpix)) \
            <= inputs.WCS_ERR_CRPIX_PX
        rot = np.degrees(np.arctan2(head.cd[1, 0], head.cd[1, 1])
                         - np.arctan2(true[i].cd[1, 0], true[i].cd[1, 1]))
        assert 0 < abs(rot) <= inputs.WCS_ERR_ROT_DEG
        assert ('PV1_7' in hb.header) == (i % 2 == 1)
        if i % 2:
            # the corners W/2, H/2 px from CRPIX, through the header WCS
            # and back through the same WCS without its cubic terms (the
            # writer scales on the unrotated tangent plane: within 1e-3)
            lin = TPVWCS(head.crpix, head.crval, head.cd, true[i].pv1,
                         true[i].pv2)
            x = head.crpix[0] + np.array([-64.0, 64.0, 64.0, -64.0])
            y = head.crpix[1] + np.array([-48.0, -48.0, 48.0, 48.0])
            x0, y0 = lin.sky2pix(*head.pix2sky(x, y))
            assert np.hypot(x0 - x, y0 - y).max() == pytest.approx(
                inputs.WCS_ERR_DISTORT_PX, rel=1e-3)


# ---- Coadd.from_images(solve_astrometry=True) -------------------------------

SNEP = 6


@pytest.fixture(scope='module')
def solved(tmp_path_factory):
    """SNEP epochs of 512^2 with header WCS errors through both packages'
    ``ReferenceImage.from_images(solve_astrometry=True)`` (no Gaia cache:
    the first epoch's stars are the reference), each detecting its own
    catalogs; and the same epochs with their true WCS through the port's
    unsolved stack."""
    base = tmp_path_factory.mktemp('solve')
    cfg = base / 'config.yaml'
    cfg.write_text(f'gaia_cache_directory: {base / "nocache"}\n')
    os.chmod(cfg, 0o600)
    env = os.environ.get('ZUDS_CONFIG')
    os.environ['ZUDS_CONFIG'] = str(cfg)
    for m in (jsecrets, tsecrets):
        m._manager.cache = None
    try:
        d = {k: base / k for k in ('torch', 'jax', 'true')}
        d['torch'].mkdir()
        d['true'].mkdir()
        tpaths, true = inputs.write_coadd_epochs(
            str(d['torch']), SNEP, H, W, seed=13, nstars=50,
            wcs_errors=True)
        inputs.write_coadd_epochs(str(d['true']), SNEP, H, W, seed=13,
                                  nstars=50)
        shutil.copytree(d['torch'], d['jax'])
        heads = [TSci.from_file(p).wcs for p in tpaths]
        timgs = [TSci.from_file(p) for p in tpaths]
        jimgs = [JSci.from_file(p.replace(str(d['torch']), str(d['jax'])),
                                use_existing_record=False) for p in tpaths]
        stats = {}
        t = tcoadd.ReferenceImage.from_images(
            timgs, str(d['torch'] / 'ref.fits'), calculate_seeing=False,
            device='cpu', solve_astrometry=True, stats=stats)
        j = jcoadd.ReferenceImage.from_images(
            jimgs, str(d['jax'] / 'ref.fits'), calculate_seeing=False,
            solve_astrometry=True)
    finally:
        if env is None:
            os.environ.pop('ZUDS_CONFIG', None)
        else:
            os.environ['ZUDS_CONFIG'] = env
        for m in (jsecrets, tsecrets):
            m._manager.cache = None
    return dict(t=t, j=j, timgs=timgs, jimgs=jimgs, true=true, heads=heads,
                stats=stats, paths=tpaths)


def test_solve_refits_each_epoch(solved):
    """Each epoch's refit WCS: the two packages within SOLVE_AGREE_PX over
    the frame, each within SOLVE_TRUTH_PX of epoch 0's frame at the stars,
    the header errors themselves larger; the refit saved in the files."""
    ra, dec = inputs.coadd_stars(H, W, seed=13, nstars=50)
    true, heads = solved['true'], solved['heads']
    gy, gx = np.mgrid[1:H:32, 1:W:32].astype(float)
    # epoch 0's header frame: where its stars sit in that frame's sky
    s0 = heads[0].pix2sky(*true[0].sky2pix(ra, dec))
    for i, (ti, ji) in enumerate(zip(solved['timgs'], solved['jimgs'])):
        a = np.array(ti.wcs.pix2sky(gx.ravel(), gy.ravel()))
        b = np.array(ji.wcs.pix2sky(gx.ravel(), gy.ravel()))
        dpx = np.hypot((a[0] - b[0]) * np.cos(np.radians(a[1])),
                       a[1] - b[1]) / SCALE
        assert dpx.max() < SOLVE_AGREE_PX, (i, dpx.max())
        x, y = true[i].sky2pix(ra, dec)
        fx, fy = ti.wcs.sky2pix(*s0)
        err = np.hypot(fx - x, fy - y)
        assert err.max() < SOLVE_TRUTH_PX, (i, err.max())
        if i:
            hx, hy = heads[i].sky2pix(*s0)
            assert np.hypot(hx - x, hy - y).max() > 5 * SOLVE_TRUTH_PX
        _near_wcs(TSci.from_file(solved['paths'][i]).wcs, ti.wcs)
    st = solved['stats']
    assert st['catalog_s'] > 0 and st['scamp_s'] > 0
    # the catalogs were detected on the stack's device
    assert all(str(im.device) == 'cpu' for im in solved['timgs'])


def test_solved_stack_matches(solved):
    t, j = solved['t'], solved['j']
    assert t.data.shape == j.data.shape and t.data.dtype == j.data.dtype
    assert t.header['NCOADD'] == j.header['NCOADD'] == SNEP
    tw, jw = t.weight_image.data, j.weight_image.data
    assert ((tw > 0) == (jw > 0)).mean() >= 0.9999
    both = (tw > 0) & (jw > 0)
    d = np.abs(t.data - j.data)[both]
    assert np.median(d) < 0.01, np.median(d)
    assert (d > 0.05).mean() < 1e-3, (d > 0.05).mean()
    tm, jm = t.mask_image.data, j.mask_image.data
    assert (tm != jm).mean() < 1e-4
    np.testing.assert_array_equal((tm >> 16 & 1) == 1, tw == 0)
    # the cards but the first epoch's distortion equal; the port's stack
    # has the grid's undistorted WCS, the JAX package's header keeps the
    # first epoch's refit PV cards under it (ROADMAP section 3)
    pv = [k for k in j.header.keys() if k.startswith(('PV1_', 'PV2_'))]
    assert pv and not [k for k in t.header.keys()
                       if k.startswith(('PV1_', 'PV2_'))]
    assert list(t.header.keys()) == [k for k in j.header.keys()
                                     if k not in pv]
    for k in t.header.keys():
        if k not in ('CRPIX1', 'CRPIX2'):
            assert t.header[k] == j.header[k], k
    grid = TPVWCS.from_header(t.header)
    assert grid.pv1[1] == grid.pv2[1] == 1.0
    assert np.count_nonzero(grid.pv1) == np.count_nonzero(grid.pv2) == 1
    for k, v in zip(pv, (j.header[k] for k in pv)):
        assert solved['jimgs'][0].header[k] == v
