"""The filter's device steps and its ``ml=True`` branch in the port
(``zuds_tpu_torch/filterobjects.py``) against the JAX package on the CPU,
at small sizes from numpy seeds.

* ``make_triplets_batch`` on 200x180 frames, 48 candidates with corners
  clamped at all four edges and the four corners: rtol 1e-6 (the L2 sum
  adds in another order than XLA:CPU's); ``make_triplet_for_braai`` at a
  sky position likewise.
* ``_negpix_veto`` with planted -/+ pixel pairs, candidates at the edges:
  bit-equal, some vetoed, some not.
* ``filter_sexcat(cat, ml=True, ml_frames=...)`` with both packages'
  ``load_model_helper`` pointed at one npz of spread weights
  (``inputs.spread_braai``): GOODCUT equal, RB within 1e-6, the printed
  funnel equal, at three filters (cut 0.3, 0.6 and the default 0.5). The
  positions come from X_WORLD/Y_WORLD through each package's own WCS
  (they agree to ~1e-4 px), none within 0.05 px of a half pixel.
* The "no aligned frames" path prints the reference's line and cuts
  nothing more; ``load_model_helper`` caches per weights file and device.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zuds_tpu import filterobjects as jfilter
from zuds_tpu.fits import Header as JHeader
from zuds_tpu.models import braai as jbraai
from zuds_tpu.wcs import TPVWCS as JWCS
from zuds_tpu_torch import filterobjects as tfilter
from zuds_tpu_torch import inputs
from zuds_tpu_torch.catalog import CATALOG_DTYPE
from zuds_tpu_torch.fits import Header as THeader
from zuds_tpu_torch.models import braai as tbraai
from zuds_tpu_torch.wcs import TPVWCS as TWCS

torch.set_num_threads(2)

H, W = 200, 180
WCS_ARGS = dict(crval=(150.1, 35.2), crpix=(W / 2 + 0.5, H / 2 + 0.5),
                scale_deg=1.01 / 3600.0)


def blob_frames(xs, ys, seed):
    """new, ref, sub frames: noise, and a Gaussian at each position (in
    new and sub) or at every other one (in ref)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for k in range(3):
        img = rng.normal(0, 5.0, (H, W)) + (150.0 if k < 2 else 0.0)
        for i, (x, y) in enumerate(zip(xs, ys)):
            if k == 1 and i % 2:
                continue
            img += 3000.0 * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 4.0)
        out.append(img.astype('f4'))
    return out


def edge_positions(seed=1):
    """48 positions: inside, past each edge, in each corner; none within
    0.05 px of a half pixel."""
    rng = np.random.default_rng(seed)
    xs = list(rng.uniform(40, W - 40, 24))
    ys = list(rng.uniform(40, H - 40, 24))
    for x, y in ((2.3, 90.2), (W - 1.8, 60.7), (80.1, 1.2), (50.8, H - 2.6),
                 (0.2, 0.3), (W - 1.1, 0.9), (1.6, H - 0.8),
                 (W - 0.3, H - 1.4), (30.7, 100.1), (W - 31.2, 20.4),
                 (10.3, 31.9), (150.6, H - 31.3)):
        xs.append(x)
        ys.append(y)
    xs += list(rng.uniform(5, W - 5, 12))
    ys += list(rng.uniform(5, H - 5, 12))
    xs, ys = np.asarray(xs), np.asarray(ys)
    for a in (xs, ys):
        frac = a - np.floor(a)
        a += np.where(np.abs(frac - 0.5) < 0.05, 0.1, 0.0)
    return xs, ys


def images(frames, wcs_cls):
    wcs = wcs_cls.simple(**WCS_ARGS)
    return [SimpleNamespace(data=f, wcs=wcs) for f in frames]


def test_make_triplets_batch_clamps_at_every_edge():
    xs, ys = edge_positions()
    frames = blob_frames(xs, ys, 2)
    want = jfilter.make_triplets_batch(xs, ys, *images(frames, JWCS))
    got = tfilter.make_triplets_batch(xs, ys, *images(frames, TWCS),
                                      device='cpu')
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == want.shape == (len(xs), 63, 63, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
    # corners clamped: the windows of candidates past an edge coincide
    # with the edge's window
    x0 = np.clip(np.round(xs.astype('f4')).astype(int) - 31, 0, W - 63)
    assert {0, W - 63} <= set(x0) and (x0 == 0).sum() >= 3
    np.testing.assert_allclose((got.numpy() ** 2).sum((1, 2)), 1.0,
                               rtol=1e-5)


def test_make_triplet_for_braai_at_a_sky_position():
    xs, ys = edge_positions()
    frames = blob_frames(xs, ys, 3)
    ra, dec = TWCS.simple(**WCS_ARGS).pix2sky_0(np.array([70.2]),
                                                np.array([120.3]))
    want = jfilter.make_triplet_for_braai(ra, dec, *images(frames, JWCS))
    got = tfilter.make_triplet_for_braai(ra, dec, *images(frames, TWCS),
                                         device='cpu')
    assert got.shape == (63, 63, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)


def test_negpix_veto_at_the_edges_bit_equal():
    xs, ys = edge_positions(4)
    rng = np.random.default_rng(5)
    img = rng.normal(100.0, 5.0, (H, W)).astype('f4')
    # a -/+ pair beside every third candidate, a lone negative pixel
    # beside every third + 1
    for i, (x, y) in enumerate(zip(xs, ys)):
        cx = int(np.clip(np.round(x), 7, W - 8))
        cy = int(np.clip(np.round(y), 7, H - 8))
        if i % 3 == 0:
            img[cy, cx] = 40.0
            img[cy + 1, cx + 1] = 170.0
        elif i % 3 == 1:
            img[cy, cx] = 40.0
    want = jfilter._negpix_veto(img, xs, ys)
    got = tfilter._negpix_veto(img, xs, ys, device='cpu')
    assert got.dtype == bool and got.shape == (len(xs),)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(xs)


def catalog(xs, ys, header_cls, fid, wcs):
    """A pipeline-style catalog whose cuts read columns only (RMSMED,
    NEGPIX, BPMCUT, RMSCUT), on ``wcs``."""
    n = len(xs)
    rng = np.random.default_rng(6)
    data = np.zeros(n, dtype=CATALOG_DTYPE)
    data['X_IMAGE'] = xs + 1.0
    data['Y_IMAGE'] = ys + 1.0
    data['X_WORLD'], data['Y_WORLD'] = wcs.pix2sky_0(xs, ys)
    data['A_IMAGE'] = 1.2
    data['B_IMAGE'] = 1.0
    data['FWHM_IMAGE'] = 2.2
    data['FLUX_APER'] = 1000.0
    data['FLUXERR_APER'] = 10.0
    data['FLAGS'] = np.where(rng.random(n) < 0.1, 4, 0)
    data['NEGPIX'] = rng.random(n) < 0.1
    data['BPMCUT'] = 0.0
    data['RMSCUT'] = 1.0
    hdr = header_cls()
    hdr.set('RMSMED', 2.0)
    image = SimpleNamespace(header={'SEEING': 2.0}, fid=fid)
    return SimpleNamespace(data=data, header=hdr, image=image,
                           ismapped=False)


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp('braai')
    model, _ = tbraai.init_braai(0, device='cpu')
    path = str(d / 'braai_d6_m9.npz')
    tbraai.save_braai(inputs.spread_braai(model.params()), path)
    return path


@pytest.fixture
def one_model(weights, monkeypatch):
    """Both packages' load_model_helper read the same npz."""
    monkeypatch.setattr(jfilter, 'load_model_helper',
                        lambda *a, **k: jbraai.load_braai(weights))
    monkeypatch.setattr(tfilter, 'load_model_helper',
                        lambda *a, **k: tbraai.load_braai(
                            weights, device=k.get('device')))


def funnel(out):
    return [line for line in out.splitlines() if 'candidates' in line]


@pytest.mark.parametrize('fid', [2, 3, None])
def test_filter_sexcat_ml_matches_the_reference(one_model, capsys, fid):
    xs, ys = edge_positions(7)
    frames = blob_frames(xs, ys, 8)
    runs = {}
    for pkg, mod, hdr_cls, wcs_cls, kw in (
            ('jax', jfilter, JHeader, JWCS, {}),
            ('torch', tfilter, THeader, TWCS, {'device': 'cpu'})):
        cat = catalog(xs, ys, hdr_cls, fid, wcs_cls.simple(**WCS_ARGS))
        capsys.readouterr()
        mod.filter_sexcat(cat, ml=True, ml_frames=images(frames, wcs_cls),
                          **kw)
        runs[pkg] = (cat, funnel(capsys.readouterr().out))
    (jc, jlines), (tc, tlines) = runs['jax'], runs['torch']
    assert tlines == jlines and jlines[-1].startswith(
        'Number of candidates after ML cut')
    np.testing.assert_array_equal(tc.data['GOODCUT'], jc.data['GOODCUT'])
    np.testing.assert_allclose(tc.data['RB'], jc.data['RB'], rtol=0,
                               atol=1e-6)
    scored = tc.data['RB'] != -99
    assert scored.sum() > 0 and np.array_equal(scored, jc.data['RB'] != -99)
    cut = {2: 0.3, 3: 0.6, None: 0.5}[fid]
    kept = tc.data['GOODCUT'] == 1
    assert np.array_equal(kept, scored & (tc.data['RB'] >= np.float32(cut)))
    assert 0 < kept.sum() < scored.sum()
    assert tc.header['FILTERED']


def test_filter_sexcat_without_aligned_frames(one_model, capsys):
    xs, ys = edge_positions(7)
    outs = {}
    for pkg, mod, hdr_cls, wcs_cls, kw in (
            ('jax', jfilter, JHeader, JWCS, {}),
            ('torch', tfilter, THeader, TWCS, {'device': 'cpu'})):
        cat = catalog(xs, ys, hdr_cls, 2, wcs_cls.simple(**WCS_ARGS))
        capsys.readouterr()
        mod.filter_sexcat(cat, ml=True, **kw)
        outs[pkg] = (cat, capsys.readouterr().out)
    (jc, jout), (tc, tout) = outs['jax'], outs['torch']
    assert 'filter: no aligned frames for ML; skipping rb cut' in tout
    assert funnel(tout) == funnel(jout)
    np.testing.assert_array_equal(tc.data['GOODCUT'], jc.data['GOODCUT'])
    assert (tc.data['RB'] == -99).all()


def test_load_model_helper_caches_per_file_and_device(tmp_path):
    a, pa = tfilter.load_model_helper(device='cpu')
    b, _ = tfilter.load_model_helper(device='cpu')
    assert a is b and isinstance(a, tbraai.BraaiD6)
    fresh, _ = tbraai.init_braai(0, device='cpu')
    assert torch.equal(pa['params']['Conv_0']['kernel'],
                       fresh.Conv_0['kernel'])
    model, _ = tbraai.init_braai(9, device='cpu')
    tbraai.save_braai(model, str(tmp_path / 'braai_d6_m9.npz'))
    c, _ = tfilter.load_model_helper(str(tmp_path), device='cpu')
    assert c is not a and torch.equal(c.Conv_0['kernel'],
                                      model.Conv_0['kernel'])
    # the file rewritten (a new modification time): read again
    model2, _ = tbraai.init_braai(10, device='cpu')
    path = tmp_path / 'braai_d6_m9.npz'
    before = path.stat().st_mtime_ns
    tbraai.save_braai(model2, str(path))
    os.utime(path, ns=(before + 10 ** 9, before + 10 ** 9))
    d, _ = tfilter.load_model_helper(str(tmp_path), device='cpu')
    assert torch.equal(d.Conv_0['kernel'], model2.Conv_0['kernel'])
