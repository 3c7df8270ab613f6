"""The port's forced photometry against the JAX package on the CPU.

One 256x256 scene (stars, a transient, noise, the real ZTF TPV header,
MAGZP and an aperture correction) with an rms sibling and a mask sibling
(bad and harmless bits in blobs) is written by the port's FITS writer, and
64 seeded positions (``inputs.forced_positions``: the transient, stars,
blank sky, rows at and off the edges, rows on masked pixels) are measured
by both packages from the same files: ``aperture_photometry`` at both
``assume_background_subtracted`` settings, ``raw_aperture_photometry`` and
``CalibratedImage.force_photometry``.

Compared: the pixel positions equal (the two TPV codes are bit-equal),
NaN and ``bad`` at the same rows, ``zp`` equal, ``flux`` and ``fluxerr``
within rtol 1e-5 and atol 1e-3 (XLA:CPU's arcsine and roots are not
PyTorch's, so an overlap may differ in its last bits), and the flags
equal but for the bits under pixels whose overlap is a rounding residue
(0 < w < 1e-5 in either package: the four signed quadrant areas of ~7
px^2 cancel to an ulp, ROADMAP section 3). With the background
subtracted by each package's own mesh, the flux gap may grow by the
aperture's area times the largest gap between the two backgrounds.

Also: the r=6 two-plane sums against two r=6 calls of the JAX package,
``ForcedPhotometry``'s magnitudes, the lazy namespace, the card default of
the entry points, the scene's rows, N = 0, and the pipeline's negpix veto
through H14's plain version bit-equal to the full-frame form it replaced.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu import photometry as jphot
from zuds_tpu.image import ScienceImage as JSci
from zuds_tpu.ops.photometry import aperture_photometry_batched as j_ap
from zuds_tpu.ops.photometry import circle_pixel_overlap as j_overlap
import zuds_tpu_torch
from zuds_tpu_torch import inputs
from zuds_tpu_torch import photometry as tphot
from zuds_tpu_torch.constants import BAD_SUM
from zuds_tpu_torch.fits import HDU, Header, write_fits
from zuds_tpu_torch.image import ScienceImage as TSci
from zuds_tpu_torch.ops import cutouts, measure
from zuds_tpu_torch.ops import photometry as tops
from zuds_tpu_torch.ops.background import frame_median
from zuds_tpu_torch.ops.convolve import dilate_max
from zuds_tpu_torch.parallel import pipeline as tp
from zuds_tpu_torch.wcs import TPVWCS

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
H = W = 256
N = 64
TRANSIENT = (120.3, 97.6, 3e4)
SEEING = 2.8
APCOR = -0.042
NAME = 'ztf_20180815000000_000679_zr_c01_o_q2_sciimg.fits'
RTOL, ATOL, RESIDUE = 1e-5, 1e-3, 1e-5


def scene_wcs():
    real = json.loads((ROOT / 'tests' / 'data'
                       / 'ztf_real_header.json').read_text())
    h = Header()
    for k, v in {**real['wcs'], **real['meta']}.items():
        h.set(k, v)
    wcs = TPVWCS.from_header(h)
    wcs.crval[:] = (150.1, 35.2)
    wcs.crpix[:] = (W / 2 + 0.5, H / 2 + 0.5)
    return wcs


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    """The scene's three files, its WCS, its positions and their kinds."""
    d = tmp_path_factory.mktemp('phot')
    rng = np.random.default_rng(3)
    sx, sy = rng.uniform(12, W - 12, 40), rng.uniform(12, H - 12, 40)
    fl = rng.uniform(3e3, 4e4, 40)
    yy, xx = np.mgrid[0:H, 0:W]
    s = SEEING / 2.355
    img = np.full((H, W), 150.0) + 12.0 * np.sin(xx / 70.0) * np.cos(
        yy / 90.0)
    for x, y, f in list(zip(sx, sy, fl)) + [TRANSIENT]:
        img += f / (2 * np.pi * s * s) * np.exp(
            -((xx - x) ** 2 + (yy - y) ** 2) / (2 * s * s))
    img = (img + rng.normal(0, 5.0, (H, W))).astype('f4')
    mask = np.zeros((H, W), np.uint16)
    for (y0, x0), bit in zip(rng.integers(10, H - 12, (12, 2)),
                             (0, 1, 2, 5, 1, 7, 10, 3, 1, 0, 11, 15)):
        mask[y0:y0 + 3, x0:x0 + 2] |= np.uint16(1 << bit)
    rms = np.full((H, W), 5.0, 'f4') + (img - 150.0) * 1e-3
    wcs = scene_wcs()
    h = Header()
    wcs.to_header(h)
    for k, v in dict(MAGZP=26.3, APCOR4=APCOR, OBSMJD=58345.25,
                     OBSJD=2458345.75, FIELDID=679, CCDID=1, QID=2,
                     FILTERID=2, SATURATE=60000.0, SEEING=SEEING,
                     FILENAME=NAME).items():
        h.set(k, v)
    sci = str(d / NAME)
    write_fits(sci, [HDU(h, img)])
    write_fits(sci.replace('sciimg', 'mskimg'), [HDU(h.copy(), mask)])
    write_fits(sci.replace('.fits', '.rms.fits'), [HDU(h.copy(), rms)])
    ra, dec, kind = inputs.forced_positions(wcs, H, W, N, TRANSIENT[:2],
                                            (sx, sy), mask=mask, seed=5)
    return {'dir': d, 'sci': sci, 'mask': sci.replace('sciimg', 'mskimg'),
            'rms': sci.replace('.fits', '.rms.fits'), 'ra': ra, 'dec': dec,
            'kind': kind, 'stars': (sx, sy), 'mask_data': mask, 'img': img,
            'rms_data': rms}


def fresh_copy(scene, tmp_path, tag):
    """The scene's files in a directory of their own: a product an image
    computes is saved beside it, and must not reach the other package."""
    d = tmp_path / tag
    d.mkdir()
    for k in ('sci', 'mask', 'rms'):
        shutil.copy(scene[k], d)
    return str(d / NAME)


def residue_bits(mask, xs, ys, r=3.0):
    """Per aperture, the OR of the mask bits under pixels whose overlap is
    0 < w < RESIDUE in either package (0 off the frame)."""
    cut = tops.aperture_cut(r)
    half = cut // 2
    out = []
    for xc, yc in zip(np.float32(xs), np.float32(ys)):
        x0 = min(max(int(np.round(xc)) - half, 0), W - cut)
        y0 = min(max(int(np.round(yc)) - half, 0), H - cut)
        dx = np.broadcast_to(x0 + np.arange(cut, dtype='f4') - xc,
                             (cut, cut))
        dy = np.broadcast_to((y0 + np.arange(cut, dtype='f4') - yc)[:, None],
                             (cut, cut))
        wj = np.asarray(j_overlap(jnp.asarray(dx), jnp.asarray(dy),
                                  jnp.float32(r)))
        wt = tops.circle_pixel_overlap(torch.from_numpy(np.array(dx)),
                                       torch.from_numpy(np.array(dy)),
                                       r).numpy()
        tiny = ((wj > 0) & (wj < RESIDUE)) | ((wt > 0) & (wt < RESIDUE))
        out.append(np.bitwise_or.reduce(
            np.where(tiny, mask[y0:y0 + cut, x0:x0 + cut].astype(np.int64),
                     0), axis=None))
    return np.array(out, np.int64)


def assert_same(t, j, mask, flux_atol=ATOL):
    np.testing.assert_array_equal(t['x'], j['x'])
    np.testing.assert_array_equal(t['y'], j['y'])
    assert t['zp'] == j['zp']
    for k in ('flux', 'fluxerr'):
        np.testing.assert_array_equal(np.isnan(t[k]), np.isnan(j[k]),
                                      err_msg=k)
        np.testing.assert_allclose(t[k], j[k], rtol=RTOL,
                                   atol=flux_atol if k == 'flux' else ATOL,
                                   err_msg=k)
    res = residue_bits(mask, t['x'], t['y'])
    np.testing.assert_array_equal(t['flags'] & ~res, j['flags'] & ~res)
    # a residue bit that is BAD_SUM could flip bad: none may here
    assert not (res & BAD_SUM & (t['flags'] ^ j['flags'])).any()
    np.testing.assert_array_equal(t['bad'], j['bad'])


def test_scene_rows(scene):
    """The seeded positions hold every kind of row the forced photometry
    meets: edge and off-frame rows together over 5%, masked rows on set
    mask pixels, blank sky away from every star."""
    kind = scene['kind']
    assert len(kind) == N and kind[0] == 'transient'
    assert set(kind) == set(inputs.FORCED_KINDS)
    assert np.isin(kind, ('edge', 'off')).mean() >= 0.05
    x, y = scene_wcs().sky2pix_0(scene['ra'], scene['dec'])
    m = kind == 'masked'
    assert (scene['mask_data'][np.round(y[m]).astype(int),
                                np.round(x[m]).astype(int)] != 0).all()
    off = kind == 'off'
    assert ((x[off] < -4) | (x[off] > W + 3) | (y[off] < -4)
            | (y[off] > H + 3)).all()
    sky = kind == 'sky'
    sx, sy = scene['stars']
    assert (np.hypot(x[sky, None] - sx[None], y[sky, None] - sy[None])
            .min(1) >= 12.0).all()
    np.testing.assert_allclose([x[0], y[0]], TRANSIENT[:2], atol=1e-6)


@pytest.mark.parametrize('bkgsub', [True, False])
def test_aperture_photometry_matches(scene, tmp_path, bkgsub):
    jimg = JSci.from_file(fresh_copy(scene, tmp_path, 'jax'))
    timg = TSci.from_file(fresh_copy(scene, tmp_path, 'torch'))
    kw = dict(apply_calibration=True, assume_background_subtracted=bkgsub)
    j = jphot.aperture_photometry(jimg, scene['ra'], scene['dec'], **kw)
    t = tphot.aperture_photometry(timg, scene['ra'], scene['dec'],
                                  device='cpu', **kw)
    assert t['zp'] == pytest.approx(26.3 + APCOR)
    atol = ATOL
    if not bkgsub:
        gap = np.abs(np.asarray(timg.background_image.data, 'f8')
                     - np.asarray(jimg.background_image.data, 'f8')).max()
        atol += np.pi * 3.0 ** 2 * gap
    assert_same(t, j, scene['mask_data'], flux_atol=atol)
    kind = scene['kind']
    off = kind == 'off'
    assert np.isnan(t['flux'][off]).all() and t['bad'][off].all()
    assert (t['flags'][kind == 'masked'] != 0).all()
    assert t['bad'].sum() > off.sum()
    # the transient's aperture holds its flux times the Gaussian's r = 3
    # enclosed fraction, above the sky
    sig = SEEING / 2.3548
    want = TRANSIENT[2] * (1 - np.exp(-9.0 / (2 * sig * sig)))
    if bkgsub:
        want += 150.0 * np.pi * 9.0
    assert abs(t['flux'][0] - want) < 0.05 * want


def test_raw_aperture_photometry_matches(scene):
    args = (scene['sci'], scene['rms'], scene['mask'], scene['ra'],
            scene['dec'])
    for cal in (False, True):
        j = jphot.raw_aperture_photometry(*args, apply_calibration=cal)
        t = tphot.raw_aperture_photometry(*args, apply_calibration=cal,
                                          device='cpu')
        assert_same(t, j, scene['mask_data'])
        assert t['zp'] == pytest.approx(26.3 + (APCOR if cal else 0.0))


def test_force_photometry_matches(scene, tmp_path):
    """Dicts and (ra, dec) pairs in both packages; objects with .ra and
    .dec in the port (the JAX package indexes every source first)."""
    jimg = JSci.from_file(fresh_copy(scene, tmp_path, 'jax'))
    timg = TSci.from_file(fresh_copy(scene, tmp_path, 'torch'))
    ra, dec = scene['ra'], scene['dec']
    half = N // 2
    sources = ([{'ra': r, 'dec': d} for r, d in zip(ra[:half], dec[:half])]
               + [(r, d) for r, d in zip(ra[half:], dec[half:])])
    jr = jimg.force_photometry(sources, assume_background_subtracted=True)
    tr = timg.force_photometry(sources, assume_background_subtracted=True,
                               device='cpu')
    j = {k: np.array([getattr(r, k) for r in jr]) for k in
         ('flux', 'fluxerr', 'flags', 'ra', 'dec', 'zp', 'obsjd')}
    t = {k: np.array([getattr(r, k) for r in tr]) for k in j}
    for k in ('ra', 'dec', 'zp', 'obsjd'):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for k in ('flux', 'fluxerr'):
        np.testing.assert_array_equal(np.isnan(t[k]), np.isnan(j[k]))
        np.testing.assert_allclose(t[k], j[k], rtol=RTOL, atol=ATOL)
    x, y = scene_wcs().sky2pix_0(ra, dec)
    res = residue_bits(scene['mask_data'], x, y)
    np.testing.assert_array_equal(t['flags'] & ~res, j['flags'] & ~res)
    assert all(r.source is s and r.image is timg
               for r, s in zip(tr, sources))

    class Src:
        def __init__(self, ra, dec):
            self.ra, self.dec = ra, dec

    objs = timg.force_photometry([Src(r, d) for r, d in zip(ra, dec)],
                                 assume_background_subtracted=True,
                                 device='cpu')
    np.testing.assert_array_equal([o.flux for o in objs], t['flux'])


def test_aperture_sums_against_two_r6_calls(scene):
    """The pipeline's and the filter's r=6 rms and bad-pixel sums in one
    two-plane pass, against two r=6 calls of the JAX package (its 'flux',
    no rms, no mask)."""
    rms = scene['rms_data']
    bpm = ((scene['mask_data'].astype(np.int64) & BAD_SUM) > 0).astype('f4')
    x, y = scene_wcs().sky2pix_0(scene['ra'], scene['dec'])
    x, y = np.asarray(x, 'f4'), np.asarray(y, 'f4')
    sa, sb = tops.aperture_sums((torch.from_numpy(rms),
                                 torch.from_numpy(bpm)), torch.from_numpy(x),
                                torch.from_numpy(y), r=6.0)
    for got, plane in ((sa, rms), (sb, bpm)):
        want = np.asarray(j_ap(jnp.asarray(plane), None, None,
                               jnp.asarray(x), jnp.asarray(y),
                               r=6.0)['flux'])
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert float(sb.max()) > 0


def test_none_planes_are_zeros(scene):
    """rms and mask may be None (zeros), as in the JAX package."""
    img = torch.from_numpy(scene['img'])
    x = torch.tensor([30.2, 100.7, 2.0], dtype=torch.float32)
    y = torch.tensor([40.9, 200.1, 128.0], dtype=torch.float32)
    a = tops.aperture_photometry_batched(img, None, None, x, y)
    b = tops.aperture_photometry_batched(
        img, torch.zeros_like(img), torch.zeros((H, W), dtype=torch.int32),
        x, y)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a['oob'].tolist() == [False, False, True]


def test_no_rows():
    """N = 0: every output empty, nothing raised."""
    img = torch.zeros((64, 64))
    e = torch.zeros(0)
    ph = tops.aperture_photometry_batched(img, img, None, e, e)
    assert all(v.shape == (0,) for v in ph.values())
    sa, sb = tops.aperture_sums((img, img), e, e)
    assert sa.shape == sb.shape == (0,)
    ref = measure.refine_detections(img, img, e, e, e, e, e, e)
    assert len(ref) == 11 and all(v.shape == (0,) for v in ref.values())


def test_forced_photometry_magnitudes():
    for flux, err, zp in ((1234.5, 33.0, 26.3), (0.0, 1.0, 26.3),
                          (-5.0, 2.0, 25.0), (np.nan, 1.0, 26.0)):
        t = tphot.ForcedPhotometry(flux=flux, fluxerr=err, zp=zp)
        j = jphot.ForcedPhotometry(flux=flux, fluxerr=err, zp=zp)
        np.testing.assert_array_equal([t.mag, t.magerr], [j.mag, j.magerr])
    t = tphot.ForcedPhotometry(flux=1000.0, fluxerr=10.0, zp=26.0)
    assert t.mag == pytest.approx(26.0 - 7.5)
    assert t.magerr == pytest.approx(0.010857)


def test_lazy_namespace():
    for name in ('aperture_photometry', 'raw_aperture_photometry',
                 'ForcedPhotometry'):
        assert name in dir(zuds_tpu_torch)
        assert getattr(zuds_tpu_torch, name) is getattr(tphot, name)


def test_entry_points_default_to_the_card(scene, tmp_path):
    """Without a device the three entry points mean the card: on a
    machine without one they raise and name ``device='cpu'``."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: device=None is the card')
    img = TSci.from_file(fresh_copy(scene, tmp_path, 'torch'))
    ra, dec = scene['ra'][:3], scene['dec'][:3]
    for call in (lambda: tphot.raw_aperture_photometry(
                     scene['sci'], scene['rms'], scene['mask'], ra, dec),
                 lambda: tphot.aperture_photometry(img, ra, dec),
                 lambda: img.force_photometry(list(zip(ra, dec)))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_a_cpu_call_leaves_the_image_on_the_card(scene, tmp_path):
    """device='cpu' holds for its call only: the products it derives are
    computed there, the image keeps ``device=None``, and a later call
    without a device still means the card (here it raises)."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: device=None is the card')
    img = TSci.from_file(fresh_copy(scene, tmp_path, 'torch'))
    ra, dec = scene['ra'][:3], scene['dec'][:3]
    tphot.aperture_photometry(img, ra, dec, device='cpu')
    assert img.device is None
    for call in (lambda: tphot.aperture_photometry(img, ra, dec),
                 lambda: img.force_photometry(list(zip(ra, dec)))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def negpix_full_frame(diff, xs, ys, big=13):
    """The pipeline's negpix veto as it stood before H14 took it: the
    full-frame 3x3 max, the -5/+5 test, the 11x11 OR dilation and one
    gather at each candidate's window centre."""
    dsub = diff[::4, ::4]
    dmed = frame_median(dsub)
    dmad = frame_median(dsub, center=dmed)
    dsig = torch.clamp(1.48 * dmad, min=1e-12)
    Hf, Wf = diff.shape
    half = big // 2
    x0 = torch.clamp(torch.round(xs).to(torch.int64) - half, 0, Wf - big)
    y0 = torch.clamp(torch.round(ys).to(torch.int64) - half, 0, Hf - big)
    s_full = (diff - dmed) / dsig
    m3 = dilate_max(s_full, 1)
    badpx = ((s_full < -5.0) & (m3 > 5.0)).to(torch.float32)
    or11 = dilate_max(badpx, half - 1, fill=0.0)
    return or11[y0 + half, x0 + half] > 0.0


def test_negpix_stencil_equals_the_full_frame_form(monkeypatch):
    """The slice's det_negpix through the per-candidate stencil
    (``negpix_veto_plain``, H14's plain version) is bit-equal to the
    full-frame form on a frame with dipoles at all four edges, in the
    corners and inside, and candidates on and beside each."""
    Hf, Wf = 96, 130
    rng = np.random.default_rng(11)
    diff = rng.normal(0, 5.0, (Hf, Wf)).astype('f4')
    sites = [(0, 40), (1, 90), (Hf - 1, 20), (Hf - 2, 100), (30, 0),
             (60, 1), (45, Wf - 1), (70, Wf - 2), (0, 0), (Hf - 1, Wf - 1),
             (0, Wf - 1), (Hf - 1, 0), (48, 64), (20, 30)]
    for y, x in sites:
        diff[y, x] = -60.0
        diff[y, min(x + 1, Wf - 1) if x < Wf - 1 else x - 1] = 60.0
    xs, ys = [], []
    for y, x in sites:
        for dy, dx in ((0, 0), (3, -4), (-6, 5), (7, 7), (-0.5, 0.5)):
            xs.append(x + dx)
            ys.append(y + dy)
    xs += list(rng.uniform(-3, Wf + 2, 60))
    ys += list(rng.uniform(-3, Hf + 2, 60))
    xs = torch.tensor(xs, dtype=torch.float32)
    ys = torch.tensor(ys, dtype=torch.float32)
    d = torch.from_numpy(diff)
    want = negpix_full_frame(d, xs, ys)
    calls = []
    monkeypatch.setattr(tp, 'negpix_veto',
                        lambda *a: calls.append(1)
                        or cutouts.negpix_veto_plain(*a))
    pipe = tp.SubtractDetectPipeline(tp.PipelineConfig(height=Hf, width=Wf))
    got = pipe._negpix(d, xs, ys)
    assert calls == [1]
    assert torch.equal(got, want)
    assert 20 < int(want.sum()) < len(xs) - 20
