"""The port's per-pair align against the JAX package on the CPU: the
gather warps (H10's plain versions), the host warp plan and its windowed
execution, ``align_image``/``aligned_to`` on an image and on a mask, and the
small WCS and mask helpers that come with them. Shapes <= 256^2, inputs
from a numpy seed, the JAX outputs computed once per module.

Tolerances (docs/PARITY_CONTRACT.md, Lanczos-3 warp): pixels rtol 3e-5,
atol 5e-3 counts; masks and coverage are integer decisions and equal. The
plan is host float64 arithmetic and equal. ``warp_image_mask`` thresholds
its computed weights in the reference where the port (and the reference's
own ``warp_mask``) tests the intervals those thresholds were solved into:
the test counts the pixels where the two forms differ on the seed scene.
"""
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu import align as jalign
from zuds_tpu import swarp as jswarp
from zuds_tpu.fits import Header as JHeader
from zuds_tpu.image import FITSImage as JImage
from zuds_tpu.mask import MaskImage as JMask
from zuds_tpu.ops import resample as jr
from zuds_tpu.wcs import TPVWCS as JWCS
from zuds_tpu.wcs import pixel_mapping as jmapping
from zuds_tpu_torch import align as talign
from zuds_tpu_torch import swarp as tswarp
from zuds_tpu_torch.fits import Header as THeader
from zuds_tpu_torch.image import FITSImage as TImage
from zuds_tpu_torch.mask import MaskImage as TMask
from zuds_tpu_torch.ops import resample as tr
from zuds_tpu_torch.wcs import TPVWCS as TWCS
from zuds_tpu_torch.wcs import pixel_mapping as tmapping

torch.set_num_threads(2)

HS, WS = 200, 180          # source
HO, WO = 160, 224          # output: another shape than the source's
SCALE = 1.01 / 3600.0
PIX = dict(rtol=3e-5, atol=5e-3)


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope='module')
def scene():
    """A source frame with stars and a sparse 18-bit mask, and a rotated,
    sheared mapping from the output grid into it that leaves the source on
    two sides."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:HS, 0:WS]
    img = (150.0 + 20 * np.sin(xx / 7.0) * np.cos(yy / 11.0)
           + rng.normal(0, 5, (HS, WS))).astype('f4')
    for _ in range(15):
        x0, y0 = rng.uniform(10, WS - 10), rng.uniform(10, HS - 10)
        img += (4e3 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 4.5)
                ).astype('f4')
    wgt = rng.uniform(0.01, 0.05, (HS, WS)).astype('f4')
    bits = rng.integers(0, 1 << 18, (HS, WS))
    mask = np.where(rng.random((HS, WS)) < 0.03, bits, 0).astype('i4')
    oy, ox = np.mgrid[0:HO, 0:WO].astype('f4')
    th = np.deg2rad(7.0)
    u = (np.cos(th) * ox - 1.02 * np.sin(th) * oy + 20.3).astype('f4')
    v = (np.sin(th) * ox + np.cos(th) * oy - 15.7 + 0.01 * ox).astype('f4')
    ju, jv = jnp.asarray(u), jnp.asarray(v)
    jmask = jnp.asarray(mask).astype(jnp.uint32)
    ref = dict(
        image=jr.warp_image(jnp.asarray(img), ju, jv),
        mask=jr.warp_mask(jmask, ju, jv),
        image_mask=jr.warp_image_mask(jnp.asarray(img), jmask, ju, jv),
        weight=jr.warp_image(jnp.asarray(wgt), ju, jv))
    return dict(img=img, wgt=wgt, mask=mask, u=u, v=v, ref=ref)


def test_warp_image(scene):
    out, cov = tr.warp_image(T(scene['img']), T(scene['u']), T(scene['v']))
    jout, jcov = scene['ref']['image']
    assert out.shape == (HO, WO) and 0.3 < float(cov.mean()) < 0.9
    np.testing.assert_array_equal(cov.numpy(), np.asarray(jcov))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **PIX)
    assert (out.numpy()[np.asarray(jcov) == 0] == 0).all()


def test_warp_mask(scene):
    m = tr.warp_mask(T(scene['mask']), T(scene['u']), T(scene['v']))
    jm = np.asarray(scene['ref']['mask'])
    assert m.dtype == torch.int32 and (jm != 0).sum() > 500
    np.testing.assert_array_equal(m.numpy(), jm.astype(np.int32))


def test_warp_image_mask(scene):
    """Pixels and coverage as ``warp_image``'s; the mask equal to the
    reference's except where its threshold form differs from the interval
    test, which this scene does not hit."""
    out, m, cov = tr.warp_image_mask(T(scene['img']), T(scene['mask']),
                                     T(scene['u']), T(scene['v']))
    jout, jm, jcov = scene['ref']['image_mask']
    np.testing.assert_array_equal(cov.numpy(), np.asarray(jcov))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **PIX)
    # the reference's two forms against each other, then the port's
    forms = int((np.asarray(jm) != np.asarray(scene['ref']['mask'])).sum())
    differ = int((m.numpy() != np.asarray(jm).astype(np.int32)).sum())
    assert differ == forms == 0
    np.testing.assert_array_equal(
        m.numpy(), tr.warp_mask(T(scene['mask']), T(scene['u']),
                                T(scene['v'])).numpy())


def test_warp_gather_shares_one_mapping(scene):
    """Two planes and the mask in one call equal the single calls."""
    a, b, m, cov = tr.warp_gather(T(scene['img']), T(scene['mask']),
                                  T(scene['u']), T(scene['v']),
                                  img2=T(scene['wgt']))
    one, c1 = tr.warp_image(T(scene['img']), T(scene['u']), T(scene['v']))
    assert torch.equal(a, one) and torch.equal(cov, c1)
    np.testing.assert_allclose(b.numpy(),
                               np.asarray(scene['ref']['weight'][0]),
                               rtol=3e-5, atol=1e-6)
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(scene['ref']['mask']).astype(np.int32))
    none = tr.warp_gather(None, T(scene['mask']), T(scene['u']),
                          T(scene['v']))
    assert none[0] is None and none[1] is None and torch.equal(none[2], m)


def test_warp_image_gates_a_nonfinite_tap_as_the_reference_does(scene):
    """The reference's coverage gate is written as a product, which XLA
    folds into a select: a NaN in a clamped window outside the coverage
    comes out as 0, in both packages."""
    img = scene['img'].copy()
    img[2:8, 2:8] = np.nan
    u = np.full((4, 4), -20.0, 'f4')
    v = np.full((4, 4), -20.0, 'f4')
    jout, jcov = jr.warp_image(jnp.asarray(img), jnp.asarray(u),
                               jnp.asarray(v))
    out, cov = tr.warp_image(T(img), T(u), T(v))
    assert not np.asarray(jcov).any() and not cov.numpy().any()
    assert (np.asarray(jout) == 0).all() and (out.numpy() == 0).all()


def _wcs(cls, crpix, rot=0.0, scale=SCALE):
    return cls.simple(crval=(150.1, 35.2), crpix=crpix, scale_deg=scale,
                      rot_deg=rot)


PLANS = {
    # a small dither and rotation of a frame of the output's shape: the
    # edge nodes of the grid fall outside the source
    'plan': dict(crpix=(128.5 + 1.4, 128.5 - 0.8), rot=0.03,
                 src=(256, 256), want=(1, -1, 2)),
    # a smaller source inside the output (a union grid)
    'plan_embedded': dict(crpix=(90.5 + 0.6, 100.5 - 0.3), rot=0.05,
                          src=(200, 180), want=(-37, -28, 2)),
    # a 4 px dither of a same-shape frame: the rolled reads of its edge
    # nodes leave the canvas
    'canvas': dict(crpix=(128.5 + 4.6, 128.5 - 3.2), rot=0.03,
                   src=(256, 256), want=None),
    # a rotation whose residual passes 8 px
    'residual': dict(crpix=(128.5, 128.5), rot=6.0, src=(256, 256),
                     want=None),
    # nothing of the output lands in the source
    'none': dict(crpix=(128.5 + 900.0, 128.5), rot=0.0, src=(256, 256),
                 want=None),
}
OUT = (256, 256)


def _grids(case):
    p = PLANS[case]
    return (jmapping(_wcs(JWCS, p['crpix'], p['rot']),
                     _wcs(JWCS, (128.5, 128.5)), OUT),
            tmapping(_wcs(TWCS, p['crpix'], p['rot']),
                     _wcs(TWCS, (128.5, 128.5)), OUT))


@pytest.mark.parametrize('case', sorted(PLANS))
def test_plan_warp(case):
    p = PLANS[case]
    jg, tg = _grids(case)
    jplan = jr.plan_warp(jg, OUT, p['src'])
    tplan = tr.plan_warp(tg, OUT, p['src'])
    assert tplan == jplan == p['want']


@pytest.mark.parametrize('case', ['plan', 'plan_embedded'])
def test_warp_planned(case):
    """All three outputs of the planned warp, for a source of the output's
    shape and for a smaller one embedded in the canvas."""
    rng = np.random.default_rng(5)
    src = PLANS[case]['src']
    img = rng.normal(150, 20, src).astype('f4')
    mask = np.where(rng.random(src) < 0.03,
                    rng.integers(0, 1 << 16, src), 0).astype('i4')
    jg, _ = _grids(case)
    plan = jr.plan_warp(jg, OUT, src)
    ju, jv = jr.upsample_mapping(jnp.asarray(jg.u), jnp.asarray(jg.v),
                                 jg.shape, jg.step)
    jo, jm, jc = jr.warp_planned(jnp.asarray(img),
                                 jnp.asarray(mask).astype(jnp.uint32), ju, jv,
                                 plan, OUT)
    u, v = T(ju), T(jv)
    to, tm, tc = tr.warp_planned(T(img), T(mask), u, v, plan, OUT)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm).astype(np.int32))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **PIX)
    assert 0 < float(tc.mean()) < 1 and (np.asarray(jm) != 0).sum() > 100
    two = tr.warp_planned(T(img), T(mask), u, v, plan, OUT, img2=T(img) * 2)
    assert len(two) == 4 and torch.equal(two[0], to)
    np.testing.assert_allclose(two[1].numpy(), 2 * to.numpy(), rtol=1e-6,
                               atol=1e-4)


def _frames(pkg, rot, crpix, basename='ztf_ref_sciimg.fits'):
    """(image, mask image, target) objects of ``pkg`` over one seed scene:
    a 200x180 source on a rotated WCS and a 240x256 target grid."""
    wcs_cls, hdr_cls, img_cls, mask_cls = {
        'jax': (JWCS, JHeader, JImage, JMask),
        'torch': (TWCS, THeader, TImage, TMask)}[pkg]
    rng = np.random.default_rng(9)
    data = rng.normal(150, 20, (HS, WS)).astype('f4')
    mdata = np.where(rng.random((HS, WS)) < 0.03,
                     rng.integers(0, 1 << 16, (HS, WS)), 0).astype(np.uint16)

    def make(cls, arr, wcs, name, **cards):
        h = hdr_cls()
        wcs.to_header(h)
        h.set('NAXIS1', arr.shape[1])
        h.set('NAXIS2', arr.shape[0])
        for k, val in cards.items():
            h.set(k.replace('_', '-'), val)
        obj = cls()
        obj.header = h
        obj.data = arr
        obj.basename = name
        return obj

    src_wcs = _wcs(wcs_cls, crpix, rot)
    cards = dict(MAGZP=26.3, SEEING=2.1, OBSMJD=58300.0, FILTERID=2,
                 SATURATE=6e4, FIELDID=679, CCDID=1, QID=2, MJD_OBS=58300.0,
                 EXPTIME=30.0, GAIN=6.2)
    image = make(img_cls, data, src_wcs, basename, **cards)
    mask = make(mask_cls, mdata, src_wcs,
                basename.replace('sciimg', 'mskimg'), **cards)
    target = make(img_cls, np.zeros((HT, WT), 'f4'),
                  _wcs(wcs_cls, (128.5, 120.5)),
                  'ztf_target_sciimg.fits', MAGZP=25.0, AIRMASS=1.3)
    return image, mask, target


HT, WT = 240, 256          # the align tests' target grid


@pytest.mark.parametrize('route,rot,crpix', [
    ('planned', 0.05, (WS / 2 + 1.1, HS / 2 + 0.2)),
    ('gather', 9.0, (WS / 2 + 0.5, HS / 2 + 0.5))])
def test_align_image_and_mask(route, rot, crpix):
    jimg, jmask, jtarget = _frames('jax', rot, crpix)
    timg, tmask, ttarget = _frames('torch', rot, crpix)
    plan = tr.plan_warp(timg.mapping_to(ttarget), (HT, WT), (HS, WS))
    assert (plan is not None) == (route == 'planned')
    for jsrc, tsrc in ((jimg, timg), (jmask, tmask)):
        ja = jsrc.aligned_to(jtarget)
        ta = tsrc.aligned_to(ttarget, device='cpu')
        assert type(ta).__name__ == type(ja).__name__
        assert ta.basename == ja.basename
        assert ta.basename.endswith('_aligned_to_ztf_target_sciimg.remap.fits')
        assert ta.parent_image is tsrc and ta.data.shape == (HT, WT)
        np.testing.assert_array_equal(ta.coverage, np.asarray(ja.coverage))
        assert 0 < ta.coverage.mean() < 1
        if tsrc is tmask:
            assert ta.data.dtype == np.int32
            np.testing.assert_array_equal(ta.data, np.asarray(ja.data))
            assert ((ta.data >> 16 & 1) == (ta.coverage == 0)).all()
        else:
            np.testing.assert_allclose(ta.data, np.asarray(ja.data), **PIX)
        # the carried keywords are the source's, the rest the target's
        for key in talign.CARRIED_KEYS:
            assert (key in ta.header) == (key in ja.header), key
            if key in ta.header:
                assert ta.header[key] == ja.header[key] == tsrc.header[key]
        assert ta.header['AIRMASS'] == 1.3 and 'GAIN' not in ta.header
        assert ta.header['NAXIS1'] == WT and ta.header['NAXIS2'] == HT
        assert ta.wcs is ttarget.wcs


def test_align_entry_points_and_persist(tmp_path):
    timg, tmask, ttarget = _frames('torch', 5.0, (WS / 2 + .5, HS / 2 + .5))
    jimg, jmask, jtarget = _frames('jax', 5.0, (WS / 2 + .5, HS / 2 + .5))
    a = tswarp.run_align(timg, ttarget, device='cpu')
    b = talign.align_image(timg, ttarget, device='cpu')
    np.testing.assert_array_equal(a.data, b.data)
    for tsrc, jsrc in ((timg, jimg), (tmask, jmask)):
        tp_ = tswarp.prepare_swarp_align(tsrc, ttarget)
        jp_ = jswarp.prepare_swarp_align(jsrc, jtarget)
        assert tp_['combine'] == jp_['combine']
        assert tp_['outname'] == jp_['outname']
    assert tswarp.prepare_swarp_mask([tmask], 'm.fits') == \
        jswarp.prepare_swarp_mask([jmask], 'm.fits')
    tsci = tswarp.prepare_swarp_sci([timg], 'c.fits')
    jsci = jswarp.prepare_swarp_sci([jimg], 'c.fits')
    assert tsci == jsci and timg.header['FLXSCALE'] == jimg.header['FLXSCALE']
    # persist_aligned writes beside a mapped source
    timg.map_to_local_file(str(tmp_path / timg.basename))
    out = timg.aligned_to(ttarget, persist_aligned=True, device='cpu')
    path = tmp_path / out.basename
    assert path.exists()
    np.testing.assert_array_equal(TImage.from_file(str(path)).data, out.data)
    for fn in (talign.align_image, tswarp.run_align):
        assert list(inspect.signature(fn).parameters)[-1] == 'device'
    assert list(inspect.signature(talign.align_image).parameters)[:3] == \
        list(inspect.signature(jalign.align_image).parameters)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA card'):
            timg.aligned_to(ttarget)


def test_update_from_weight_map_contains_mapping_to():
    timg, tmask, ttarget = _frames('torch', 5.0, (WS / 2 + .5, HS / 2 + .5))
    jimg, jmask, jtarget = _frames('jax', 5.0, (WS / 2 + .5, HS / 2 + .5))
    rng = np.random.default_rng(2)
    wmap = np.where(rng.random((HS, WS)) < 0.2, 0.0, 1.0).astype('f4')
    tmask.boolean, jmask.boolean            # cached projections are dropped
    tmask.update_from_weight_map(wmap)
    jmask.update_from_weight_map(wmap)
    assert tmask.data.dtype == np.int32 and not hasattr(tmask, '_boolean')
    np.testing.assert_array_equal(tmask.data, np.asarray(jmask.data))
    assert ((tmask.data >> 16 & 1) == (wmap == 0)).all()
    holder = TImage()
    holder.data = wmap
    again = _frames('torch', 5.0, (WS / 2 + .5, HS / 2 + .5))[1]
    again.update_from_weight_map(holder)
    np.testing.assert_array_equal(again.data, tmask.data)

    ra = 150.1 + rng.uniform(-0.05, 0.05, 200)
    dec = 35.2 + rng.uniform(-0.04, 0.04, 200)
    inside = timg.contains(ra, dec)
    np.testing.assert_array_equal(inside, jimg.contains(ra, dec))
    assert 0 < inside.sum() < 200
    tg, jg = timg.mapping_to(ttarget, step=16), jimg.mapping_to(jtarget,
                                                                step=16)
    assert tg.step == jg.step == 16 and tg.shape == jg.shape
    np.testing.assert_array_equal(tg.u, jg.u)
    np.testing.assert_array_equal(tg.v, jg.v)
