"""The port's TPV WCS (``zuds_tpu_torch/wcs``) against the JAX package's
on the real ZTF quadrant header of ``tests/data/ztf_real_header.json``
(degree-4 TPV): construction, both directions of the transform and the
coarse mapping grids of ``pixel_mapping``, all bit-equal (the port keeps
the reference's float64 numpy arithmetic verbatim)."""
import json
from pathlib import Path

import numpy as np
import pytest

from zuds_tpu.fits import Header as JHeader
from zuds_tpu.wcs import TPVWCS as JW
from zuds_tpu.wcs import pixel_mapping as jmap
from zuds_tpu_torch.fits import Header as THeader
from zuds_tpu_torch.wcs import TPVWCS as TW
from zuds_tpu_torch.wcs import pixel_mapping as tmap

REAL = json.loads((Path(__file__).resolve().parent / 'data'
                   / 'ztf_real_header.json').read_text())


def real_wcs(cls, hcls, crpix_shift=(0.0, 0.0)):
    h = hcls()
    for k, v in {**REAL['wcs'], **REAL['meta']}.items():
        h.set(k, v)
    h.set('CRPIX1', h['CRPIX1'] + crpix_shift[0])
    h.set('CRPIX2', h['CRPIX2'] + crpix_shift[1])
    return cls.from_header(h)


def same_wcs(a, b):
    for f in ('crpix', 'crval', 'cd', 'pv1', 'pv2'):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def test_from_header_equal():
    t, j = real_wcs(TW, THeader), real_wcs(JW, JHeader)
    same_wcs(t, j)
    assert np.count_nonzero(t.pv1) > 3      # a real distortion
    assert t.pixel_scale_arcsec() == j.pixel_scale_arcsec()
    assert t.to_header().items() == j.to_header().items()


def test_transforms_bit_equal():
    t, j = real_wcs(TW, THeader), real_wcs(JW, JHeader)
    rng = np.random.default_rng(0)
    x = rng.uniform(-50, 3122, 500)
    y = rng.uniform(-50, 3130, 500)
    for a, b in zip(t.pix2sky_0(x, y), j.pix2sky_0(x, y)):
        np.testing.assert_array_equal(a, b)
    ra, dec = j.pix2sky_0(x, y)
    for a, b in zip(t.sky2pix_0(ra, dec), j.sky2pix_0(ra, dec)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.footprint(3072, 3080),
                                  j.footprint(3072, 3080))


@pytest.mark.parametrize('src', ['dither_tpv', 'linear', 'simple_rot'])
@pytest.mark.parametrize('shape,step', [((3080, 3072), 32), ((256, 200), 32),
                                        ((97, 131), 16)])
def test_pixel_mapping_bit_equal(src, shape, step):
    """dst: the real TPV header; src: the same dithered by a few pixels
    (the Newton inverse), the same with linear PV (the closed-form path of
    a coadd's WCS), or a rotated simple TAN WCS."""
    dst_t, dst_j = real_wcs(TW, THeader), real_wcs(JW, JHeader)
    if src == 'dither_tpv':
        src_t = real_wcs(TW, THeader, (2.1, -1.7))
        src_j = real_wcs(JW, JHeader, (2.1, -1.7))
    elif src == 'linear':
        lin = np.zeros(40)
        lin[1] = 1.0
        src_t = TW(dst_t.crpix + [2.1, -1.7], dst_t.crval.copy(),
                   dst_t.cd.copy(), lin, lin.copy())
        src_j = JW(dst_j.crpix + [2.1, -1.7], dst_j.crval.copy(),
                   dst_j.cd.copy(), lin, lin.copy())
    else:
        src_t = TW.simple(dst_t.crval, dst_t.crpix + 3.3, 1.01 / 3600, 0.4)
        src_j = JW.simple(dst_j.crval, dst_j.crpix + 3.3, 1.01 / 3600, 0.4)
    gt = tmap(src_t, dst_t, shape, step=step)
    gj = jmap(src_j, dst_j, shape, step=step)
    assert gt.u.dtype == gj.u.dtype == np.float32
    np.testing.assert_array_equal(gt.u, gj.u)
    np.testing.assert_array_equal(gt.v, gj.v)
    assert gt.shape == gj.shape and gt.step == gj.step
    assert gt.max_offset == gj.max_offset
