"""The port's FITS codec (``zuds_tpu_torch/fits``) and the JAX package's
read each other's files: f32, uint16 (BZERO 32768) and int32 images and a
binary table, headers card-equal (keys, values and comments, long strings
through CONTINUE, COMMENT and HISTORY) and data bit-equal; the image
hierarchy's header reflection against the reference's."""
import numpy as np
import pytest

from zuds_tpu import fits as jf
from zuds_tpu.image import ScienceImage as JSci
from zuds_tpu_torch import fits as tf
from zuds_tpu_torch.image import ScienceImage as TSci
from zuds_tpu_torch.mask import MaskImage

CODECS = {'jax': jf, 'torch': tf}


def header(mod):
    h = mod.Header()
    h.set('OBJECT', "ZTF field 679 'q2'", 'target')
    h.set('EXPTIME', 30.0, 'seconds')
    h.set('SEEING', 2.0469999313354492)
    h.set('FIELDID', 679)
    h.set('FLAG', True)
    h.set('LONGSTR', 'x' * 150 + "'quoted'", 'continues over cards')
    h.set('TINY', 1.2345678901234567e-300)
    h.add_comment('a comment card')
    h.add_history('a history card')
    return h


def images(rng):
    return {
        'f32': rng.normal(150, 5, (37, 53)).astype('f4'),
        'u16': rng.integers(0, 65536, (31, 29)).astype(np.uint16),
        'i32': rng.integers(-2 ** 31, 2 ** 31 - 1, (17, 19)).astype('i4'),
    }


def table(rng):
    dt = [('NUMBER', 'i4'), ('X', 'f4'), ('RA', 'f8'), ('FLAGS', 'i2'),
          ('GOOD', '?'), ('NAME', 'S12'), ('BIG', 'i8'), ('VEC', 'f4', (3,))]
    t = np.zeros(23, dtype=dt)
    t['NUMBER'] = np.arange(23)
    t['X'] = rng.normal(size=23)
    t['RA'] = rng.uniform(0, 360, 23)
    t['FLAGS'] = rng.integers(-5, 5, 23)
    t['GOOD'] = rng.random(23) < 0.5
    t['NAME'] = [f'src{i}'.encode() for i in range(23)]
    t['BIG'] = rng.integers(-2 ** 40, 2 ** 40, 23)
    t['VEC'] = rng.normal(size=(23, 3))
    return t


def same_header(a, b):
    assert a.keys() == b.keys()
    for k in a.keys():
        assert a[k] == b[k], k
        assert a.comments.get(k, '') == b.comments.get(k, ''), k
    assert a._history == b._history and a._commentary == b._commentary


@pytest.mark.parametrize('kind', ['f32', 'u16', 'i32'])
@pytest.mark.parametrize('writer,reader', [('torch', 'jax'),
                                           ('jax', 'torch')])
def test_images_cross_read(tmp_path, kind, writer, reader):
    rng = np.random.default_rng(1)
    data = images(rng)[kind]
    w, r = CODECS[writer], CODECS[reader]
    path = str(tmp_path / f'{kind}.fits')
    w.write_fits(path, [w.HDU(header(w), data)])
    got = r.read_fits(path)
    want = w.read_fits(path)
    assert len(got) == len(want) == 1
    assert got[0].data.dtype == data.dtype == want[0].data.dtype
    assert got[0].data.dtype.isnative
    np.testing.assert_array_equal(got[0].data, data)
    same_header(got[0].header, want[0].header)
    assert got[0].header['LONGSTR'] == 'x' * 150 + "'quoted'"
    same_header(r.read_header(path), w.read_header(path))
    # byte-identical files from the two writers
    path2 = str(tmp_path / f'{kind}_2.fits')
    r.write_fits(path2, [r.HDU(header(r), data)])
    with open(path, 'rb') as f1, open(path2, 'rb') as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize('writer,reader', [('torch', 'jax'),
                                           ('jax', 'torch')])
def test_table_cross_read(tmp_path, writer, reader):
    rng = np.random.default_rng(2)
    t = table(rng)
    w, r = CODECS[writer], CODECS[reader]
    path = str(tmp_path / 'cat.fits')
    w.write_fits(path, [w.table_to_hdu(t, header(w))])
    got = [h for h in r.read_fits(path) if h.is_table]
    want = [h for h in w.read_fits(path) if h.is_table]
    assert len(got) == len(want) == 1
    assert got[0].data.dtype == want[0].data.dtype
    for name in t.dtype.names:
        np.testing.assert_array_equal(got[0].data[name], t[name],
                                      err_msg=name)
    same_header(got[0].header, want[0].header)


def test_header_cards_format_identically():
    for key, value, comment in [('A', 1.0, ''), ('B', -0.0, 'x'),
                                ('C', 1e-30, ''), ('D', 'a' * 70, 'long'),
                                ('E', False, ''), ('F', 12345678901, ''),
                                ('COMMENT', 'text', ''), ('G', None, 'u')]:
        assert tf.header.format_card(key, value, comment) \
            == jf.header.format_card(key, value, comment)
    for card in ["KEY     = 'it''s'   / c", 'NUM     = 1.5D3',
                 'HISTORY something', 'NOVALUE  text', 'E       = -2']:
        card = card.ljust(80)
        # each package has its own UNDEFINED singleton: compare reprs
        assert repr(tf.header.parse_card(card)) \
            == repr(jf.header.parse_card(card))


def test_science_image_reflects_the_header_as_the_reference(tmp_path):
    rng = np.random.default_rng(3)
    h = tf.Header()
    for k, v in dict(FIELDID=679, CCDID=4, QID=2, FILTERID=3,
                     OBSJD=2458345.5, SEEING=2.4, CRPIX1=10.0, CRPIX2=12.0,
                     CRVAL1=150.1, CRVAL2=35.2, CD1_1=-2.8e-4, CD1_2=0.0,
                     CD2_1=0.0, CD2_2=2.8e-4, EXPTIME=30.0,
                     FILENAME='ztf_20180815123456_000679_zi_c04_o_q2_'
                              'sciimg.fits').items():
        h.set(k, v)
    path = str(tmp_path / 'ztf_x_sciimg.fits')
    tf.write_fits(path, [tf.HDU(h, rng.normal(size=(40, 30)).astype('f4'))])
    tf.write_fits(path.replace('sciimg', 'mskimg'),
                  [tf.HDU(h.copy(), np.zeros((40, 30), np.uint16))])
    t = TSci.from_file(path)
    j = JSci.from_file(path, use_existing_record=False)
    for a in ('field', 'ccdid', 'qid', 'fid', 'filtercode', 'imgtypecode',
              'filefracday', 'obsjd', 'seeing', 'exptime', 'ra', 'dec',
              'ra1', 'dec4', 'basename', 'local_path', 'shape',
              'pixel_scale', 'magzp', 'apcor'):
        assert getattr(t, a) == getattr(j, a), a
    assert isinstance(t.mask_image, MaskImage)
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.mask_image.data, j.mask_image.data)
    # the derived products: the port's background mesh on the CPU
    # against the reference's (the mesh statistics agree to rtol 1e-4,
    # tests/test_torch_background.py; the weight squares the rms)
    t.device = 'cpu'
    np.testing.assert_allclose(t.rms_image.data, j.rms_image.data, rtol=1e-4)
    np.testing.assert_allclose(t.weight_image.data, j.weight_image.data,
                               rtol=2e-4)
    np.testing.assert_allclose(t.background_subtracted_image.data,
                               j.background_subtracted_image.data,
                               rtol=0, atol=1e-4)


def test_mask_legend_and_boolean_match_the_reference():
    from zuds_tpu.mask import MaskImage as JMask
    rng = np.random.default_rng(4)
    data = rng.integers(0, 1 << 18, (20, 20)).astype(np.int32)
    t, j = MaskImage(), JMask()
    for m in (t, j):
        m.data = data
        m.basename = 'x.mask.fits'
        m.refresh_bit_mask_entries_in_header()
    same_header(t.header, j.header)
    np.testing.assert_array_equal(t.boolean.data, j.boolean.data)
    assert t.boolean.basename == j.boolean.basename
