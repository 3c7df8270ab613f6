"""The rest of the port's surface against the JAX package on the CPU:

* the config reader (``secrets.parse_config``) against ``yaml.safe_load``
  on generated config lines: where it takes a line it gives yaml's value,
  else it raises ``ValueError``; every scalar form of YAML 1.1 it is meant
  to take (null, booleans in their three cases, decimal integers, floats
  with exponents, ``.inf`` and ``.nan``, quoted and bare strings) is
  taken; ``load_config`` reads with yaml where yaml imports;
* ``tracing``: spans, ``report`` and ``print_time`` as the reference's,
  and ``device_profile`` writing a Chrome trace of a CPU op;
* ``sextractor``: the catalog and the check images in the order asked, an
  unknown type raising, ``prepare_sextractor`` equal;
* the display: ``zscale_limits`` bit-equal, ``FITSImage``'s colormap
  helpers and ``show``, ``plotting``'s three functions drawing what the
  reference draws, and ``ImportError`` without matplotlib in both;
* ``Thumbnail.persist`` without matplotlib: the PNG decodes to the
  stamp's zscale rendering, the levels matplotlib's gray colormap gives;
  ``thumb.persist_all`` over a database;
* ``control/archive_daemon``: both packages' daemon on copies of one
  sqlite database and one hot tier: the same rows, members and bytes, the
  restored files byte-equal;
* ``catalog.PipelineRegionFile``, ``File.unmap``/``clear``,
  ``FITSFile.load_header``/``unload``, ``utils``' helpers, ``download``
  with a stand-in ``requests`` module (no network), and
  ``ScienceImage.ipac_path``.
"""
import contextlib
import io
import os
import random
import shutil
import sqlite3
import sys
import tarfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from control import archive_daemon as jdaemon  # noqa: E402
from zuds_tpu import catalog as jcatalog, core as jcore  # noqa: E402
from zuds_tpu import download as jdownload, file as jfile  # noqa: E402
from zuds_tpu import image as jimage, model_util as jmu  # noqa: E402
from zuds_tpu import plotting as jplotting, secrets as jsecrets  # noqa
from zuds_tpu import sextractor as jsex, thumbnails as jthumbs  # noqa
from zuds_tpu import tracing as jtracing, utils as jutils  # noqa: E402
from zuds_tpu_torch import catalog as tcatalog, core as tcore  # noqa
from zuds_tpu_torch import demo, download as tdownload  # noqa: E402
from zuds_tpu_torch import file as tfile, image as timage  # noqa: E402
from zuds_tpu_torch import model_util as tmu, plotting as tplotting  # noqa
from zuds_tpu_torch import secrets as tsecrets, sextractor as tsex  # noqa
from zuds_tpu_torch import thumb as tthumb, thumbnails as tthumbs  # noqa
from zuds_tpu_torch import tracing as ttracing, utils as tutils  # noqa
from zuds_tpu_torch.control import archive_daemon as tdaemon  # noqa: E402

torch.set_num_threads(2)


# ---- the config reader --------------------------------------------------

SCALARS = {
    'null': ['', '~', 'null', 'Null', 'NULL'],
    'bool': [w for word in ('yes', 'no', 'true', 'false', 'on', 'off')
             for w in (word, word.capitalize(), word.upper())],
    'int': ['0', '7', '-3', '+12', '1024', '-0'],
    'float': ['1.5', '-2.25', '+0.5', '1.', '10.', '.5', '1.5e+3',
              '2.E-4', '-3.0e+10', '.5e-2', '.inf', '-.inf', '+.inf',
              '.Inf', '-.INF', '.nan', '.NaN', '.NAN'],
    'string': ['abc', 'some words here', '/p#q', '~/x.db', 'sqlite',
               "'1.5'", '"quoted # not a comment"', "'yes'", 'yEs',
               'nULL', 'Infinity', 'a, b', 'x-y_z', 'b[1]'],
}
# forms the reader refuses: yaml reads some of them as numbers or
# collections, others are not YAML at all
REFUSED = ['0x1f', '012', '1_000', '1:30', '1e3', '1.5e3', '-.5',
           '127.0.0.1', '{b: 1}', '[1, 2]', '@x', '*alias', '&a v', '!tag x',
           '"unterminated', 'b: c', '"esc\\n"', '- item', '%x', '|', '>']
COMMENTS = ['', '  # a comment', ' #c']


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        return np.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize('form', sorted(SCALARS))
def test_config_reader_takes_every_scalar_form(form):
    for raw in SCALARS[form]:
        for tail in COMMENTS if raw[:1] not in '\'"' else ['']:
            text = f'key: {raw}{tail}\n'
            got = tsecrets.parse_config(text)['key']
            want = yaml.safe_load(text)['key']
            assert _same(got, want), (text, got, want)


def test_config_reader_refuses_other_forms():
    for raw in REFUSED:
        with pytest.raises(ValueError, match='config line 1'):
            tsecrets.parse_config(f'key: {raw}\n')
    for bad in ('a:\n  b: 1\n', 'true: 1\n', '1: x\n', '"a": 1\n', 'a\n',
                'a:b\n', '---\na: 1\n', 'a: yes\t# tab\n'):
        with pytest.raises(ValueError):
            tsecrets.parse_config(bad)


@pytest.mark.parametrize('seed', range(4))
def test_config_reader_on_generated_documents(seed):
    """Documents of 40 generated lines: where the reader takes one it gives
    ``yaml.safe_load``'s dict, value for value."""
    rng = random.Random(seed)
    pool = [v for vs in SCALARS.values() for v in vs]
    taken = 0
    for _ in range(25):
        lines = []
        for i in range(40):
            raw = rng.choice(pool + REFUSED if rng.random() < 0.1 else pool)
            tail = rng.choice(COMMENTS) if raw[:1] not in '\'"' else ''
            lines.append(f'k{i}_{rng.choice("abc")}: {raw}{tail}')
            if rng.random() < 0.1:
                lines.append(rng.choice(['# a comment line', '']))
        text = '\n'.join(lines) + '\n'
        try:
            got = tsecrets.parse_config(text)
        except ValueError:
            continue
        want = yaml.safe_load(text)
        assert list(got) == list(want)
        for k in want:
            assert _same(got[k], want[k]), (k, got[k], want[k])
        taken += 1
    assert taken >= 5


def test_load_config_reads_with_yaml(tmp_path, monkeypatch):
    """With yaml the whole file goes through ``yaml.safe_load`` (a nested
    value too); without it the subset reader raises on that value."""
    cfg = tmp_path / 'config.yaml'
    cfg.write_text('a: 1.5\nmesh_shape: {data: 4}\nflag: on\n')
    os.chmod(cfg, 0o600)
    monkeypatch.setenv('ZUDS_CONFIG', str(cfg))
    for pkg in (tsecrets, jsecrets):
        pkg._manager.cache = None
    try:
        want = jsecrets.load_config(reload=True)
        assert tsecrets.load_config(reload=True) == want
        assert want['mesh_shape'] == {'data': 4} and want['flag'] is True
        monkeypatch.setitem(sys.modules, 'yaml', None)
        with pytest.raises(ValueError, match='flow-style'):
            tsecrets.load_config(reload=True)
    finally:
        for pkg in (tsecrets, jsecrets):
            pkg._manager.cache = None


# ---- tracing --------------------------------------------------------------

def test_tracing_spans_and_report(capsys):
    outs = {}
    for pkg in (jtracing, ttracing):
        pkg.reset()
        with pkg.timed('a'):
            pass
        with pkg.timed('a'):
            pass

        @pkg.traced()
        def work(x):
            return x + 1

        assert work(1) == 2
        pkg._record('fixed', 2.0)
        pkg.print_time(1.0, 3.5, 'obj', 'step')
        snap = pkg.spans()
        assert snap['a'][0] == 2 and snap['fixed'] == (1, 2.0, 2.0, 2.0)
        assert snap['step'] == (1, 2.5, 2.5, 2.5)
        assert 'test_tracing_spans_and_report.<locals>.work' in snap
        pkg.reset()
        pkg._record('x', 1.25)
        pkg._record('x', 0.75)
        buf = io.StringIO()
        pkg.report(buf)
        outs[pkg.__name__] = buf.getvalue()
        pkg.reset()
    assert outs['zuds_tpu.tracing'] == outs['zuds_tpu_torch.tracing']
    printed = capsys.readouterr().out.splitlines()
    assert printed == ['took 2.50 sec to step for obj'] * 2


def test_device_profile_writes_a_trace(tmp_path):
    with ttracing.device_profile(str(tmp_path / 'trace')) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any('mm' in e.key for e in prof.key_averages())
    text = (tmp_path / 'trace' / 'trace.json').read_text()
    assert 'traceEvents' in text and 'aten::' in text


# ---- images: sextractor, display ----------------------------------------

@pytest.fixture(scope='module')
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp('surface')
    epochs, sci = demo.make_night(str(d), 256, 256, nepochs=1)
    return d, sci, epochs[0]


@pytest.fixture(scope='module')
def extracted(frames):
    img = timage.ScienceImage.from_file(frames[1])
    img.device = 'cpu'
    return img, tsex.run_sextractor(img, ['rms', 'segm', 'bkgsub', 'bkg'])


def test_run_sextractor_products(extracted):
    img, res = extracted
    assert len(res) == 5
    cat, rms, segm, bkgsub, bkg = res
    assert isinstance(cat, tcatalog.PipelineFITSCatalog) and cat.image is img
    assert img.catalog is cat or len(img.catalog.data) == len(cat.data)
    assert rms is img.rms_image and segm is img.segm_image
    assert bkgsub is img.background_subtracted_image
    assert bkg is img.background_image
    assert len(cat.data) > 10 and int(np.asarray(segm.data).max()) >= 1
    with pytest.raises(ValueError, match='unknown checkimage'):
        tsex.run_sextractor(img, ['rms', 'aper'])
    for kw in ({}, {'checkimage_type': ['rms']}):
        assert tsex.prepare_sextractor(img, **kw) \
            == jsex.prepare_sextractor(img, **kw)


@pytest.mark.parametrize('case', ['stars', 'flat', 'nan', 'tiny'])
def test_zscale_limits_bit_equal(frames, case):
    from zuds_tpu_torch.fits import read_fits
    data = read_fits(frames[1])[0].data.astype('f4')
    data = {'stars': data, 'flat': np.full((20, 20), 3.0, 'f4'),
            'nan': np.where(data > 400, np.nan, data),
            'tiny': data[:2, :3]}[case]
    assert timage.zscale_limits(data) == jimage.zscale_limits(data)


def test_display_helpers_draw_what_the_reference_draws(frames):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    _, sci, _ = frames
    timg = timage.ScienceImage.from_file(sci)
    jimg = jimage.ScienceImage.from_file(sci)
    assert timg.datatype == jimg.datatype == 'float'
    assert timg.cmap_limits() == jimg.cmap_limits()
    assert timg.cmap() == jimg.cmap() == 'gray'
    seg = tfile.File()
    for pkg, cls in ((tplotting, timage.FITSImage),
                     (jplotting, jimage.FITSImage)):
        lab = cls()
        lab.data = np.arange(12, dtype=np.int32).reshape(3, 4) % 5
        assert lab.datatype == 'int' and lab.cmap_limits() == (None, None)
        assert lab.cmap().N == 5
        seg = (seg, lab)
    np.testing.assert_array_equal(tplotting.discrete_cmap(7).colors,
                                  jplotting.discrete_cmap(7).colors)
    figs = {}
    for name, img, plotting in (('torch', timg, tplotting),
                                ('jax', jimg, jplotting)):
        f1 = img.show()
        f2 = plotting.show_images([img, img], titles=['a', 'b'])
        f3 = plotting.plot_triplet(np.arange(63 * 63 * 3, dtype='f4')
                                   .reshape(63, 63, 3))
        figs[name] = [[(ax.get_title(), [np.asarray(im.get_array())
                                         for im in ax.get_images()],
                        [im.get_clim() for im in ax.get_images()])
                       for ax in f.axes] for f in (f1, f2, f3)]
        for f in (f1, f2, f3):
            plt.close(f)
    for ft, fj in zip(figs['torch'], figs['jax']):
        assert len(ft) == len(fj)
        for (tt, ti, tc), (jt, ji, jc) in zip(ft, fj):
            assert tt == jt and tc == jc
            for a, b in zip(ti, ji):
                np.testing.assert_array_equal(a, b)


def test_display_raises_without_matplotlib(monkeypatch, frames):
    for mod in ('matplotlib', 'matplotlib.pyplot', 'matplotlib.colors',
                'matplotlib.patches'):
        monkeypatch.setitem(sys.modules, mod, None)
    timg = timage.ScienceImage.from_file(frames[1])
    jimg = jimage.ScienceImage.from_file(frames[1])
    for plotting, img in ((tplotting, timg), (jplotting, jimg)):
        with pytest.raises(ImportError):
            plotting.discrete_cmap(3)
        with pytest.raises(ImportError):
            plotting.show_images([img])
        with pytest.raises(ImportError):
            plotting.plot_triplet(np.zeros((63, 63, 3)))
        with pytest.raises(ImportError):
            img.show()


# ---- thumbnails -----------------------------------------------------------

def _stamp(seed=0):
    rng = np.random.default_rng(seed)
    s = rng.normal(100, 5, (63, 63)).astype('f4')
    s[30:33, 28:31] += 400
    s[0, 0] = np.nan
    return s


def test_persist_without_matplotlib_writes_the_zscale_levels(
        tmp_path, monkeypatch):
    from matplotlib import colors
    stamp = _stamp()
    vmin, vmax = jimage.zscale_limits(stamp)
    # the levels are the indices matplotlib's Normalize and a 256-entry
    # colormap give (read through a colormap whose entries are i / 256)
    lut = colors.ListedColormap(np.stack([np.arange(256) / 256] * 3, 1))
    index = np.round(lut(colors.Normalize(vmin, vmax)(stamp))[..., 0]
                     * 256).astype(np.uint8)
    ok = np.isfinite(stamp)
    want = tthumbs.gray_levels(stamp, vmin, vmax)
    np.testing.assert_array_equal(want[ok], index[ok])
    assert (want[~ok] == 0).all()
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    t = tthumbs.Thumbnail(type='sub', detection_id=12)
    t.stamp = stamp
    path = t.persist(str(tmp_path))
    assert t.png_kind == 'zlib' and t.file_uri == path
    assert os.path.basename(path) == 'thumb_sub_12.png'
    px = tthumbs.read_png_gray(path)
    np.testing.assert_array_equal(px, want[::-1])
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(path)), px)


def test_persist_all_over_a_database(tmp_path, monkeypatch):
    """dothumb's loop: every unpersisted thumbnail of the bound database
    gets its PNG and ``file_uri``, a stamp read back from the row's bytes
    (the reference's path for a thumbnail read from the database)."""
    from zuds_tpu_torch.fits import HDU, Header, fits_bytes
    import gzip
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    tmu.init_db(database=str(tmp_path / 'z.db'))
    try:
        tmu.create_tables()
        sess = tcore.DBSession()
        for i in range(3):
            raw = fits_bytes([HDU(Header(), _stamp(i))])
            sess.add(tthumbs.Thumbnail(type='new', detection_id=i + 1,
                                       bytes=gzip.compress(raw)))
        sess.commit()
        assert tthumb.persist_all(str(tmp_path / 'png')) == 3
        rows = sess.query(tthumbs.Thumbnail).order_by('id').all()
        for i, t in enumerate(rows):
            assert t.file_uri.endswith(f'thumb_new_{i + 1}.png')
            stamp = _stamp(i)
            np.testing.assert_array_equal(
                tthumbs.read_png_gray(t.file_uri),
                tthumbs.gray_levels(stamp,
                                    *jimage.zscale_limits(stamp))[::-1])
        assert tthumb.persist_all(str(tmp_path / 'png')) == 0
    finally:
        for s in (tcore.DBSession, tcore.RefDBSession):
            s.remove()
            s.configure(None)


# ---- the archive daemon ---------------------------------------------------

@contextlib.contextmanager
def _bound(mu, core, secrets, db, hot, tmp_path, tag):
    cfg = tmp_path / f'config_{tag}'
    cfg.write_text(f'base_data_directory: {hot}\n')
    os.chmod(cfg, 0o600)
    old = os.environ.get('ZUDS_CONFIG')
    os.environ['ZUDS_CONFIG'] = str(cfg)
    secrets._manager.cache = None
    mu.init_db(database=str(db))
    try:
        yield core.DBSession()
    finally:
        for s in (core.DBSession, core.RefDBSession):
            s.remove()
            s.configure(None)
        secrets._manager.cache = None
        if old is None:
            os.environ.pop('ZUDS_CONFIG')
        else:
            os.environ['ZUDS_CONFIG'] = old


def test_archive_daemon_matches_the_reference(tmp_path, frames):
    hot = tmp_path / 'hot'
    hot.mkdir()
    names = []
    for i, src in enumerate((frames[1], frames[2])):
        base = f'ztf_{i}_sciimg.fits'
        shutil.copyfile(src, hot / base)
        names.append(base)
    db0 = tmp_path / 'seed.db'
    with _bound(tmu, tcore, tsecrets, db0, hot, tmp_path, 'seed') as sess:
        tmu.create_tables()
        for kind, base in (('sci', names[0]), ('sci', names[1]),
                           ('ref', 'ztf_ref.fits')):
            sess.add(tcore.ZTFFile(type=kind, basename=base))
        sess.commit()
    out = {}
    for tag, mu, core, secrets, daemon in (
            ('jax', jmu, jcore, jsecrets, jdaemon),
            ('torch', tmu, tcore, tsecrets, tdaemon)):
        db = tmp_path / f'{tag}.db'
        shutil.copyfile(db0, db)
        cold, back = tmp_path / f'cold_{tag}', tmp_path / f'back_{tag}'
        with _bound(mu, core, secrets, db, hot, tmp_path, tag) as sess:
            tar = daemon.archive_to_cold(sess, str(cold))
            again = daemon.archive_to_cold(sess, str(cold))
            restored = daemon.retrieve_from_cold(
                sess, names + ['ztf_nowhere.fits'], str(cold), str(back))
            loc = daemon.media_locator([tar, str(tmp_path / 'none')])
        con = sqlite3.connect(db)
        rows = {t: con.execute(
            f'SELECT * FROM {t} ORDER BY id').fetchall()
            for t in ('tapecopies', 'tapearchives')}
        con.close()
        with tarfile.open(tar) as tf:
            members = [(m.name, tf.extractfile(m).read())
                       for m in tf.getmembers()]
        out[tag] = dict(tar=tar, again=again, restored=restored, loc=loc,
                        rows=rows, members=members)
    j, t = out['jax'], out['torch']
    assert j['again'] is None and t['again'] is None
    assert [m[0] for m in t['members']] == [m[0] for m in j['members']] \
        == names
    assert t['members'] == j['members']
    for path, name in zip(t['restored'], names):
        assert os.path.basename(path) == name
        assert Path(path).read_bytes() == (hot / name).read_bytes()
    assert [os.path.basename(p) for p in j['restored']] == names
    assert list(t['loc']) == [t['tar']] and list(j['loc']) == [j['tar']]

    def strip(rows):
        # ids, kinds, members; the tarball's name carries the unix time,
        # the archive its size and the time stamps
        return [tuple(v for v in r if not isinstance(v, str)
                      or not v.startswith(('zuds_', '20'))) for r in rows]

    for table in ('tapecopies', 'tapearchives'):
        assert len(t['rows'][table]) == len(j['rows'][table])
    assert strip(t['rows']['tapecopies']) == strip(j['rows']['tapecopies'])


# ---- the data model's smaller pieces --------------------------------------

def test_region_file_bytes(tmp_path, extracted):
    cat = extracted[1][0]
    cat.data['GOODCUT'][::2] = 1
    for pkg in (tcatalog, jcatalog):
        c = (cat if pkg is tcatalog else jcatalog.PipelineFITSCatalog())
        c.data = cat.data
        c.basename = 'x.cat'
        tag = 'torch' if pkg is tcatalog else 'jax'
        c.map_to_local_file(str(tmp_path / f'{tag}.cat'))
        reg = pkg.PipelineRegionFile.from_catalog(c)
        assert reg.basename == 'x.reg'
        assert reg.local_path == str(tmp_path / f'{tag}.reg')
    a = (tmp_path / 'torch.reg').read_bytes()
    b = (tmp_path / 'jax.reg').read_bytes()
    assert a == b and a.count(b'color=green') > 0
    reg = tcatalog.PipelineRegionFile.from_catalog(
        cat, path=str(tmp_path / 'y.reg'))
    reg.content = ''
    reg.load()
    assert reg.content.encode() == a


def test_file_unmap_and_clear(frames):
    for fpkg, ipkg in ((tfile, timage), (jfile, jimage)):
        f = fpkg.File('a.fits')
        f.map_to_local_file('/x/a.fits')
        assert f.ismapped
        f.unmap()
        assert not f.ismapped
        f.unmap()
        with pytest.raises(fpkg.UnmappedFileError):
            f.local_path
        img = ipkg.ScienceImage.from_file(frames[1])
        data = np.array(img.data)
        img._rmsimg = 'cached'
        hdr = img.header
        img.clear()
        assert not hasattr(img, '_rmsimg') and not img.ismapped
        assert img.header is hdr
        img = ipkg.ScienceImage.from_file(frames[1])
        img.data
        img.unload()
        assert not hasattr(img, '_data')
        np.testing.assert_array_equal(img.data, data)
        img.header = None
        img.load_header()
        assert img.header['FIELDID'] == 679


def test_utils_helpers(tmp_path, capsys, frames):
    d = tmp_path / 'w'
    (d / 'sub').mkdir(parents=True)
    (d / 'sub' / 'f').write_text('x')
    for pkg in (tutils, jutils):
        p = pkg.initialize_directory(d)
        assert p == d and p.is_dir() and not any(p.iterdir())
        (d / 'sub').mkdir()
    img = timage.ScienceImage.from_file(frames[1])
    for out in ('mjd', 'jd'):
        assert tutils.get_time(img, out) == jutils.get_time(img, out)
        assert tutils.get_time(img.header, out) == jutils.get_time(img, out)
    for pkg in (tutils, jutils):
        with pytest.raises(ValueError, match='output'):
            pkg.get_time(img, 'iso')
        pkg.print_time(0.0, 1.234, 'obj', 'warp')
        with pkg.Timer('t', quiet=False) as t:
            pass
        assert t.elapsed >= 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[2] == 'took 1.23 sec to warp obj'
    assert lines[1].startswith('[t] ') and lines[3].startswith('[t] ')
    assert tutils.fid_map == jutils.fid_map


def test_ipac_path(frames):
    paths = []
    for ipkg in (timage, jimage):
        img = ipkg.ScienceImage.from_file(frames[1])
        paths.append(img.ipac_path('sciimg.fits'))
        assert img.obsdate == '2018-08-15'
    assert paths[0] == paths[1]


# ---- download, with a stand-in requests module ----------------------------

class _Requests(types.ModuleType):
    """A stand-in ``requests``: ``get`` fails ``fails`` times, then
    answers ``content``; ``post`` answers ``cookies``."""

    def __init__(self, fails, cookies=None):
        super().__init__('requests')
        self.fails, self.calls = fails, []
        self.cookies = cookies if cookies is not None else {
            'JOSSO_SESSIONID': 'abc'}

    def get(self, url, cookies=None, timeout=None):
        self.calls.append(('get', url, cookies, timeout))
        if len(self.calls) <= self.fails:
            raise ConnectionError('down')
        return types.SimpleNamespace(content=b'FITS' + url.encode(),
                                     raise_for_status=lambda: None)

    def post(self, url, data=None):
        self.calls.append(('post', url, data))
        return types.SimpleNamespace(cookies=self.cookies)


@pytest.mark.parametrize('fails,raise_exc', [(0, True), (2, True),
                                             (5, True), (5, False)])
def test_safe_download_retries(tmp_path, monkeypatch, fails, raise_exc):
    out = {}
    for pkg in (jdownload, tdownload):
        req = _Requests(fails)
        sleeps = []
        monkeypatch.setitem(sys.modules, 'requests', req)
        monkeypatch.setattr(pkg.time, 'sleep', sleeps.append)
        dest = tmp_path / f'{pkg.__name__}.fits'
        if fails >= 5 and raise_exc:
            with pytest.raises(ConnectionError):
                pkg.safe_download('http://x/y', str(dest), cookie={'c': 1})
            got = 'raised'
        else:
            got = pkg.safe_download('http://x/y', str(dest), cookie={'c': 1},
                                    raise_exc=raise_exc)
            got = got and Path(got).read_bytes()
        out[pkg.__name__] = (got, req.calls, sleeps)
    assert out['zuds_tpu.download'] == out['zuds_tpu_torch.download']


def test_ipac_authenticate(tmp_path, monkeypatch):
    cfg = tmp_path / 'config'
    cfg.write_text('ipac_username: me\nipac_password: pw\n')
    os.chmod(cfg, 0o600)
    monkeypatch.setenv('ZUDS_CONFIG', str(cfg))
    try:
        for cookies, exc in (({'JOSSO_SESSIONID': 'a'}, None),
                             ({}, ValueError)):
            got = []
            for pkg, sec in ((jdownload, jsecrets), (tdownload, tsecrets)):
                sec._manager.cache = None
                req = _Requests(0, cookies)
                monkeypatch.setitem(sys.modules, 'requests', req)
                if exc:
                    with pytest.raises(exc):
                        pkg.ipac_authenticate()
                else:
                    assert pkg.ipac_authenticate() == cookies
                got.append(req.calls)
            assert got[0] == got[1]
        cfg.write_text('ipac_username: me\n')
        for pkg, sec in ((jdownload, jsecrets), (tdownload, tsecrets)):
            sec._manager.cache = None
            with pytest.raises(RuntimeError, match='not configured'):
                pkg.ipac_authenticate()
        monkeypatch.setitem(sys.modules, 'requests', None)
        for pkg in (jdownload, tdownload):
            with pytest.raises(RuntimeError, match='requests'):
                pkg.safe_download('http://x', str(tmp_path / 'n'))
    finally:
        for sec in (jsecrets, tsecrets):
            sec._manager.cache = None
