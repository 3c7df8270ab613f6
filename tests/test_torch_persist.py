"""The port's database commits against the JAX package's on the CPU, on
``tests/test_donight.py``'s scene at 256^2 (20 stars, a reference dithered
by (+9.6, -6.2) px, two science frames with a planted transient each).

One set of numpy pipeline outputs (the port's ``SubtractDetectPipeline`` on
the CPU: no JAX pipeline compiles here) goes through both packages'
``night._commit_frame`` at ``db=True``, each package in its own copy of the
scene and with its own sqlite file, the images taken by ``from_file`` (so
each carries the id of its ``sci``/``ref`` record). Compared:

- the ``ztffiles``, ``detections`` and ``thumbnails`` rows column by
  column, equal but for the created and modified times and the gzip
  header (``gzip.compress`` stamps the time): the thumbnails decompress to
  the same FITS bytes, and each ``sub`` stamp is the 63x63 cut of the
  frame at the detection;
- each database answers the other package's ``unphotometered_sources`` and
  ``overlapping_subtractions`` as it answers its own: the port's file to
  the reference's functions and the reference's file to the port's;
- ``phot.do_one`` against the reference's ``dophot.do_one`` on one
  subtraction: the same sources and ids, ``zp``, ``obsjd`` and filter
  equal, flux and fluxerr within ``aperture_photometry``'s tolerances
  (rtol 1e-5, atol 1e-3, ``tests/test_torch_photometry.py``);
- ``from_file(use_existing_record=True)`` takes the newest record's id in
  both packages, and not with ``use_existing_record=False``;
- ``Coadd.from_images`` with a database bound writes the same record and
  ``CoaddImage`` joins (its combine is stubbed in both packages: the stack
  itself is ``tests/test_torch_coadd.py``'s);
- ``MultiEpochSubtraction.from_images`` without ``input_subtractions``
  fails alike in both: the records the query returns are not images.
"""
import csv
import gzip
import io
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'scripts'))

import donight as jnight  # noqa: E402
import dophot as jdophot  # noqa: E402
from zuds_tpu import coadd as jcoadd, core as jcore  # noqa: E402
from zuds_tpu import model_util as jmu, secrets as jsecrets  # noqa: E402
from zuds_tpu import subtraction as jsubtraction  # noqa: E402
from zuds_tpu import thumbnails as jthumbs  # noqa: E402
from zuds_tpu.coadd import ReferenceImage as JRef  # noqa: E402
from zuds_tpu.image import ScienceImage as JSci  # noqa: E402
from zuds_tpu.parallel import PipelineConfig as JConfig  # noqa: E402
from zuds_tpu.source import ForcedPhotometryRecord as JFP  # noqa: E402
from zuds_tpu.source import Source as JSource  # noqa: E402
from zuds_tpu_torch import coadd as tcoadd, core as tcore  # noqa: E402
from zuds_tpu_torch import filterobjects as tfilter  # noqa: E402
from zuds_tpu_torch import inputs, phot as tphot  # noqa: E402
from zuds_tpu_torch import model_util as tmu, secrets as tsecrets  # noqa
from zuds_tpu_torch import night as tnight  # noqa: E402
from zuds_tpu_torch import subtraction as tsubtraction  # noqa: E402
from zuds_tpu_torch import thumbnails as tthumbs  # noqa: E402
from zuds_tpu_torch.coadd import ReferenceImage as TRef  # noqa: E402
from zuds_tpu_torch.detections import Detection as TDetection  # noqa: E402
from zuds_tpu_torch.fits import HDU, Header, read_fits, write_fits  # noqa
from zuds_tpu_torch.image import ScienceImage as TSci  # noqa: E402
from zuds_tpu_torch.parallel import pipeline as tp  # noqa: E402
from zuds_tpu_torch.source import ForcedPhotometryRecord as TFP  # noqa
from zuds_tpu_torch.source import Source as TSource  # noqa: E402
from zuds_tpu_torch.wcs import TPVWCS  # noqa: E402

torch.set_num_threads(2)

H = W = 256
SCALE = 1.01 / 3600.0
KW = dict(height=H, width=W, ksize=9, stamp=25, smax=36, order=1, nreg=1,
          max_det=384, box=64)
TRANSIENT_FLUX = 25000.0
RTOL, ATOL = 1e-5, 1e-3         # aperture_photometry's (test_torch_photometry)
PKGS = {
    'jax': dict(core=jcore, mu=jmu, secrets=jsecrets, night=jnight,
                sci=JSci, ref=JRef, coadd=jcoadd, sub=jsubtraction,
                source=JSource, fp=JFP, cfg=JConfig,
                unphot=jdophot.unphotometered_sources),
    'torch': dict(core=tcore, mu=tmu, secrets=tsecrets, night=tnight,
                  sci=TSci, ref=TRef, coadd=tcoadd, sub=tsubtraction,
                  source=TSource, fp=TFP, cfg=tp.PipelineConfig,
                  unphot=tphot.unphotometered_sources),
}


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


def write_pair_frame(path, data, wcs, mjd, seeing):
    h = Header()
    wcs.to_header(h)
    for k, v in dict(MAGZP=26.3, OBSMJD=mjd, OBSJD=mjd + 2400000.5,
                     FIELDID=679, CCDID=1, QID=2, FILTERID=2,
                     SATURATE=60000.0, APCOR4=-0.05, SEEING=seeing,
                     FILTER='ZTF_r').items():
        h.set(k, v)
    h.set('FILENAME', 'ztf_20180815000000_000679_zr_c01_o_q2_sciimg.fits')
    write_fits(path, [HDU(h, data)])
    write_fits(path.replace('sciimg', 'mskimg'),
               [HDU(h.copy(), np.zeros(data.shape, np.uint16))])


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    """tests/test_donight.py's scene: both science frames with SEEING."""
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp('persist')
    xs = rng.uniform(20, W - 20, 20)
    ys = rng.uniform(20, H - 20, 20)
    fluxes = rng.uniform(5000, 80000, 20)
    wcs_sci = TPVWCS.simple(crval=(150.1, 35.2),
                            crpix=(W / 2 + 0.5, H / 2 + 0.5), scale_deg=SCALE)
    wcs_ref = TPVWCS.simple(crval=(150.1, 35.2),
                            crpix=(W / 2 + 0.5 + 9.6, H / 2 + 0.5 - 6.2),
                            scale_deg=SCALE)
    ra, dec = wcs_sci.pix2sky_0(xs, ys)
    rx, ry = wcs_ref.sky2pix_0(ra, dec)
    write_pair_frame(str(d / 'ztf_dither_ref_sciimg.fits'),
                     render(rx, ry, fluxes, 1.6, rng), wcs_ref, 58300.0, 1.6)
    truths = []
    for i, (tx, ty) in enumerate([(60.0, 200.0), (200.0, 100.0)]):
        while np.hypot(xs - tx, ys - ty).min() < 20:
            tx += 9.0
        truths.append((tx, ty))
        write_pair_frame(str(d / f'ztf_night{i}_sciimg.fits'),
                         render(xs, ys, fluxes, 2.3, rng,
                                (tx, ty, TRANSIENT_FLUX)),
                         wcs_sci, 58345.0 + 0.01 * i, 2.3)
    return d, np.asarray(truths)


def _paths(d):
    return ([str(d / f'ztf_night{i}_sciimg.fits') for i in (0, 1)],
            str(d / 'ztf_dither_ref_sciimg.fits'))


@pytest.fixture(scope='module')
def outputs(scene):
    """The port's pipeline outputs for both pairs (one batch) as numpy."""
    d, _ = scene
    cfg = tp.PipelineConfig(**KW)
    scis, rp = _paths(d)
    read = (lambda p: next(h for h in read_fits(p) if h.data is not None))
    frames = []
    for sp in scis:
        sci = tnight._image_from_hdu(TSci, sp, read(sp),
                                     read(sp.replace('sciimg', 'mskimg')))
        ref = tnight._image_from_hdu(TRef, rp, read(rp),
                                     read(rp.replace('sciimg', 'mskimg')))
        frames.append(tp.prepare_frame_inputs(sci, ref, cfg, device='cpu'))
    args = [torch.stack([f[k] for f in frames]) for k in inputs.INPUT_NAMES]
    out = tp.SubtractDetectPipeline(cfg)(*args)
    return {k: v.numpy() for k, v in out.items()}


def bind(pkg, path):
    """Bind ``pkg``'s sessions to the sqlite file ``path``."""
    PKGS[pkg]['mu'].init_db(database=str(path))


def unbind():
    for p in PKGS.values():
        for s in (p['core'].DBSession, p['core'].RefDBSession):
            s.remove()
            s.configure(None)


@pytest.fixture(scope='module')
def dbs(scene, outputs, tmp_path_factory):
    """Each package, in its own copy of the scene and with its own sqlite
    file: ``sci``/``ref`` records of the frames, both frames committed by
    ``_commit_frame(db=True)`` on images read by ``from_file`` (so the
    ``sesub`` records carry target and reference ids), a coadd of the two
    science frames with its joins, and sources: one a detection and 64
    seeded positions over the frame (``inputs.forced_positions``, seed
    13), a forced photometry row already there for three of them."""
    d, truths = scene
    base = tmp_path_factory.mktemp('persist_dbs')
    config = os.environ.get('ZUDS_CONFIG')
    os.environ['ZUDS_CONFIG'] = str(base / 'config.yaml')
    res = {}
    try:
        for pkg, p in PKGS.items():
            p['secrets']._manager.cache = None
            dd = base / pkg
            shutil.copytree(d, dd)
            db = base / f'{pkg}.db'
            bind(pkg, db)
            p['mu'].create_tables()
            sess = p['core'].DBSession()
            scis, rp = _paths(dd)
            for path, kind in [(s, 'sci') for s in scis] + [(rp, 'ref')]:
                img = p[kind].from_file(path)
                rec = p['core'].record_from_image(img, kind)
                sess.add(rec)
                sess.commit()
            cfg = p['cfg'](**KW)
            subs, rows, cats = [], [], []
            for b, sp in enumerate(scis):
                sci = p['sci'].from_file(sp)
                ref = p['ref'].from_file(rp)

                def thunk(b=b):
                    return (outputs['diff'][b], outputs['rms'][b],
                            outputs['submask'][b].astype(np.uint32))

                kw = {'device': 'cpu'} if pkg == 'torch' else {}
                sub, dets = p['night']._commit_frame(
                    sci, ref, outputs, b, thunk, cfg, ml=False, db=True, **kw)
                subs.append(sub)
                rows.append(dets)
                cats.append(sub.catalog)
            stack = coadd_stubbed(p, scis, str(dd / 'stack_sciimg.fits'))
            sub0 = p['sci'].from_file(subs[0].local_path)
            ra, dec, kind = inputs.forced_positions(
                sub0.wcs, H, W, 64, truths[0], (truths[:, 0], truths[:, 1]),
                seed=13)
            sources = [p['source'](id=f'F{i:03d}', ra=float(r),
                                   dec=float(dd_))
                       for i, (r, dd_) in enumerate(zip(ra, dec))]
            dets = sess.query(p['core'].MODELS['detections']) \
                .order_by('id').all()
            sources += [p['source'](id=f'D{x.id:03d}', ra=x.ra, dec=x.dec)
                        for x in dets]
            sess.add_all(sources)
            sess.add_all([p['fp'](source_id=f'F{i:03d}',
                                  image_id=sub0.id, flux=1.0)
                          for i in (1, 2, 3)])
            sess.commit()
            res[pkg] = dict(dir=dd, db=db, subs=subs, rows=rows, cats=cats,
                            stack=stack, kind=kind)
            unbind()
    finally:
        unbind()
        for p in PKGS.values():
            p['secrets']._manager.cache = None
    yield res
    if config is None:
        os.environ.pop('ZUDS_CONFIG', None)
    else:
        os.environ['ZUDS_CONFIG'] = config


def coadd_stubbed(p, scis, out):
    """``ScienceCoadd.from_images`` of the science frames with a database
    bound, the combine replaced by a constant frame (the records and joins
    are under test, not the stack)."""
    mod = p['coadd']

    def fused(images, wcs, H, W, *a, **k):
        return (np.full((H, W), 1.0, 'f4'), np.ones((H, W), 'f4'),
                np.zeros((H, W), np.int64))

    keep = mod._coadd_fused
    mod._coadd_fused = fused
    try:
        images = [p['sci'].from_file(s) for s in scis]
        kw = {'device': 'cpu'} if p['sci'] is TSci else {}
        return mod.ScienceCoadd.from_images(images, out,
                                            calculate_seeing=False, **kw)
    finally:
        mod._coadd_fused = keep


def table(db, name):
    import sqlite3
    conn = sqlite3.connect(db)
    conn.row_factory = sqlite3.Row
    try:
        rows = conn.execute(f'SELECT * FROM {name} ORDER BY id').fetchall()
        return [{k: r[k] for k in r.keys()
                 if k not in ('created_at', 'modified')} for r in rows]
    finally:
        conn.close()


@pytest.mark.parametrize('name', ['ztffiles', 'detections', 'coadd_images',
                                  'sources', 'forcedphotometry'])
def test_rows_equal_column_by_column(dbs, name):
    j, t = table(dbs['jax']['db'], name), table(dbs['torch']['db'], name)
    assert len(t) == len(j) > 0
    for a, b in zip(t, j):
        if name == 'ztffiles':
            # the file records' header JSON and all else equal
            assert a.keys() == b.keys()
        assert a == b


def test_records_and_detections(dbs, scene):
    _, truths = scene
    rows = table(dbs['torch']['db'], 'ztffiles')
    kinds = [r['type'] for r in rows]
    assert kinds == ['sci', 'sci', 'ref', 'sesub', 'sesub', 'scicoadd']
    sci_ids = [r['id'] for r in rows if r['type'] == 'sci']
    ref_id = [r['id'] for r in rows if r['type'] == 'ref'][0]
    sesub = [r for r in rows if r['type'] == 'sesub']
    assert [r['target_id'] for r in sesub] == sci_ids
    assert [r['reference_id'] for r in sesub] == [ref_id] * 2
    dets = table(dbs['torch']['db'], 'detections')
    for i, r in enumerate(sesub):
        mine = [x for x in dets if x['image_id'] == r['id']]
        assert len(mine) == len(dbs['torch']['rows'][i]) >= 1
        tx, ty = truths[i]
        assert min(np.hypot(x['x_image'] - 1 - tx, x['y_image'] - 1 - ty)
                   for x in mine) < 2.0


def _fits(blob):
    raw = gzip.decompress(blob)
    hdu = read_fits(io.BytesIO(raw))[0]
    return raw, hdu


def test_thumbnails_decompress_equal(dbs):
    j = table(dbs['jax']['db'], 'thumbnails')
    t = table(dbs['torch']['db'], 'thumbnails')
    dets = {x['id']: x for x in table(dbs['torch']['db'], 'detections')}
    assert len(t) == len(j) == 3 * len(dets)
    subs = {r['id']: s for r, s in zip(
        [r for r in table(dbs['torch']['db'], 'ztffiles')
         if r['type'] == 'sesub'], dbs['torch']['subs'])}
    for a, b in zip(t, j):
        assert {k: v for k, v in a.items() if k != 'bytes'} == \
            {k: v for k, v in b.items() if k != 'bytes'}
        ra, ha = _fits(a['bytes'])
        rb, _ = _fits(b['bytes'])
        assert ra == rb
        assert ha.data.shape == (63, 63) and ha.header['STMPTYPE'] == a['type']
        if a['type'] == 'sub':
            det = dets[a['detection_id']]
            sub = subs[det['image_id']]
            want = tthumbs.make_stamp(None, det['ra'], det['dec'], None, None,
                                      np.asarray(sub.data), sub.wcs)
            np.testing.assert_array_equal(ha.data, want)


def test_thumbnail_matches_the_reference_writer(dbs, tmp_path):
    """One thumbnail built by each package from the same detection and
    frame: the same FITS bytes after decompression, and their persisted
    PNGs (both through matplotlib here) decode to the same pixels."""
    from PIL import Image
    sub = dbs['torch']['subs'][0]
    det = TDetection(ra=150.1, dec=35.2, id=7)
    a = tthumbs.Thumbnail.from_detection(det, sub, stamp_type='new')
    b = jthumbs.Thumbnail.from_detection(det, sub, stamp_type='new')
    assert gzip.decompress(a.bytes) == gzip.decompress(b.bytes)
    np.testing.assert_array_equal(a.stamp, b.stamp)
    pa = a.persist(str(tmp_path / 'torch'))
    pb = b.persist(str(tmp_path / 'jax'))
    assert a.png_kind == 'matplotlib'
    assert os.path.basename(pa) == os.path.basename(pb) == 'thumb_new_7.png'
    assert a.file_uri == pa and b.file_uri == pb
    np.testing.assert_array_equal(np.asarray(Image.open(pa)),
                                  np.asarray(Image.open(pb)))


@pytest.mark.parametrize('image', [0, 1])
def test_each_database_answers_both_unphotometered_queries(dbs, image):
    out = {}
    for owner in ('jax', 'torch'):
        sub = dbs['torch']['subs'][image]
        rec = [r for r in table(dbs[owner]['db'], 'ztffiles')
               if r['type'] == 'sesub'][image]
        for pkg in ('jax', 'torch'):
            bind(pkg, dbs[owner]['db'])
            try:
                out[owner, pkg] = PKGS[pkg]['unphot'](rec['id'],
                                                      sub.footprint())
            finally:
                unbind()
    first = out['jax', 'jax']
    assert all(v == first for v in out.values())
    ids = {s[0] for s in first}
    kind = dbs['torch']['kind']
    off = {f'F{i:03d}' for i in np.flatnonzero(kind == 'off')}
    assert ids and not ids & off
    if image == 0:
        assert not ids & {'F001', 'F002', 'F003'}
    else:
        assert {'F001', 'F002', 'F003'} <= ids


def test_each_database_answers_both_overlap_queries(dbs):
    got = {}
    for owner in ('jax', 'torch'):
        rows = table(dbs[owner]['db'], 'ztffiles')
        stack = [r for r in rows if r['type'] == 'scicoadd'][0]
        ref = [r for r in rows if r['type'] == 'ref'][0]
        for pkg in ('jax', 'torch'):
            bind(pkg, dbs[owner]['db'])
            try:
                recs = PKGS[pkg]['sub'].overlapping_subtractions(
                    type('S', (), {'id': stack['id']}),
                    type('R', (), {'id': ref['id']}))
                assert all(type(r).__name__ == 'ZTFFile' for r in recs)
                got[owner, pkg] = sorted((r.id, r.basename) for r in recs)
            finally:
                unbind()
    first = got['jax', 'jax']
    assert len(first) == 2 and all(v == first for v in got.values())
    for pkg in ('jax', 'torch'):
        with pytest.raises(RuntimeError, match='bound database'):
            PKGS[pkg]['sub'].overlapping_subtractions(None, None)


def test_multi_epoch_from_records_fails_alike(dbs):
    """Without input_subtractions the reference stacks the ZTFFile records
    the query returns; a record has no pixel scale, so both raise the same
    AttributeError."""
    errs = {}
    for pkg in ('jax', 'torch'):
        stack = dbs[pkg]['stack']
        bind(pkg, dbs[pkg]['db'])
        try:
            ref = PKGS[pkg]['ref'].from_file(
                str(dbs[pkg]['dir'] / 'ztf_dither_ref_sciimg.fits'))
            assert ref.id is not None and stack.id is not None
            with pytest.raises(AttributeError) as e:
                PKGS[pkg]['sub'].MultiEpochSubtraction.from_images(
                    stack, ref, **({'device': 'cpu'} if pkg == 'torch'
                                   else {}))
            errs[pkg] = str(e.value)
        finally:
            unbind()
    assert errs['torch'] == errs['jax'] and 'pixel_scale' in errs['jax']


def test_dophot_do_one_like_the_reference(dbs):
    rows = {}
    for pkg in ('jax', 'torch'):
        path = dbs[pkg]['subs'][1].local_path
        bind(pkg, dbs[pkg]['db'])
        try:
            f = io.StringIO()
            w = csv.writer(f)
            if pkg == 'jax':
                n = jdophot.do_one(path, w)
            else:
                st = {}
                n = tphot.do_one(path, w, device='cpu', stats=st)
                assert {'query_s', 'phot_s', 'write_s'} <= set(st)
            rows[pkg] = list(csv.reader(io.StringIO(f.getvalue())))
            assert n == len(rows[pkg]) > 3
        finally:
            unbind()
    j, t = rows['jax'], rows['torch']
    for a, b in zip(t, j):
        assert a[:4] == b[:4]              # source, image id, ra, dec
        assert a[6:] == b[6:]              # flags, zp, obsjd, filter
        for k in (4, 5):
            x, y = float(a[k]), float(b[k])
            assert np.isnan(x) == np.isnan(y)
            if not np.isnan(y):
                assert abs(x - y) <= ATOL + RTOL * abs(y), (a, b)
    assert t[0][-1] == 'ZTF_r' and t[0][1] == str(
        [r for r in table(dbs['torch']['db'], 'ztffiles')
         if r['type'] == 'sesub'][1]['id'])


def test_phot_main_merges_and_skips_the_measured(dbs, tmp_path):
    bind('torch', dbs['torch']['db'])
    try:
        work = tmp_path / 'subs.txt'
        work.write_text('\n'.join(s.local_path
                                  for s in dbs['torch']['subs']) + '\n')
        want = [len(tphot.unphotometered_sources(
            s.id, s.footprint())) for s in
            [TSci.from_file(x.local_path) for x in dbs['torch']['subs']]]
        st = {}
        merged = tphot.main(str(work), str(tmp_path), device='cpu', stats=st)
    finally:
        unbind()
    with open(merged) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ['source_id', 'image_id', 'ra', 'dec', 'flux',
                       'fluxerr', 'flags', 'zp', 'obsjd', 'filtercode']
    assert st['rows'] == want and len(rows) - 1 == sum(want)
    assert len(st['do_one_s']) == 2
    assert os.path.exists(tmp_path / 'phot.rank0.csv')
    img0 = rows[1][1]
    assert not [r for r in rows[1:] if r[1] == img0
                and r[0] in ('F001', 'F002', 'F003')]


def test_from_file_takes_the_newest_record(dbs):
    for pkg in ('jax', 'torch'):
        path = str(dbs[pkg]['dir'] / 'ztf_night1_sciimg.fits')
        ids = [r['id'] for r in table(dbs[pkg]['db'], 'ztffiles')
               if r['basename'] == os.path.basename(path)]
        bind(pkg, dbs[pkg]['db'])
        try:
            img = PKGS[pkg]['sci'].from_file(path)
            assert img.id == ids[-1] and img.type == 'sci'
            assert img.seeing == 2.3
            assert getattr(PKGS[pkg]['sci'].from_file(
                path, use_existing_record=False), 'id', None) is None
        finally:
            unbind()
        assert getattr(PKGS[pkg]['sci'].from_file(path), 'id', None) is None
    import inspect
    for cls in ('ScienceImage', 'CalibratableImage'):
        from zuds_tpu import image as jimage
        from zuds_tpu_torch import image as timage
        assert inspect.signature(getattr(timage, cls).from_file) == \
            inspect.signature(getattr(jimage, cls).from_file)


def test_coadd_joins(dbs):
    for pkg in ('jax', 'torch'):
        rows = table(dbs[pkg]['db'], 'coadd_images')
        recs = table(dbs[pkg]['db'], 'ztffiles')
        stack = [r for r in recs if r['type'] == 'scicoadd']
        assert len(stack) == 1 and dbs[pkg]['stack'].id == stack[0]['id']
        assert [(r['coadd_id'], r['calibratableimage_id']) for r in rows] \
            == [(stack[0]['id'], r['id']) for r in recs if r['type'] == 'sci']


def test_detection_from_a_filtered_catalog_does_not_score_again(
        dbs, monkeypatch):
    """The catalog the night filtered carries FILTERED: from_catalog's
    second filter_sexcat returns at once and braai is not asked for."""
    def refuse(*a, **k):
        raise AssertionError('braai asked for a second time')

    monkeypatch.setattr(tfilter, 'load_model_helper', refuse)
    monkeypatch.setattr(tfilter, 'make_triplets_batch', refuse)
    cat = dbs['torch']['cats'][0]
    assert cat.header.get('FILTERED')
    dets = TDetection.from_catalog(cat, filter=True)
    assert len(dets) == len(dbs['torch']['rows'][0])
    assert [d.x_image for d in dets] == \
        [float(x) for x in dbs['torch']['rows'][0]['X_IMAGE']]


def test_without_a_database_nothing_is_written(scene, outputs, tmp_path):
    """db=True is the default and, with no database bound, writes no record
    and no product file: the frames stay on the card's side of the thunk,
    as in the reference."""
    import inspect
    d, _ = scene
    dd = tmp_path / 'nodb'
    shutil.copytree(d, dd)
    scis, rp = _paths(dd)
    assert tcore.DBSession().conn is None
    called = []

    def thunk():
        called.append(1)
        return (outputs['diff'][0], outputs['rms'][0],
                outputs['submask'][0].astype(np.uint32))

    sub, rows = tnight._commit_frame(
        TSci.from_file(scis[0]), TRef.from_file(rp), outputs, 0, thunk,
        tp.PipelineConfig(**KW), ml=False, device='cpu')
    assert not called and not os.path.exists(sub.local_path)
    assert len(rows) >= 1
    for fn in (tnight.run_night, tnight._commit_frame):
        assert inspect.signature(fn).parameters['db'].default is True


def test_run_night_commits_at_its_default(scene, tmp_path, monkeypatch):
    """run_night at its default db=True with a database bound: one sesub
    record a frame (the night's images are read from HDUs and carry no
    record id, so target and reference ids stay NULL, as donight.py's),
    its GOODCUT rows as detections, three thumbnails each, the product
    files written, and the commit's seconds in the stats."""
    d, truths = scene
    dd = tmp_path / 'night'
    shutil.copytree(d, dd)
    scis, rp = _paths(dd)
    monkeypatch.setenv('ZUDS_CONFIG', str(tmp_path / 'config.yaml'))
    tsecrets._manager.cache = None
    try:
        bind('torch', tmp_path / 'night.db')
        tmu.create_tables()
        st = {}
        res = tnight.run_night([f'{s} {rp}' for s in scis], batch=2,
                               ml=False, cfg=tp.PipelineConfig(**KW),
                               device='cpu', stats=st)
    finally:
        unbind()
        tsecrets._manager.cache = None
    counts = [n for _, n in res]
    assert all(isinstance(n, int) and n >= 1 for n in counts)
    recs = table(tmp_path / 'night.db', 'ztffiles')
    assert [r['type'] for r in recs] == ['sesub', 'sesub']
    assert all(r['target_id'] is None and r['reference_id'] is None
               for r in recs)
    dets = table(tmp_path / 'night.db', 'detections')
    assert [sum(x['image_id'] == r['id'] for x in dets) for r in recs] \
        == counts
    assert len(table(tmp_path / 'night.db', 'thumbnails')) == 3 * len(dets)
    for r in recs:
        assert os.path.exists(dd / r['basename'])
        assert os.path.exists(dd / r['basename'].replace('.fits',
                                                         '.rms.fits'))
    assert all(len(st[k]) == 2 for k in ('frames_s', 'db_s', 'thumb_s'))



def test_sub_do_one_commits_with_record_ids(dbs, tmp_path):
    """The per-pair chain's commit with a database bound (the night's
    fallback): ``from_file`` gives the images their records' ids, so the
    ``sesub`` record carries target and reference ids, as
    ``dosub.do_one``'s. The subtraction step hands back the committed
    frame's product (the per-pair subtraction itself is
    tests/test_torch_sub.py's)."""
    from zuds_tpu_torch import sub as tsub
    made = dbs['torch']['subs'][1]

    class Made(tsubtraction.SingleEpochSubtraction):
        @classmethod
        def from_images(cls, sci, ref, **kw):
            return made

    db = tmp_path / 'pair.db'
    shutil.copy(dbs['torch']['db'], db)
    before = {r['basename']: r['id'] for r in table(db, 'ztffiles')
              if r['type'] in ('sci', 'ref')}
    dd = dbs['torch']['dir']
    bind('torch', db)
    try:
        sub, rows = tsub.do_one(f'{dd}/ztf_night1_sciimg.fits '
                                f'{dd}/ztf_dither_ref_sciimg.fits',
                                sub_class=Made, ml=False, device='cpu')
    finally:
        unbind()
    recs = table(db, 'ztffiles')
    rec = recs[-1]
    assert sub is made and len(recs) == 7
    assert rec['type'] == 'sesub' and rec['basename'] == made.basename
    assert rec['target_id'] == before['ztf_night1_sciimg.fits']
    assert rec['reference_id'] == before['ztf_dither_ref_sciimg.fits']
    dets = [x for x in table(db, 'detections') if x['image_id'] == rec['id']]
    assert len(dets) == len(rows) == len(dbs['torch']['rows'][1]) >= 1
    assert len([t for t in table(db, 'thumbnails')
                if t['detection_id'] in {x['id'] for x in dets}]) \
        == 3 * len(dets)
