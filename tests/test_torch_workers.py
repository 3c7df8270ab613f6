"""The port's workers against their ``scripts/`` twins on the CPU, each
package with its own sqlite file (or the same one, read in turn), from
the same inputs:

- ``makeref.quality_cut`` (twin of ``tests/test_scripts.py``'s): the same
  epochs in the same order, on stand-in images and on epochs written with
  SEEING, MAGLIM and INFOBITS cards; ``makeref.do_one`` and ``main`` on
  16 small epochs (the reference's record, with its version, and
  ``queryref`` lists the quadrant no more);
- ``querystack.stack_windows`` and ``main``, ``queryref.main``: the same
  lines from the same rows;
- ``update``: the query, the parse and ``sync`` on the canned CSV of
  ``tests/test_scripts.py``: the same ``ztffiles`` rows, column by column;
- ``nightly``: the same ``failedsubtractions`` rows for failing lines;
- ``loadphot.load`` of a CSV in ``phot.main``'s layout and
  ``load_catalogs.load_csv``: the same rows, ``extra`` blobs included;
- ``stamp.do_one``: the same thumbnail of a source's best detection
  (decompressed: gzip stamps the time).
"""
import contextlib
import gzip
import io
import json
import os
import sqlite3
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'scripts'))

import donightly as jnightly  # noqa: E402
import dostamp as jstamp  # noqa: E402
import load_catalogs as jload_catalogs  # noqa: E402
import loadphot as jloadphot  # noqa: E402
import makeref as jmakeref  # noqa: E402
import queryref as jqueryref  # noqa: E402
import querystack as jquerystack  # noqa: E402
import update as jupdate  # noqa: E402
from zuds_tpu import core as jcore, model_util as jmu  # noqa: E402
from zuds_tpu import secrets as jsecrets  # noqa: E402
from zuds_tpu.detections import Detection as JDetection  # noqa: E402
from zuds_tpu.image import ScienceImage as JSci  # noqa: E402
from zuds_tpu.source import Source as JSource  # noqa: E402
from zuds_tpu_torch import core as tcore, model_util as tmu  # noqa: E402
from zuds_tpu_torch import inputs, phot  # noqa: E402
from zuds_tpu_torch import load_catalogs as tload_catalogs  # noqa: E402
from zuds_tpu_torch import loadphot as tloadphot  # noqa: E402
from zuds_tpu_torch import makeref as tmakeref  # noqa: E402
from zuds_tpu_torch import nightly as tnightly  # noqa: E402
from zuds_tpu_torch import queryref as tqueryref  # noqa: E402
from zuds_tpu_torch import querystack as tquerystack  # noqa: E402
from zuds_tpu_torch import secrets as tsecrets  # noqa: E402
from zuds_tpu_torch import stamp as tstamp  # noqa: E402
from zuds_tpu_torch import update as tupdate  # noqa: E402
from zuds_tpu_torch.constants import REFERENCE_VERSION  # noqa: E402
from zuds_tpu_torch.detections import Detection as TDetection  # noqa
from zuds_tpu_torch.image import ScienceImage as TSci  # noqa: E402
from zuds_tpu_torch.source import Source as TSource  # noqa: E402

torch.set_num_threads(2)

PKGS = {'jax': dict(core=jcore, mu=jmu, secrets=jsecrets),
        'torch': dict(core=tcore, mu=tmu, secrets=tsecrets)}


@pytest.fixture()
def config(tmp_path, monkeypatch):
    """A config of the test's own for both packages."""
    cfg = tmp_path / 'config.yaml'
    cfg.write_text(f'sqlite_path: {tmp_path / "default.db"}\n')
    os.chmod(cfg, 0o600)
    monkeypatch.setenv('ZUDS_CONFIG', str(cfg))
    for p in PKGS.values():
        p['secrets']._manager.cache = None
    yield cfg
    unbind()
    for p in PKGS.values():
        p['secrets']._manager.cache = None


@contextlib.contextmanager
def bound(pkg, path):
    """``pkg``'s sessions bound to the sqlite file ``path``, its tables
    made; unbound on exit."""
    PKGS[pkg]['mu'].init_db(database=str(path))
    PKGS[pkg]['mu'].create_tables()
    try:
        yield PKGS[pkg]['core'].DBSession()
    finally:
        unbind()


def unbind():
    for p in PKGS.values():
        for s in (p['core'].DBSession, p['core'].RefDBSession):
            s.remove()
            s.configure(None)


def table(db, name):
    conn = sqlite3.connect(db)
    conn.row_factory = sqlite3.Row
    try:
        rows = conn.execute(f'SELECT * FROM {name} ORDER BY id').fetchall()
        return [{k: r[k] for k in r.keys()
                 if k not in ('created_at', 'modified')} for r in rows]
    finally:
        conn.close()


# ---- makeref ----------------------------------------------------------------

class FakeIm:
    """An epoch as ``quality_cut`` reads it: header cards and a pixel
    scale."""

    def __init__(self, name, pixel_scale=1.01, **cards):
        self.name = name
        self.header = {k: v for k, v in cards.items() if v is not None}
        self.pixel_scale = pixel_scale


QUALITY_CASES = {
    # tests/test_scripts.py's four: one survives
    'scripts': [FakeIm('a', SEEING=2.0, MAGLIM=20.5),
                FakeIm('b', SEEING=3.5, MAGLIM=20.5),
                FakeIm('c', SEEING=2.0, MAGLIM=18.0),
                FakeIm('d', SEEING=2.0, MAGLIM=21.0, INFOBITS=4)],
    # the edges of the ranges, missing cards, another pixel scale
    'edges': [FakeIm('lo', SEEING=1.7 / 1.01, MAGLIM=19.2),
              FakeIm('hi', SEEING=2.5 / 1.01, MAGLIM=22.0),
              FakeIm('past', SEEING=2.5 / 1.01 + 1e-9, MAGLIM=21.0),
              FakeIm('noseeing', MAGLIM=21.0),
              FakeIm('nomaglim', SEEING=2.0),
              FakeIm('noinfo', SEEING=2.0, MAGLIM=20.0),
              FakeIm('scale', pixel_scale=1.3, SEEING=2.0, MAGLIM=20.1),
              FakeIm('deep', SEEING=1.9, MAGLIM=21.9, INFOBITS=0)],
    # more than MAX_IMAGES: the deepest 50, ties in input order
    'many': [FakeIm(f'e{i}', SEEING=2.0, MAGLIM=19.5 + (i % 9) * 0.25)
             for i in range(70)],
}


@pytest.mark.parametrize('case', list(QUALITY_CASES))
def test_quality_cut_matches(case):
    ims = QUALITY_CASES[case]
    t = tmakeref.quality_cut(ims)
    j = jmakeref.quality_cut(ims)
    assert [im.name for im in t] == [im.name for im in j]
    assert {'scripts': 1, 'edges': 4, 'many': 50}[case] == len(t)
    assert (tmakeref.MIN_IMAGES, tmakeref.MAX_IMAGES,
            tmakeref.SEEING_RANGE_ARCSEC, tmakeref.MAGLIM_RANGE) == (
        jmakeref.MIN_IMAGES, jmakeref.MAX_IMAGES,
        jmakeref.SEEING_RANGE_ARCSEC, jmakeref.MAGLIM_RANGE)


REF_EPOCHS = 16
REF_SEEING = [2.0] * REF_EPOCHS
REF_SEEING[5] = 3.0 / 1.01          # 3.0 arcsec: cut
REF_INFOBITS = [0] * REF_EPOCHS
REF_INFOBITS[11] = 4                # cut
REF_MAGLIM = [20.0 + 0.1 * i for i in range(REF_EPOCHS)]


@pytest.fixture()
def ref_epochs(tmp_path):
    """16 epochs of 128^2 with SEEING, MAGLIM and INFOBITS cards; two fail
    the quality cut."""
    paths, _ = inputs.write_coadd_epochs(
        str(tmp_path), REF_EPOCHS, 128, 128, seed=3, nstars=8,
        seeing=REF_SEEING, maglim=REF_MAGLIM, infobits=REF_INFOBITS)
    return paths


def test_quality_cut_on_epochs(ref_epochs):
    t = tmakeref.quality_cut([TSci.from_file(p) for p in ref_epochs])
    j = jmakeref.quality_cut([JSci.from_file(p, use_existing_record=False)
                              for p in ref_epochs])
    assert [im.basename for im in t] == [im.basename for im in j]
    want = [f'ep{i}_sciimg.fits' for i in reversed(range(REF_EPOCHS))
            if i not in (5, 11)]
    assert [im.basename for im in t] == want


def test_makeref_do_one_and_queryref(ref_epochs, config, tmp_path,
                                     monkeypatch):
    """The epochs recorded, ``queryref`` lists the quadrant in both
    packages; ``makeref.do_one`` on its line (from the epochs' directory,
    as the line names basenames) stacks the 14 that pass, commits the
    reference with its version, and ``queryref`` lists it no more; a line
    with too few epochs fails, and ``main`` exits 1 for it."""
    monkeypatch.chdir(tmp_path)
    db = tmp_path / 'ref.db'
    with bound('torch', db) as sess:
        sess.add_all([tcore.record_from_image(TSci.from_file(p), 'sci')
                      for p in ref_epochs])
        sess.commit()
        with contextlib.redirect_stdout(io.StringIO()):
            lines = tqueryref.main()
    with bound('jax', db), contextlib.redirect_stdout(io.StringIO()) as out:
        jqueryref.main()
    assert out.getvalue().splitlines() == lines
    assert len(lines) == 1
    name = f'ref_000679_c01_q2_2_{REFERENCE_VERSION}.fits'
    assert lines[0].split() == [name] + [os.path.basename(p)
                                         for p in ref_epochs]
    with bound('torch', db) as sess:
        stats = {}
        ref = tmakeref.do_one(lines[0], device='cpu', stats=stats,
                              calculate_seeing=False)
        assert ref.header['NCOADD'] == 14 and ref.local_path.endswith(name)
        # the deepest epoch's header is the stack's
        assert ref.header['MAGLIM'] == REF_MAGLIM[-1]
        rec = sess.query(tcore.ZTFFile).filter_by(type='ref').all()
        assert len(rec) == 1 and rec[0].id == ref.id
        assert rec[0].version == REFERENCE_VERSION
        assert stats['pipeline_s'] > 0
        with contextlib.redirect_stdout(io.StringIO()):
            assert tqueryref.main() == []
        # epochs 0-12, of which 5 and 11 fail the cut
        short = ' '.join(lines[0].split()[:14])
        with pytest.raises(RuntimeError, match='only 11 epochs'):
            tmakeref.do_one(short, device='cpu')
    work = tmp_path / 'work.txt'
    work.write_text(short + '\n')
    assert tmakeref.main(['makeref', str(work)]) == 1
    assert tmakeref.main(['makeref']) == 2


# ---- querystack --------------------------------------------------------------

def _stack_rows(seed=2):
    rng = np.random.default_rng(seed)
    rows = [(f'e{i}.fits', 679, 1, 2, 2, 58345.0 + i, f'e{i}.fits')
            for i in range(10)]
    rows.append(('x.fits', 680, 1, 2, 2, 58345.0, 'x.fits'))
    for i in range(60):
        q = (int(rng.integers(600, 603)), int(rng.integers(1, 3)),
             int(rng.integers(1, 3)), int(rng.integers(1, 3)))
        m = float(58300.0 + rng.uniform(0, 40))
        rows.append((f'r{i}.fits',) + q + (m, f'd/r{i}.fits'))
    return rows


def test_stack_windows_matches():
    rows = _stack_rows()
    t = tquerystack.stack_windows(rows)
    assert t == jquerystack.stack_windows(rows)
    # tests/test_scripts.py's quadrant: 10 days, two 7-day bins
    mine = [x.split() for x in t if x.startswith('stack_000679')]
    assert len(mine) == 2 and len(mine[0]) == 3 + 7
    assert len(t) > 10 and tquerystack.WINDOW_DAYS == 7.0


def test_querystack_main_matches(config, tmp_path):
    db = tmp_path / 'stack.db'
    with bound('torch', db) as sess:
        for name, field, ccdid, qid, fid, mjd, _ in _stack_rows():
            sess.add(tcore.ZTFFile(type='sci', basename=name, field=field,
                                   ccdid=ccdid, qid=qid, fid=fid,
                                   obsjd=mjd + 2400000.5))
        sess.add(tcore.ZTFFile(type='sci', basename='nojd.fits', field=679,
                               ccdid=1, qid=2, fid=2))
        sess.commit()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            lines = tquerystack.main()
    assert out.getvalue().splitlines() == lines and len(lines) > 10
    with bound('jax', db), contextlib.redirect_stdout(io.StringIO()) as out:
        jquerystack.main()
    assert out.getvalue().splitlines() == lines


def test_queryref_lines_match(config, tmp_path):
    """One database, read by both packages: a quadrant of 15 epochs, one of
    14 with a current reference, one of 13, and one of 14 whose reference
    has no version (as the JAX package records one)."""
    db = tmp_path / 'q.db'
    with bound('torch', db) as sess:
        for field, n, ref in ((679, 15, None), (680, 14, REFERENCE_VERSION),
                              (681, 13, None), (682, 14, '')):
            for i in range(n):
                sess.add(tcore.ZTFFile(type='sci', basename=f'{field}_{i}',
                                       field=field, ccdid=1, qid=2, fid=2))
            if ref is not None:
                sess.add(tcore.ZTFFile(type='ref', basename=f'r{field}',
                                       field=field, ccdid=1, qid=2, fid=2,
                                       version=ref or None))
        sess.commit()
        with contextlib.redirect_stdout(io.StringIO()):
            lines = tqueryref.main()
            assert len(tqueryref.main(15)) == 1
    with bound('jax', db), contextlib.redirect_stdout(io.StringIO()) as out:
        jqueryref.main()
    assert out.getvalue().splitlines() == lines
    assert [x.split()[0] for x in lines] == [
        f'ref_000679_c01_q2_2_{REFERENCE_VERSION}.fits',
        f'ref_000682_c01_q2_2_{REFERENCE_VERSION}.fits']
    assert lines[0].split()[1:] == [f'679_{i}' for i in range(15)]


# ---- update -----------------------------------------------------------------

def _canned():
    """tests/test_scripts.py's TAP response: two images."""
    header = ','.join(jupdate.META_COLUMNS)
    row1 = ('679,5,2,2,zr,o,20200301123456,2458915.5,0,1001,800,55,2.1,'
            '1.2,0.5,0.1,20.5,1536.5,1540.5,150.1,35.2,-0.0003,0.0,0.0,'
            '0.0003,150.1,35.2,149.9,35.0,150.3,35.0,150.3,35.4,149.9,'
            '35.4,2,30.0')
    row2 = row1.replace('679,5,2,2', '680,6,3,1').replace('zr', 'zg')
    row3 = row1.replace('2.1,1.2', 'null,').replace(
        '20200301123456', '20200302123456')
    return header, header + '\n' + row1 + '\n' + row2 + '\n' + row3 + '\n'


def test_update_parse_matches():
    assert tupdate.META_COLUMNS == jupdate.META_COLUMNS
    assert (tupdate.TAP_URL, tupdate.META_TABLE, tupdate.QUERY_WINDOWSIZE) \
        == (jupdate.TAP_URL, jupdate.META_TABLE, jupdate.QUERY_WINDOWSIZE)
    assert tupdate.build_query(411, 441) == jupdate.build_query(411, 441)
    _, text = _canned()
    t, j = tupdate.parse_metatable(text), jupdate.parse_metatable(text)
    assert t == j and len(t) == 3 and t[2]['seeing'] is None
    for row in t:
        assert tupdate._ipac_basename(row) == jupdate._ipac_basename(row)
        assert tupdate._ipac_basename(row, 'mskimg.fits') \
            == jupdate._ipac_basename(row, 'mskimg.fits')


def test_update_sync_rows_match(config, tmp_path):
    header, text = _canned()
    res = {}
    for pkg, mod in (('jax', jupdate), ('torch', tupdate)):
        calls = []

        def fetch(nid_lo, nid_hi, auth=None):
            calls.append((nid_lo, nid_hi))
            return text if len(calls) == 1 else header + '\n'

        db = tmp_path / f'{pkg}.db'
        with bound(pkg, db), contextlib.redirect_stdout(io.StringIO()):
            n = mod.sync(fetch=fetch, now_jd=2458915.5 + 45)
            # idempotent: the same response again inserts nothing
            n2 = mod.sync(fetch=fetch, now_jd=2458915.5 + 45)
        res[pkg] = (n, n2, list(calls), table(db, 'ztffiles'))
    assert res['torch'][:3] == res['jax'][:3]
    assert res['torch'][0] == 3 and res['torch'][1] == 0
    t, j = res['torch'][3], res['jax'][3]
    assert t == j and len(t) == 6
    sci = [r for r in t if r['type'] == 'sci']
    hdr = json.loads(sci[0]['header'])
    assert hdr['DBNID'] == 800 and hdr['PROGRMID'] == 2
    assert {r['parent_id'] for r in t if r['type'] == 'mask'} \
        == {r['id'] for r in sci}


def test_update_main_without_credentials(config, capsys):
    assert tupdate.main() == 0
    assert 'not configured' in capsys.readouterr().err


# ---- nightly ----------------------------------------------------------------

def test_nightly_failed_rows_match(config, tmp_path):
    work = tmp_path / 'work.txt'
    work.write_text(f'{tmp_path}/missing_sciimg.fits '
                    f'{tmp_path}/ref.fits\n'
                    f'{tmp_path}/alone_sciimg.fits\n')
    res = {}
    for pkg in ('jax', 'torch'):
        db = tmp_path / f'{pkg}.db'
        with bound(pkg, db), contextlib.redirect_stderr(io.StringIO()):
            if pkg == 'jax':
                jnightly.main(str(work))
            else:
                out = tnightly.run(str(work), device='cpu')
                assert [type(r) for _, r in out] == [FileNotFoundError,
                                                     IndexError]
        res[pkg] = table(db, 'failedsubtractions')
    assert res['torch'] == res['jax'] and len(res['torch']) == 2
    assert 'missing_sciimg.fits' in res['torch'][0]['reason']
    with contextlib.redirect_stderr(io.StringIO()), \
            contextlib.redirect_stdout(io.StringIO()):
        assert tnightly.main(['nightly', str(work), '--device', 'cpu']) == 1
    assert tnightly.main(['nightly']) == 2
    if not torch.cuda.is_available():
        # the worker's default is the card: without one it raises
        with pytest.raises(RuntimeError, match='no CUDA card'):
            tnightly.main(['nightly', str(work)])


# ---- loadphot, load_catalogs ----------------------------------------------

def test_loadphot_rows_match(config, tmp_path):
    """A CSV in ``phot.main``'s layout (its header, from an empty work
    list), one (source, image) pair twice: the second row replaces the
    first."""
    empty = tmp_path / 'empty.txt'
    empty.write_text('')
    with contextlib.redirect_stdout(io.StringIO()):
        merged = phot.main(str(empty), str(tmp_path))
    rng = np.random.default_rng(4)
    with open(merged, 'a') as f:
        for i in range(40):
            f.write(f'S{i % 30:03d},{1 + i // 30},150.1,35.2,'
                    f'{rng.normal(100, 10):.6f},{rng.uniform(1, 5):.6f},'
                    f'{i % 3},26.3,{2458915.5 + i},zr\n')
    res = {}
    for pkg, mod in (('jax', jloadphot), ('torch', tloadphot)):
        db = tmp_path / f'{pkg}.db'
        with bound(pkg, db), contextlib.redirect_stdout(io.StringIO()):
            assert mod.load(merged) == 40
        res[pkg] = [{k: v for k, v in r.items() if k != 'id'}
                    for r in table(db, 'forcedphotometry')]
    assert res['torch'] == res['jax'] and len(res['torch']) == 40
    with pytest.raises(RuntimeError, match='init_db'):
        tloadphot.load(merged)


CATALOG_CSVS = {
    'ps1': 'objID,RA,Dec,sgscore,gMag,rmag,comment\n'
           '1,150.1,35.2,0.9,19.1,18.7,a star\n'
           '2,150.2,35.3,,20.5,20.1,\n',
    'clu': 'cluid,name,ra,dec,z,distmpc,a,b2a,pa,btc,morph\n'
           '7,NGC 1,150.0,35.0,0.01,40.0,1.5,0.6,30,12.1,Sb\n',
    'dr8north': 'ra,dec,objid,type,flux_g,flux_r,z_phot_mean,shape_r,'
                'ref_cat\n150.3,35.1,11,PSF,1.5,2.5,0.3,0.0,G2\n'
                '150.4,35.4,12,REX,0.5,0.7,,1.2,\n',
    'milliquas': 'name,ra,dec,rmag,qso_class,z,cite\n'
                 'Q1,150.0,35.0,19.0,Q,1.2,MQ\n',
    'tns': 'name,ra,dec,objtype,redshift,internal_names,discoverer\n'
           '2020abc,150.0,35.0,SN Ia,0.05,ZTF20x,ZTF\n',
    'ztf_names': 'objectId,ra,dec,survey\nZTF20aaa,150.0,35.0,ZTF\n',
}


@pytest.mark.parametrize('name', list(CATALOG_CSVS))
def test_load_catalogs_rows_match(name, config, tmp_path):
    path = tmp_path / f'{name}.csv'
    path.write_text(CATALOG_CSVS[name])
    tmodels, jmodels = tload_catalogs._models(), jload_catalogs._models()
    assert list(tmodels) == list(jmodels)
    res = {}
    for pkg, mod, models in (('jax', jload_catalogs, jmodels),
                             ('torch', tload_catalogs, tmodels)):
        db = tmp_path / f'{pkg}.db'
        with bound(pkg, db) as sess, \
                contextlib.redirect_stdout(io.StringIO()):
            n = mod.load_csv(name, str(path), session=sess)
        res[pkg] = (n, table(db, models[name].__tablename__))
    assert res['torch'] == res['jax']
    n, rows = res['torch']
    assert n == len(rows) == CATALOG_CSVS[name].count('\n') - 1
    if 'extra' in rows[0]:
        extra = json.loads(rows[0]['extra'])
        assert extra and all(k.lower() not in tmodels[name].__columns__
                             for k in extra)


def test_load_catalogs_binds_the_configured_database(config, tmp_path):
    path = tmp_path / 'tns.csv'
    path.write_text(CATALOG_CSVS['tns'])
    with bound('torch', tmp_path / 'default.db'):
        pass                    # the tables made
    with contextlib.redirect_stdout(io.StringIO()):
        assert tload_catalogs.load_csv('tns', str(path)) == 1
    unbind()
    assert len(table(tmp_path / 'default.db', 'tns')) == 1


# ---- stamp -------------------------------------------------------------------

def test_stamp_thumbnail_matches(config, tmp_path, monkeypatch):
    """A source with two detections on one frame: the best one's ``sub``
    stamp, cut from the detection's image, in both packages. A detection
    read from the database carries no image in either package (the
    reference's ``getattr(best, 'image', None)``), so the image is set on
    the detection class here; without it no thumbnail is made."""
    paths, wcss = inputs.write_coadd_epochs(str(tmp_path), 1, 128, 128,
                                            seed=3, nstars=8)
    ra, dec = wcss[0].pix2sky_0(np.array([40.0, 90.0]),
                                np.array([60.0, 30.0]))
    res = {}
    for pkg, mod, src_cls, det_cls, img in (
            ('jax', jstamp, JSource, JDetection,
             JSci.from_file(paths[0], use_existing_record=False)),
            ('torch', tstamp, TSource, TDetection,
             TSci.from_file(paths[0]))):
        db = tmp_path / f'{pkg}.db'
        with bound(pkg, db) as sess:
            sess.add(src_cls(id='ZUDS26aaaaaa', ra=float(ra[0]),
                             dec=float(dec[0])))
            sess.add(src_cls(id='ZUDS26bbbbbb', ra=1.0, dec=2.0))
            for r, d, f in zip(ra, dec, (100.0, 300.0)):
                sess.add(det_cls(ra=float(r), dec=float(d), flux_aper=f,
                                 fluxerr_aper=10.0,
                                 source_id='ZUDS26aaaaaa'))
            sess.commit()
            assert mod.do_one('ZUDS26aaaaaa') is None      # no image
            assert mod.do_one('ZUDS26bbbbbb') is None      # no detection
            with pytest.raises(ValueError, match='no source'):
                mod.do_one('ZUDS26zzzzzz')
            monkeypatch.setattr(det_cls, 'image', img, raising=False)
            t = mod.do_one('ZUDS26aaaaaa')
            assert t.detection_id == 2 and t.source_id == 'ZUDS26aaaaaa'
            monkeypatch.delattr(det_cls, 'image')
        res[pkg] = table(db, 'thumbnails')
    t, j = res['torch'], res['jax']
    assert len(t) == len(j) == 1
    assert {k: v for k, v in t[0].items() if k != 'bytes'} \
        == {k: v for k, v in j[0].items() if k != 'bytes'}
    assert gzip.decompress(t[0]['bytes']) == gzip.decompress(j[0]['bytes'])
    assert tstamp.main(['stamp']) == 2
