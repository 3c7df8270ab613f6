"""The port's alert chain against the JAX package's on the CPU, each package
with its own sqlite file, from the same rows and files:

- ``alert_fields``: the 123/124-field registries and their defaults; the
  lazy names ``Alert``, ``xmatch``, ``send_alert``, ``combine_schemas``;
- ``send.combine_schemas`` of both streams;
- ``avro.write_avro``: the same bytes from the same record and schema, and
  each package's ``read_avro`` reads the other's file;
- ``crossmatch.xmatch``: equal dicts on the same seeded local PS1, DR8,
  CLU and name rows, among them a position on RA 0/360;
- ``Alert.from_detection``: the same payload text and the same decompressed
  cutouts for a single-stream and a stack-stream detection that carry
  their images, and for a detection read from the database (no image:
  no cutouts and no image metadata, in both packages);
- ``send.send_alert``: the same topic, spool path and file bytes, and the
  same message through a stand-in ``confluent_kafka`` producer;
- ``makealert.main`` and ``doalert``: the same ``alerts`` rows, column by
  column, and the same spooled packets.
"""
import contextlib
import datetime
import gzip
import io
import os
import sqlite3
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'scripts'))

import doalert as jdoalert  # noqa: E402
import makealert as jmakealert  # noqa: E402
from zuds_tpu import alert as jalert, alert_fields as jfields  # noqa: E402
from zuds_tpu import avro as javro, core as jcore  # noqa: E402
from zuds_tpu import coadd as jcoadd, crossmatch as jxm  # noqa: E402
from zuds_tpu import detections as jdet, external as jext  # noqa: E402
from zuds_tpu import image as jimage, model_util as jmu  # noqa: E402
from zuds_tpu import secrets as jsecrets, send as jsend  # noqa: E402
from zuds_tpu import source as jsource, subtraction as jsubm  # noqa: E402
from zuds_tpu_torch import alert as talert  # noqa: E402
from zuds_tpu_torch import alert_fields as tfields  # noqa: E402
from zuds_tpu_torch import avro as tavro, core as tcore  # noqa: E402
from zuds_tpu_torch import coadd as tcoadd, crossmatch as txm  # noqa: E402
from zuds_tpu_torch import detections as tdet  # noqa: E402
from zuds_tpu_torch import doalert as tdoalert  # noqa: E402
from zuds_tpu_torch import external as text, inputs  # noqa: E402
from zuds_tpu_torch import image as timage, model_util as tmu  # noqa: E402
from zuds_tpu_torch import makealert as tmakealert  # noqa: E402
from zuds_tpu_torch import secrets as tsecrets, send as tsend  # noqa: E402
from zuds_tpu_torch import source as tsource  # noqa: E402
from zuds_tpu_torch import subtraction as tsubm  # noqa: E402
from zuds_tpu_torch.fits import HDU, read_fits, write_fits  # noqa: E402
from zuds_tpu_torch.thumbnails import make_stamp  # noqa: E402

torch.set_num_threads(2)

PKGS = {
    'jax': dict(core=jcore, mu=jmu, secrets=jsecrets, alert=jalert,
                send=jsend, xm=jxm, det=jdet, ext=jext, image=jimage,
                coadd=jcoadd, sub=jsubm, source=jsource,
                makealert=jmakealert, doalert=jdoalert),
    'torch': dict(core=tcore, mu=tmu, secrets=tsecrets, alert=talert,
                  send=tsend, xm=txm, det=tdet, ext=text, image=timage,
                  coadd=tcoadd, sub=tsubm, source=tsource,
                  makealert=tmakealert, doalert=tdoalert),
}
SOURCE = 'ZUDS26aaaaaa'


def configure(path, **cards):
    """A config of the test's own (``cards`` as ``key: value`` lines) for
    both packages."""
    path.write_text(''.join(f'{k}: {v}\n' for k, v in cards.items()))
    os.chmod(path, 0o600)
    os.environ['ZUDS_CONFIG'] = str(path)
    for p in PKGS.values():
        p['secrets']._manager.cache = None


@pytest.fixture()
def config(tmp_path, monkeypatch):
    monkeypatch.setenv('ZUDS_CONFIG', str(tmp_path / 'config.yaml'))
    configure(tmp_path / 'config.yaml',
              sqlite_path=tmp_path / 'default.db',
              base_data_directory=tmp_path / 'spool')
    yield tmp_path / 'config.yaml'
    unbind()
    for p in PKGS.values():
        p['secrets']._manager.cache = None


def unbind():
    for p in PKGS.values():
        for s in (p['core'].DBSession, p['core'].RefDBSession):
            s.remove()
            s.configure(None)


@contextlib.contextmanager
def bound(pkg, path):
    PKGS[pkg]['mu'].init_db(database=str(path))
    PKGS[pkg]['mu'].create_tables()
    try:
        yield PKGS[pkg]['core'].DBSession()
    finally:
        unbind()


def table(db, name, skip=('created_at', 'modified')):
    conn = sqlite3.connect(db)
    conn.row_factory = sqlite3.Row
    try:
        rows = conn.execute(f'SELECT * FROM {name} ORDER BY id').fetchall()
        return [{k: r[k] for k in r.keys() if k not in skip} for r in rows]
    finally:
        conn.close()


# ---- registries, schemas, avro ---------------------------------------------

@pytest.mark.parametrize('stream', ['single', 'stack'])
def test_field_registries_and_defaults_match(stream):
    assert tfields.candidate_fields(stream) == jfields.candidate_fields(
        stream)
    assert tfields.candidate_defaults(stream) == \
        jfields.candidate_defaults(stream)
    assert len(tfields.candidate_fields(stream)) == \
        {'single': 123, 'stack': 124}[stream]


def test_lazy_names():
    import zuds_tpu_torch
    for name, mod in (('Alert', talert), ('xmatch', txm),
                      ('send_alert', tsend), ('combine_schemas', tsend)):
        assert name in dir(zuds_tpu_torch)
        assert getattr(zuds_tpu_torch, name) is getattr(mod, name)


@pytest.mark.parametrize('stream', ['single', 'stack'])
def test_combine_schemas_match(stream):
    assert tsend.combine_schemas(alert_type=stream) == \
        jsend.combine_schemas(alert_type=stream)
    assert (tsend.ALERT_SCHEMA, tsend.ALERT_SCHEMA_STACK) == \
        (jsend.ALERT_SCHEMA, jsend.ALERT_SCHEMA_STACK)


def _value(rng, typ):
    """A seeded value of avro type ``typ`` (a union: None one time in
    three)."""
    if isinstance(typ, list):
        if rng.uniform() < 1 / 3:
            return None
        return _value(rng, [t for t in typ if t != 'null'][0])
    if isinstance(typ, dict) and typ['type'] == 'record':
        return {f['name']: _value(rng, f['type']) for f in typ['fields']}
    if isinstance(typ, dict) and typ['type'] == 'array':
        return [_value(rng, typ['items']) for _ in range(rng.integers(0, 4))]
    if typ in ('int', 'long'):
        big = 2 ** 62 if typ == 'long' else 2 ** 30
        return int(rng.integers(-big, big))
    if typ in ('float', 'double'):
        return float(rng.normal(0, 1e3))
    if typ == 'string':
        return ''.join(rng.choice(list('abcZUDS_ é☃0'), rng.integers(0, 9)))
    if typ == 'bytes':
        return rng.bytes(int(rng.integers(0, 300)))
    raise TypeError(typ)


MISC_SCHEMA = {
    'type': 'record', 'name': 'misc', 'fields': [
        {'name': 'flag', 'type': 'boolean'},
        {'name': 'kind', 'type': {'type': 'enum', 'name': 'kinds',
                                  'symbols': ['a', 'b', 'c']}},
        {'name': 'tag', 'type': {'type': 'fixed', 'name': 'tag16',
                                 'size': 16}},
        {'name': 'counts', 'type': {'type': 'map', 'values': 'long'}},
        {'name': 'again', 'type': ['null', 'kinds']},
    ]}


@pytest.mark.parametrize('case', ['single', 'stack', 'misc'])
def test_avro_bytes_match_and_read_across(case, tmp_path):
    rng = np.random.default_rng({'single': 1, 'stack': 2, 'misc': 3}[case])
    if case == 'misc':
        schema = MISC_SCHEMA
        records = [{'flag': bool(i % 2), 'kind': 'abc'[i % 3],
                    'tag': rng.bytes(16),
                    'counts': {f'k{j}': int(rng.integers(-9, 9))
                               for j in range(i)},
                    'again': None if i % 2 else 'b'} for i in range(4)]
    else:
        schema = jsend.combine_schemas(alert_type=case)
        records = [_value(rng, schema) for _ in range(3)]
    files = {}
    for pkg, mod in (('jax', javro), ('torch', tavro)):
        buf = io.BytesIO()
        mod.write_avro(buf, schema, records)
        files[pkg] = buf.getvalue()
        (tmp_path / f'{pkg}.avro').write_bytes(files[pkg])
    assert files['torch'] == files['jax']
    got_t = tavro.read_avro(str(tmp_path / 'jax.avro'))
    got_j = javro.read_avro(str(tmp_path / 'torch.avro'))
    assert got_t == got_j
    assert got_t[0] == schema and len(got_t[1]) == len(records)
    if case == 'misc':
        assert got_t[1] == records


# ---- crossmatch -------------------------------------------------------------

POSITIONS = {'field': (150.1, 35.2), 'wrap': (359.99992, 10.0),
             'empty': (20.0, -30.0)}


def add_catalog_rows(pkg, sess, seed=11):
    """The same seeded local PS1, DR8 (north and south), CLU and name rows
    in ``pkg``'s tables, around each of POSITIONS but the empty one: some
    within 1.5 arcsec, some out to 70 arcsec, on both sides of RA 0."""
    ext = PKGS[pkg]['ext']
    rng = np.random.default_rng(seed)
    rows = []
    for name, (ra0, dec0) in POSITIONS.items():
        if name == 'empty':
            continue
        for i in range(6):
            sep = rng.uniform(0.2, 70.0) / 3600.0 if i else 0.5 / 3600.0
            pa = rng.uniform(0, 2 * np.pi)
            ra = (ra0 + sep * np.sin(pa) / np.cos(np.radians(dec0))) % 360.0
            dec = dec0 + sep * np.cos(pa)
            base = dict(ra=float(ra), dec=float(dec))
            rows.append(ext.PS1(objid=int(1000 * (len(rows) + 1) + i),
                                sgscore=float(rng.uniform()),
                                gmag=float(rng.uniform(15, 22)),
                                rmag=float(rng.uniform(15, 22)),
                                imag=None if i == 2 else 19.0,
                                zmag=float(rng.uniform(15, 22)), **base))
            dr8 = ext.DR8North if i % 2 else ext.DR8South
            rows.append(dr8(objid=int(77 + len(rows)), type='REX',
                            ebv=0.03, flux_g=float(rng.uniform(-1, 40)),
                            flux_r=float(rng.uniform(0.1, 40)),
                            flux_z=None, flux_w1=5.0, flux_w2=4.0,
                            flux_w3=0.0, flux_w4=0.5,
                            gaia_phot_g_mean_mag=19.0, parallax=0.5,
                            z_phot_mean=0.2, z_phot_median=0.19,
                            z_phot_std=0.05, z_phot_l68=0.15,
                            z_phot_u68=0.25, z_phot_l95=0.1,
                            z_phot_u95=0.3, z_spec=None,
                            extra='{"shape_r": 1.5}', **base))
            rows.append(ext.CLU(cluid=i, name=f'CLU{name}{i}', z=0.01 * i,
                                distmpc=40.0 + i, **base))
            near = sep < 1.5 / 3600.0
            rows.append(ext.ZTFName(objectid=f'ZTF26{name}{i}', **base))
            if near or i == 3:
                rows.append(ext.Milliquas(name=f'MQ {name} {i}', **base))
                rows.append(ext.TNSSource(name=f'2026{name}{i}', **base))
    sess.add_all(rows)
    sess.commit()


@pytest.mark.parametrize('where', list(POSITIONS))
def test_xmatch_matches(where, config, tmp_path):
    ra, dec = POSITIONS[where]
    res = {}
    for pkg in PKGS:
        with bound(pkg, tmp_path / f'{pkg}.db') as sess:
            add_catalog_rows(pkg, sess)
            res[pkg] = PKGS[pkg]['xm'].xmatch(ra, dec)
    assert res['torch'] == res['jax']
    if where == 'empty':
        assert res['torch'] == {'ztfname': '', 'mqid': '', 'tnsid': ''}
    else:
        assert res['torch']['objectidps1'] is not None
        assert res['torch']['distpsnr1'] == pytest.approx(0.5, abs=1e-6)
        assert res['torch']['lsobjectid1'] is not None
        assert res['torch']['ztfname'].startswith('ZTF26')
    assert txm.abmag(10.0) == jxm.abmag(10.0)
    assert txm.abmag(0.0) is jxm.abmag(0.0) is None


# ---- Alert.from_detection ---------------------------------------------------

def frames(d):
    """Four 96^2 frames of one scene with MAGLIM cards; the second carries
    the science frame's program cards, the third NCOADD."""
    paths, wcss = inputs.write_coadd_epochs(
        str(d), 4, 96, 96, seed=5, nstars=6,
        maglim=[20.1, 20.4, 20.7, 21.0])
    for path, cards in ((paths[1], dict(PROGRMID=3, PROGRMPI='Kulkarni',
                                        DBNID=800, EXPTIME=30.0)),
                        (paths[2], dict(NCOADD=12))):
        hdu = read_fits(path)[0]
        for k, v in cards.items():
            hdu.header.set(k, v)
        write_fits(path, [HDU(hdu.header, hdu.data)])
    return paths, wcss


def add_history(pkg, sess, ra, dec):
    """The science record, its subtraction record, a source, two of its
    detections (the second the alert's) and its forced light curve, in
    ``pkg``'s tables. Returns the alert's detection."""
    core, det, src = (PKGS[pkg][k] for k in ('core', 'det', 'source'))
    quad = dict(field=679, ccdid=1, qid=2, fid=2)
    sci = core.ZTFFile(type='sci', basename='ep1_sciimg.fits',
                       obsjd=2458300.5 + 1, **quad)
    sess.add(sci)
    sess.commit()
    sub = core.ZTFFile(type='sesub', basename='ep0_sciimg.fits',
                       target_id=sci.id, **quad)
    sess.add(sub)
    sess.add(src.Source(id=SOURCE, ra=ra, dec=dec, origin='test'))
    sess.commit()
    dets = [det.Detection(ra=ra + 1e-5 * k, dec=dec, image_id=sub.id,
                          source_id=SOURCE, x_image=40.0 + k, y_image=50.0,
                          a_image=1.2, b_image=1.0, elongation=1.2,
                          fwhm_image=2.4, flags_weight=0, imaflags_iso=0,
                          goodcut=1, rb=0.9 if k else None, flux=1000.0,
                          flux_aper=900.0 + k, fluxerr_aper=30.0,
                          zp=26.3, triggers_alert=1, alert_ready=1)
            for k in (0, 1)]
    sess.add_all(dets)
    sess.add_all([src.ForcedPhotometryRecord(
        source_id=SOURCE, image_id=sub.id + 100 * k, flux=f, fluxerr=3.0,
        zp=26.3,
        filtercode='zr', obsjd=jd, flags=k)
        for k, (f, jd) in enumerate(((120.0, 2458301.5), (np.nan, None),
                                     (95.5, 2458299.5)))])
    sess.commit()
    return dets[1]


def images(pkg, paths, stream):
    """The alert's images from ``paths``, read by ``pkg``: the subtraction
    (a ``MultiEpochSubtraction`` for the stack stream), its science frame
    (a ``ScienceCoadd`` of two inputs there) and its reference."""
    im, co, sb = (PKGS[pkg][k] for k in ('image', 'coadd', 'sub'))
    kw = {'use_existing_record': False}
    sci_cls = co.ScienceCoadd if stream == 'stack' else im.ScienceImage
    sub_cls = (sb.MultiEpochSubtraction if stream == 'stack'
               else im.ScienceImage)
    sub = sub_cls.from_file(paths[0], **kw)
    sub.target_image = sci_cls.from_file(paths[1], **kw)
    sub.reference_image = co.ReferenceImage.from_file(paths[2], **kw)
    if stream == 'stack':
        sub.target_image.input_images = [
            im.ScienceImage.from_file(p, **kw) for p in paths[2:]]
        sub.reference_image.input_images = [
            im.ScienceImage.from_file(p, **kw) for p in paths]
    sub.id = 2
    return sub


def cutouts(alert):
    return [None if b is None else gzip.decompress(b)
            for b in (alert.cutout_science, alert.cutout_template,
                      alert.cutout_difference)]


@pytest.mark.parametrize('stream', ['single', 'stack', 'database'])
def test_from_detection_matches(stream, config, tmp_path):
    paths, wcss = frames(tmp_path)
    ra, dec = (float(v) for v in wcss[0].pix2sky_0(40.0, 50.0))
    res = {}
    for pkg in PKGS:
        with bound(pkg, tmp_path / f'{pkg}.db') as sess:
            add_catalog_rows(pkg, sess)
            det = add_history(pkg, sess, ra, dec)
            if stream == 'database':
                det = sess.query(PKGS[pkg]['det'].Detection).get(det.id)
                assert getattr(det, 'image', None) is None
            else:
                det.image = images(pkg, paths, stream)
            alert = PKGS[pkg]['alert'].Alert.from_detection(det)
            res[pkg] = (alert.alert, alert.detection_id, cutouts(alert))
    assert res['torch'] == res['jax']
    payload = talert.Alert(alert=res['torch'][0]).payload
    cand = payload['candidate']
    assert cand['alert_type'] == ('stack' if stream == 'stack'
                                  else 'single')
    assert len(cand) == (124 if stream == 'stack' else 123)
    assert payload['objectId'] == SOURCE
    assert len(payload['prv_candidates']) == 1
    assert len(payload['light_curve']) == 3
    assert cand['objectidps1'] is not None
    stamps = res['torch'][2]
    if stream == 'database':
        # no image: no cutouts, no image metadata (both packages)
        assert stamps == [None] * 3
        assert cand['pid'] == 0 and cand['field'] == 0
        # the source's two detections on the sesub record, no time cut
        assert cand['ndethist_single'] == 2
    else:
        assert all(s is not None for s in stamps)
        # each the 63x63 cut of its frame on that frame's WCS
        for raw, path in zip(stamps, (paths[1], paths[2], paths[0])):
            stamp = read_fits(io.BytesIO(raw))[0].data
            img = timage.ScienceImage.from_file(path)
            want = make_stamp(None, cand['ra'], cand['dec'], None, None,
                              np.asarray(img.data), img.wcs)
            assert stamp.shape == (63, 63)
            np.testing.assert_array_equal(stamp, want.astype('f4'))
    if stream == 'single':
        # the ScienceImage reader sets the quadrant from the cards
        assert cand['field'] == 679 and cand['rcid'] == 1
        assert cand['jd'] == 58300.0 + 2400000.5
        assert (cand['programid'], cand['programpi'], cand['nid']) == (
            3, 'Kulkarni', 800)
        assert cand['nframesref'] == 12
    if stream == 'stack':
        assert cand['nframesstack'] == 2 and cand['nframesref'] == 4
        assert cand['jdstartstack'] == 58302.0 + 2400000.5


# ---- send_alert -------------------------------------------------------------

def twin_alerts(config, tmp_path):
    """One alert built by the port (a detection that carries its images)
    and the same row as a JAX ``Alert``."""
    paths, wcss = frames(tmp_path)
    ra, dec = (float(v) for v in wcss[0].pix2sky_0(40.0, 50.0))
    with bound('torch', tmp_path / 'build.db') as sess:
        det = add_history('torch', sess, ra, dec)
        det.image = images('torch', paths, 'single')
        t = talert.Alert.from_detection(det)
    fields = dict(detection_id=t.detection_id, alert=t.alert,
                  cutout_science=t.cutout_science,
                  cutout_template=t.cutout_template,
                  cutout_difference=t.cutout_difference)
    return {'torch': talert.Alert(**fields), 'jax': jalert.Alert(**fields)}


def test_send_alert_spools_the_same_file(config, tmp_path):
    alerts = twin_alerts(config, tmp_path)
    date = datetime.datetime.now(datetime.timezone.utc).strftime('%Y%m%d')
    res = {}
    for pkg in PKGS:
        spool = tmp_path / f'spool_{pkg}'
        configure(config, sqlite_path=tmp_path / f'{pkg}.db',
                  base_data_directory=spool)
        with bound(pkg, tmp_path / f'{pkg}.db'):
            topic = PKGS[pkg]['send'].send_alert(alerts[pkg])
        files = sorted(p.relative_to(spool) for p in spool.rglob('*.avro'))
        res[pkg] = (topic, files, [(spool / f).read_bytes() for f in files],
                    table(tmp_path / f'{pkg}.db', 'alerts'))
    assert res['torch'] == res['jax']
    topic, files, blobs, rows = res['torch']
    assert topic == f'ztf_{date}_programid2_zuds'
    assert files == [Path('alerts') / topic / '2.avro']
    assert rows[0]['sent'] == 1
    _, records = tavro.read_avro(io.BytesIO(blobs[0]))
    record, _ = tsend.alert_to_record(alerts['torch'])
    assert records[0]['cutoutScience'] == record['cutoutScience']
    assert records[0]['candid'] == 2


def test_send_alert_kafka_branch_matches(config, tmp_path, monkeypatch):
    alerts = twin_alerts(config, tmp_path)
    produced = []

    class Producer:
        def __init__(self, conf):
            self.conf = conf

        def produce(self, topic, value):
            produced.append((self.conf['bootstrap.servers'], topic, value))

        def flush(self):
            produced.append('flush')

    fake = types.ModuleType('confluent_kafka')
    fake.Producer = Producer
    monkeypatch.setitem(sys.modules, 'confluent_kafka', fake)
    configure(config, kafka_brokers='broker1:9092,broker2:9092',
              base_data_directory=tmp_path / 'spool')
    topics = [PKGS[pkg]['send'].send_alert(alerts[pkg]) for pkg in PKGS]
    assert topics[0] == topics[1]
    assert produced[1] == produced[3] == 'flush'
    assert produced[0] == produced[2]
    assert produced[0][:2] == ('broker1:9092,broker2:9092', topics[0])
    assert not (tmp_path / 'spool').exists()
    assert tavro.read_avro(io.BytesIO(produced[0][2]))[1][0]['candid'] == 2


# ---- makealert, doalert -----------------------------------------------------

def seed_ready(pkg, sess, ra, dec):
    """Four detections of one source: two alert-ready, one alert-ready
    with an alert already, one not ready."""
    det = add_history(pkg, sess, ra, dec)
    D = PKGS[pkg]['det'].Detection
    sess.add(D(ra=ra, dec=dec + 1e-5, source_id=SOURCE, goodcut=1,
               flux_aper=50.0, fluxerr_aper=5.0, alert_ready=None))
    sess.commit()
    sess.add(PKGS[pkg]['alert'].Alert(detection_id=det.id, alert='{}'))
    sess.commit()


def test_makealert_and_doalert_rows_match(config, tmp_path):
    paths, wcss = frames(tmp_path)
    ra, dec = (float(v) for v in wcss[0].pix2sky_0(40.0, 50.0))
    res = {}
    for pkg in PKGS:
        db = tmp_path / f'{pkg}.db'
        spool = tmp_path / f'spool_{pkg}'
        configure(config, sqlite_path=db, base_data_directory=spool)
        with bound(pkg, db) as sess:
            add_catalog_rows(pkg, sess)
            seed_ready(pkg, sess, ra, dec)
        unbind()
        PKGS[pkg]['makealert'].main()
        made = table(db, 'alerts')
        work = tmp_path / f'ids_{pkg}.txt'
        work.write_text('1\n2\n')
        if pkg == 'jax':
            for det_id in (1, 2):
                jdoalert.do_one(det_id)
        else:
            assert tdoalert.main(['doalert', str(work)]) == 0
        unbind()
        files = sorted(p.relative_to(spool) for p in spool.rglob('*.avro'))
        res[pkg] = (made, table(db, 'alerts'), files,
                    [(spool / f).read_bytes() for f in files])
    assert res['torch'] == res['jax']
    made, rows, files, blobs = res['torch']
    # the anti-join: detection 1 is ready and has no alert; 2 has one
    assert [r['detection_id'] for r in made] == [2, 1]
    assert [r['detection_id'] for r in rows] == [2, 1, 1, 2]
    assert [r['sent'] for r in rows] == [0, 0, 1, 1]
    assert [f.name for f in files] == ['1.avro', '2.avro']
    assert rows[1]['cutout_science'] is None
    with contextlib.redirect_stdout(io.StringIO()):
        assert tdoalert.main(['doalert']) == 2
