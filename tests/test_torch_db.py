"""The port's persistence layer against the JAX package's, with no pipeline:
every model's DDL string for string, the tables ``create_tables`` makes
(every table of the reference, ``alerts`` among them), the
queries and the dialects on the same inputs, the q3c-named sqlite
functions, cone searches and footprint tests on seeded positions (RA 0/360
wrap-around among them), the header JSON, the config reader against
``yaml.safe_load`` of the reference's file and the config's permission
probe. Each package keeps its own registry and sessions: binding one leaves
the other unbound.
"""
import json
import os
import sqlite3
import stat

import numpy as np
import pytest
import yaml

from zuds_tpu import core as jcore, model_util as jmu, secrets as jsecrets
from zuds_tpu import json_util as jjson, spatial as jspatial
from zuds_tpu.db import orm as jorm
from zuds_tpu.fits import Header as JHeader
from zuds_tpu_torch import core as tcore, model_util as tmu
from zuds_tpu_torch import secrets as tsecrets
from zuds_tpu_torch import json_util as tjson, spatial as tspatial
from zuds_tpu_torch.db import orm as torm
from zuds_tpu_torch.fits import Header as THeader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

jmu._ensure_models_imported()
tmu._ensure_models_imported()
# every model of the reference has its twin (alerts since the alert chain)
NOT_PORTED = set()
TABLES = sorted(jorm.MODELS)


@pytest.fixture()
def bound(tmp_path, monkeypatch):
    """Both packages' sessions bound, each to its own sqlite file, with a
    fresh config; unbound after the test."""
    cfg = tmp_path / 'config.yaml'
    monkeypatch.setenv('ZUDS_CONFIG', str(cfg))
    for m in (jsecrets, tsecrets):
        m._manager.cache = None
    jmu.init_db(database=str(tmp_path / 'jax.db'))
    tmu.init_db(database=str(tmp_path / 'torch.db'))
    jmu.create_tables()
    tmu.create_tables()
    yield tmp_path
    for sessions in ((jcore.DBSession, jcore.RefDBSession),
                     (tcore.DBSession, tcore.RefDBSession)):
        for s in sessions:
            s.remove()
            s.configure(None)
    for m in (jsecrets, tsecrets):
        m._manager.cache = None


def test_registries_are_apart():
    assert torm.MODELS is not jorm.MODELS
    assert tcore.DBSession is not jcore.DBSession
    assert set(torm.MODELS) == set(jorm.MODELS) - NOT_PORTED
    for name, model in torm.MODELS.items():
        assert model.__module__.startswith('zuds_tpu_torch.'), name


@pytest.mark.parametrize('table', TABLES)
def test_model_ddl_string_for_string(table):
    if table in NOT_PORTED:
        assert table not in torm.MODELS
        return
    jm, tm = jorm.MODELS[table], torm.MODELS[table]
    assert type(tm).__name__ == type(jm).__name__ == 'ModelMeta'
    assert tm.__name__ == jm.__name__
    assert list(tm.create_table_sql()) == list(jm.create_table_sql())
    assert list(tm.__columns__) == list(jm.__columns__)
    assert getattr(tm, '__poly_on__', None) == getattr(jm, '__poly_on__',
                                                       None)
    for dialect in (torm.PostgresDialect(), torm.SqliteDialect()):
        jd = getattr(jorm, type(dialect).__name__)()
        assert [dialect.ddl(s) for s in tm.create_table_sql()] == \
            [jd.ddl(s) for s in jm.create_table_sql()]


def test_join_model_ddl():
    a = jcore.join_model('JAlpha', jcore.ZTFFile, jorm.MODELS['sources'])
    b = tcore.join_model('JAlpha', tcore.ZTFFile, torm.MODELS['sources'])
    try:
        assert list(a.create_table_sql()) == list(b.create_table_sql())
    finally:
        jorm.MODELS.pop('jalphas')
        torm.MODELS.pop('jalphas')


def _schema(path):
    conn = sqlite3.connect(path)
    try:
        return {(t, n, tbl, sql) for t, n, tbl, sql in conn.execute(
            'SELECT type, name, tbl_name, sql FROM sqlite_master')}
    finally:
        conn.close()


def test_create_tables_makes_the_reference_tables(bound):
    jd, td = _schema(bound / 'jax.db'), _schema(bound / 'torch.db')
    assert {r for r in jd if r[2] not in NOT_PORTED} == td
    assert {r[2] for r in jd} - {r[2] for r in td} == NOT_PORTED
    # binding the port left nothing of the reference's session changed
    assert jcore.DBSession().conn is not tcore.DBSession().conn
    tmu.drop_tables()
    assert {r for r in _schema(bound / 'torch.db') if r[0] == 'table'
            and r[1] != 'sqlite_sequence'} == set()
    assert {r[2] for r in _schema(bound / 'jax.db')} >= set(TABLES)


def test_unbound_sessions_answer_empty(tmp_path):
    """With no database bound a session takes adds, answers queries with
    None/[]/0 and refuses to commit pending objects, as the reference's."""
    for core in (jcore, tcore):
        s = core.DBSession()
        assert s.conn is None
        assert s.query(core.ZTFFile).all() == []
        assert s.query(core.ZTFFile).first() is None
        assert s.query(core.ZTFFile).count() == 0
        assert core.ZTFFile.get_by_basename('x.fits') is None
        s.add(core.ZTFFile(basename='x.fits'))
        with pytest.raises(RuntimeError, match='init_db'):
            s.commit()
        s.rollback()
        s.commit()


def _records(core, orm):
    det = orm.MODELS['detections']
    return [core.ZTFFile(type='sci', basename=f'ztf_{i}_sciimg.fits',
                         field=600 + i % 2, ccdid=1, qid=2, fid=2,
                         ra=150.0 + 0.01 * i, dec=35.0 - 0.01 * i,
                         seeing=np.float32(2.0 + i / 8),
                         header={'A': i}, version=None)
            for i in range(6)] + [
        det(ra=150.0 + 1e-4 * i, dec=35.0, flux_aper=100.0 + i,
            fluxerr_aper=np.float64(10.0), goodcut=np.int64(i % 2),
            triggers_alert=True) for i in range(5)]


def test_session_and_query_on_the_same_inputs(bound):
    """The same objects committed through both sessions give the same rows
    (ids, created and modified times aside), and the same queries give
    the same SQL and the same answers; an update keeps the id."""
    got = {}
    for core, orm in ((jcore, jorm), (tcore, torm)):
        sess = core.DBSession()
        objs = _records(core, orm)
        sess.add_all(objs)
        sess.add(objs[0])          # added twice, inserted once
        sess.commit()
        assert [o.id for o in objs[:6]] == list(range(1, 7))
        objs[2].seeing = 3.5
        sess.add(objs[2])
        sess.commit()
        det = orm.MODELS['detections']
        q = (sess.query(core.ZTFFile).filter_by(field=601, ccdid=1)
             .filter('ra > ?', 150.0).order_by('id DESC').limit(2))
        where, params = (tspatial if core is tcore else jspatial).cone_where(
            150.0002, 35.0, 1.0 / 3600)
        got[core] = dict(
            sql=q._sql(), params=list(q._params),
            rows=[r.to_dict() for r in q.all()],
            newest=core.ZTFFile.get_by_basename('ztf_3_sciimg.fits').id,
            count=sess.query(det).filter_by(goodcut=1).count(),
            cone=sorted(d.id for d in sess.query(det)
                        .filter(where, *params).all()),
            deleted=sess.query(det).filter_by(goodcut=None).delete(),
            table=[tuple(r) for r in sess.execute(
                'SELECT * FROM ztffiles ORDER BY id').fetchall()],
            dets=[tuple(r) for r in sess.execute(
                'SELECT * FROM detections ORDER BY id').fetchall()])
    j, t = got[jcore], got[tcore]
    assert t['sql'] == j['sql'] and t['params'] == j['params']
    strip = [{k: v for k, v in r.items()
              if k not in ('created_at', 'modified')} for r in t['rows']]
    assert strip == [{k: v for k, v in r.items()
                      if k not in ('created_at', 'modified')}
                     for r in j['rows']]
    assert [r['id'] for r in t['rows']] == [6, 4]
    assert t['newest'] == j['newest'] == 4
    assert t['count'] == j['count'] == 2
    assert t['cone'] == j['cone'] and len(t['cone']) >= 2
    assert t['deleted'] == j['deleted'] == 0
    cols = [c for c in jcore.ZTFFile.__columns__]
    keep = [i for i, c in enumerate(cols)
            if c not in ('created_at', 'modified')]
    assert [[r[i] for i in keep] for r in t['table']] == \
        [[r[i] for i in keep] for r in j['table']]
    assert t['table'][2][cols.index('seeing')] == 3.5
    assert json.loads(t['table'][0][cols.index('header')]) == {'A': 0}
    dcols = list(jorm.MODELS['detections'].__columns__)
    dkeep = [i for i, c in enumerate(dcols)
             if c not in ('created_at', 'modified')]
    assert [[r[i] for i in dkeep] for r in t['dets']] == \
        [[r[i] for i in dkeep] for r in j['dets']]


@pytest.mark.parametrize('sql', [
    'SELECT * FROM t WHERE a = ? AND b = ?',
    'INSERT INTO t (a, b) VALUES (?, ?)',
    'CREATE TABLE IF NOT EXISTS x (id INTEGER PRIMARY KEY AUTOINCREMENT, '
    'v REAL, b BLOB, t TEXT)',
    "SELECT q3c_dist(ra, dec, ?, ?) FROM sources WHERE id = '?'",
])
def test_dialects_translate_and_ddl(sql):
    for name in ('SqliteDialect', 'PostgresDialect'):
        j, t = getattr(jorm, name)(), getattr(torm, name)()
        assert t.name == j.name
        assert t.translate(sql) == j.translate(sql)
        assert t.ddl(sql) == j.ddl(sql)


class _FakeCursor:
    def __init__(self, log):
        self.log = log
        self.rowcount = 3

    def execute(self, sql, params=()):
        self.log.append((sql, tuple(params)))

    def fetchone(self):
        return {'id': 42}

    def fetchall(self):
        return []


class _FakeConn:
    def __init__(self):
        self.log = []

    def cursor(self):
        return _FakeCursor(self.log)

    def commit(self):
        pass

    def rollback(self):
        pass

    def close(self):
        pass


def test_pg_connection_adapter():
    """The psycopg2 adapter sends the same statements in both packages."""
    logs = []
    for orm in (jorm, torm):
        fake = _FakeConn()
        conn = orm.PGConnection(fake)
        ins = conn.execute('INSERT INTO t (a) VALUES (?)', [1])
        conn.execute('CREATE TABLE IF NOT EXISTS x (id INTEGER PRIMARY KEY '
                     'AUTOINCREMENT, v REAL)')
        sel = conn.execute('SELECT * FROM t WHERE a = ?', (2,))
        logs.append((fake.log, ins.lastrowid, sel.lastrowid, sel.rowcount))
    assert logs[0] == logs[1]
    assert logs[1][1] == 42 and 'RETURNING id' in logs[1][0][0][0]


def test_psycopg2_is_imported_only_by_the_postgres_factory():
    import ast
    for name in ('db/orm.py', 'model_util.py'):
        tree = ast.parse(open(os.path.join(ROOT, 'zuds_tpu_torch', name))
                         .read())
        top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                      ast.ImportFrom))]
        assert not [n for n in top if 'psycopg2' in ast.dump(n)], name


def _positions(seed, n=400):
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 360, n)
    dec = np.degrees(np.arcsin(rng.uniform(-1, 1, n)))
    # a cluster straddling RA 0/360 near the pole and the equator
    ra[:60] = np.mod(rng.normal(0, 0.05, 60), 360)
    dec[:30] = rng.normal(0.0, 0.05, 30)
    dec[30:60] = rng.normal(85.0, 0.05, 30)
    return ra, dec


def test_great_circle_and_sqlite_functions():
    ra, dec = _positions(1)
    conns = []
    for spatial in (jspatial, tspatial):
        c = sqlite3.connect(':memory:')
        spatial.register_sqlite_functions(c)
        conns.append(c)
    for i in range(0, len(ra) - 1, 7):
        args = (ra[i], dec[i], ra[i + 1], dec[i + 1])
        j = jspatial.great_circle_deg(*args)
        assert tspatial.great_circle_deg(*args) == j
        assert conns[1].execute('SELECT q3c_dist(?, ?, ?, ?)',
                                args).fetchone()[0] == j
        for r in (j * 0.999, j * 1.001):
            assert conns[1].execute('SELECT q3c_join(?, ?, ?, ?, ?)',
                                    args + (r,)).fetchone()[0] == \
                conns[0].execute('SELECT q3c_join(?, ?, ?, ?, ?)',
                                 args + (r,)).fetchone()[0]
    np.testing.assert_array_equal(
        tspatial.angular_distance(ra[:-1], dec[:-1], ra[1:], dec[1:]),
        jspatial.angular_distance(ra[:-1], dec[:-1], ra[1:], dec[1:]))


@pytest.mark.parametrize('center', [(0.01, 0.0), (359.99, 85.0),
                                    (180.0, -30.0), (90.0, 89.99)])
def test_cone_where_on_seeded_positions(center):
    """The same fragment and parameters in both packages, and the rows a
    sqlite table of seeded positions gives for it are the exact
    great-circle cone, across the RA 0/360 seam too."""
    ra, dec = _positions(2)
    radius = 0.2
    frag = [m.cone_where(*center, radius) for m in (jspatial, tspatial)]
    assert frag[0] == frag[1]
    c = sqlite3.connect(':memory:')
    tspatial.register_sqlite_functions(c)
    c.execute('CREATE TABLE p (id INTEGER, ra REAL, dec REAL)')
    c.executemany('INSERT INTO p VALUES (?, ?, ?)',
                  list(zip(range(len(ra)), ra, dec)))
    where, params = frag[1]
    got = {r[0] for r in c.execute(f'SELECT id FROM p WHERE {where}',
                                   params)}
    want = set(np.flatnonzero(tspatial.angular_distance(
        ra, dec, center[0], center[1]) <= radius))
    assert got == want
    if center[0] < 1 or center[0] > 359:
        assert got, 'no position near the seam'


@pytest.mark.parametrize('corners', [
    [[359.9, -0.1], [0.1, -0.1], [0.1, 0.1], [359.9, 0.1]],
    [[150.0, 35.0], [150.6, 35.0], [150.6, 35.5], [150.0, 35.5]],
    [[10.0, 80.0], [14.0, 80.2], [13.5, 81.0], [9.5, 80.8]],
])
def test_poly_contains_on_seeded_positions(corners):
    rng = np.random.default_rng(3)
    c = np.asarray(corners)
    ra = np.mod(c[:, 0].min() - 0.3 + rng.uniform(0, 1.2, 2000)
                if c[:, 0].max() - c[:, 0].min() < 180 else
                rng.uniform(-0.4, 0.4, 2000), 360)
    dec = rng.uniform(c[:, 1].min() - 0.3, c[:, 1].max() + 0.3, 2000)
    got = tspatial.HasPoly.poly_contains(c, ra, dec)
    np.testing.assert_array_equal(
        got, jspatial.HasPoly.poly_contains(c, ra, dec))
    assert 0 < got.sum() < len(got)


def _header(Header):
    h = Header()
    with open(os.path.join(ROOT, 'tests', 'data',
                           'ztf_real_header.json')) as f:
        cards = json.load(f)
    for group in cards.values():
        for k, v in group.items():
            h.set(k, v)
    h.set('SEEING', np.float32(2.25))
    h.set('NAN', float('nan'))
    h.set('FLAG', True)
    return h


def test_header_json_equal():
    j = jjson.to_json(_header(JHeader).to_dict())
    t = tjson.to_json(_header(THeader).to_dict())
    assert t == j
    payload = {'a': np.int64(3), 'b': np.float32(np.inf), 'c': b'x',
               'd': np.arange(3), 'e': np.bool_(True)}
    assert tjson.to_json(payload) == jjson.to_json(payload)


def test_config_reader_against_yaml(tmp_path):
    with open(os.path.join(ROOT, 'zuds_tpu', 'config',
                           'default.conf.yaml')) as f:
        want = yaml.safe_load(f)
    with open(tsecrets.DEFAULT_CONFIG) as f:
        text = f.read()
    assert tsecrets.parse_config(text) == want
    extra = ('a: 7  # c\nb: -3\nc: "x # y"\nd: \'q\'\ne: \'1.5\'\n'
             'f: ~\ng:\nh: NULL\ni: some words here\nj: /p#q\n'
             'k: ~/x.db  # path\nl: 1.5\nm: true\nn: Off\no: .5\n'
             'p: -.inf\n# end\n')
    assert tsecrets.parse_config(extra) == yaml.safe_load(extra)
    for bad in ('a:\n  b: 1\n', 'a: {b: 1}\n', 'a: [1]\n', 'a\n',
                'a: 1e3\n', 'a: 0x1f\n', 'a: 127.0.0.1\n',
                'a: "x\n', '---\na: 1\n'):
        with pytest.raises(ValueError):
            tsecrets.parse_config(bad)


def test_get_secret_like_the_reference(tmp_path, monkeypatch):
    """Both packages seed the file at ``$ZUDS_CONFIG`` with mode 0600 and
    read every key alike; the port reads the file the reference seeds."""
    for pkg, other in ((tsecrets, jsecrets), (jsecrets, tsecrets)):
        cfg = tmp_path / f'{pkg.__name__}.yaml'
        monkeypatch.setenv('ZUDS_CONFIG', str(cfg))
        pkg._manager.cache = other._manager.cache = None
        try:
            first = pkg.load_config(reload=True)
            assert stat.S_IMODE(os.stat(cfg).st_mode) == 0o600
            assert other.load_config(reload=True) == first
            for key in first:
                assert tsecrets.get_secret(key) == jsecrets.get_secret(key)
            assert tsecrets.get_secret('no_such_key', 'x') == 'x'
        finally:
            pkg._manager.cache = other._manager.cache = None


@pytest.mark.parametrize('mode', [0o640, 0o604, 0o620, 0o602])
def test_config_permission_probe(tmp_path, monkeypatch, mode):
    cfg = tmp_path / 'config.yaml'
    monkeypatch.setenv('ZUDS_CONFIG', str(cfg))
    for pkg in (tsecrets, jsecrets):
        pkg._manager.cache = None
    try:
        assert tsecrets.load_config(reload=True)['db_backend'] == 'sqlite'
        os.chmod(cfg, mode)
        for pkg in (tsecrets, jsecrets):
            with pytest.raises(PermissionError, match='chmod 600'):
                pkg.load_config(reload=True)
        os.chmod(cfg, 0o600)
        assert tsecrets.load_config(reload=True)
    finally:
        for pkg in (tsecrets, jsecrets):
            pkg._manager.cache = None
