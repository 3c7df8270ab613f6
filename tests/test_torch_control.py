"""The port's control daemons against the JAX package's ``control/`` on the
CPU, each package with its own sqlite file, from the same rows:

- ``makesources.cluster_positions``: the same labels on 2401 seeded
  positions (close groups, pairs across RA 0/360, points near a pole);
  ``associate``: the same sources, names, ``source_id``s and flags on
  ``tests/test_scripts.py``'s case and on a seeded larger one;
- ``controller``: ``unprocessed_pairs``, ``run_once`` and
  ``refresh_job_status`` with a stand-in launcher, the same rows; the
  launchers' command lines (``--device`` only where one is given);
- ``phot_controller``: ``pending_subtractions`` and ``load_output``, the
  same rows; one ``main(once=True, device='cpu')`` that runs the
  forced-photometry worker as a process on a 256^2 difference frame with
  its rms and mask products, a planted source measured within 15%.
"""
import contextlib
import io
import os
import sqlite3
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'control'))
sys.path.insert(0, str(ROOT / 'scripts'))

import controller as jctl  # noqa: E402
import makesources as jms  # noqa: E402
import phot_controller as jpc  # noqa: E402
from zuds_tpu import bookkeeping as jbook, core as jcore  # noqa: E402
from zuds_tpu import detections as jdet, model_util as jmu  # noqa: E402
from zuds_tpu import secrets as jsecrets, source as jsource  # noqa: E402
from zuds_tpu_torch import bookkeeping as tbook, core as tcore  # noqa: E402
from zuds_tpu_torch import detections as tdet  # noqa: E402
from zuds_tpu_torch import model_util as tmu, phot as tphot  # noqa: E402
from zuds_tpu_torch import secrets as tsecrets  # noqa: E402
from zuds_tpu_torch import source as tsource, worker  # noqa: E402
from zuds_tpu_torch.control import controller as tctl  # noqa: E402
from zuds_tpu_torch.control import makesources as tms  # noqa: E402
from zuds_tpu_torch.control import phot_controller as tpc  # noqa: E402
from zuds_tpu_torch.image import ScienceImage as TSci  # noqa: E402

torch.set_num_threads(2)

PKGS = {
    'jax': dict(core=jcore, mu=jmu, secrets=jsecrets, det=jdet,
                source=jsource, book=jbook, ms=jms, ctl=jctl, pc=jpc),
    'torch': dict(core=tcore, mu=tmu, secrets=tsecrets, det=tdet,
                  source=tsource, book=tbook, ms=tms, ctl=tctl, pc=tpc),
}
QUAD = dict(field=679, ccdid=1, qid=2, fid=2)


@pytest.fixture()
def config(tmp_path, monkeypatch):
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


def both(tmp_path, fill, run):
    """``fill(pkg, sess)`` then ``run(pkg, sess)`` in each package on its
    own sqlite file. Returns {pkg: (run's result, db path)}."""
    out = {}
    for pkg in PKGS:
        db = tmp_path / f'{pkg}.db'
        with bound(pkg, db) as sess:
            fill(pkg, sess)
            out[pkg] = (run(pkg, sess), db)
    return out


# ---- makesources ------------------------------------------------------------

def scene_positions(seed=5, n=2400):
    """At least ``n`` seeded positions: isolated points, groups of 2-4
    within ~1.5 arcsec, 60 pairs straddling RA 0/360 (from the index
    returned) and 80 points within a few arcsec of the north pole (the
    last)."""
    rng = np.random.default_rng(seed)
    ra, dec = [], []
    while len(ra) < n - 200:
        r0, d0 = rng.uniform(0, 360), np.degrees(np.arcsin(rng.uniform(-1,
                                                                         1)))
        for _ in range(rng.choice([1, 1, 2, 3, 4])):
            ra.append((r0 + rng.normal(0, 0.4 / 3600)
                       / max(np.cos(np.radians(d0)), 1e-3)) % 360)
            dec.append(np.clip(d0 + rng.normal(0, 0.4 / 3600), -90, 90))
    wrap = len(ra)
    for _ in range(60):                   # across RA 0/360
        d0 = rng.uniform(-60, 60)
        off = rng.uniform(0.1, 1.5) / 3600 / np.cos(np.radians(d0))
        ra += [off / 2, 360 - off / 2]
        dec += [d0, d0 + rng.normal(0, 0.1 / 3600)]
    for _ in range(80):                   # near the pole
        ra.append(rng.uniform(0, 360))
        dec.append(90 - rng.uniform(0, 4) / 3600)
    return np.array(ra), np.array(dec), wrap


def test_cluster_positions_partition_matches():
    ra, dec, w = scene_positions()
    assert len(ra) >= 2000
    t = tms.cluster_positions(ra, dec)
    j = jms.cluster_positions(ra, dec)
    np.testing.assert_array_equal(t, j)
    assert 1 < len(np.unique(t)) < len(ra)
    # every pair across RA 0/360 is one cluster; the pole points cluster
    wrap = np.arange(w, w + 120).reshape(-1, 2)
    assert (t[wrap[:, 0]] == t[wrap[:, 1]]).all()
    assert len(np.unique(t[-80:])) < 80
    small = (np.array([150.0, 150.0001, 150.1, 150.1001, 151.0]),
             np.array([35.0, 35.0001, 35.0, 35.00005, 35.0]))
    np.testing.assert_array_equal(tms.cluster_positions(*small),
                                  jms.cluster_positions(*small))
    assert len(tms.cluster_positions(np.zeros(0), np.zeros(0))) == 0


def scripts_case(pkg, sess):
    """tests/test_scripts.py's association case."""
    D, S = PKGS[pkg]['det'].Detection, PKGS[pkg]['source'].Source
    sess.add(S(id='ZUDS26aaaaaa', ra=150.0, dec=35.0, origin='test'))
    sess.add_all([
        D(ra=150.00005, dec=35.00002, goodcut=1, rb=0.9, flux_aper=100,
          fluxerr_aper=5),
        D(ra=152.0, dec=30.0, goodcut=1, rb=0.8, flux_aper=80,
          fluxerr_aper=5),
        D(ra=152.00003, dec=30.00004, goodcut=1, rb=0.7, flux_aper=90,
          fluxerr_aper=5),
        D(ra=149.0, dec=20.0, goodcut=1, rb=0.05, flux_aper=60,
          fluxerr_aper=5)])
    sess.commit()


def seeded_case(pkg, sess, seed=9):
    """40 sources with detections near them; 60 groups of new detections
    (some below RB_ASSOC_MIN, some with no rb), lone ones, GOODCUT 0 rows
    and detections with a source already."""
    D, S = PKGS[pkg]['det'].Detection, PKGS[pkg]['source'].Source
    rng = np.random.default_rng(seed)
    rows = []
    for k in range(40):
        r0, d0 = rng.uniform(0, 360), rng.uniform(-30, 70)
        rows.append(S(id=f'ZUDS25{k:06d}', ra=r0, dec=d0, origin='old'))
        for _ in range(rng.integers(0, 3)):
            rows.append(D(ra=r0 + rng.normal(0, 0.3 / 3600),
                          dec=d0 + rng.normal(0, 0.3 / 3600), goodcut=1,
                          rb=float(rng.uniform()), flux_aper=10.0,
                          fluxerr_aper=1.0))
    for k in range(60):
        r0, d0 = rng.uniform(0, 360), rng.uniform(-30, 70)
        for _ in range(rng.integers(1, 4)):
            rb = rng.choice([None, 0.1, 0.2, 0.25, 0.9])
            rows.append(D(ra=r0 + rng.normal(0, 0.5 / 3600),
                          dec=d0 + rng.normal(0, 0.5 / 3600),
                          goodcut=int(rng.uniform() < 0.9),
                          rb=None if rb is None else float(rb),
                          flux_aper=10.0, fluxerr_aper=1.0))
    rows.append(D(ra=10.0, dec=10.0, goodcut=1, rb=0.9,
                  source_id='ZUDS25000000'))
    sess.add_all(rows)
    sess.commit()


@pytest.mark.parametrize('case', ['scripts', 'seeded'])
def test_associate_matches(case, config, tmp_path):
    fill = {'scripts': scripts_case, 'seeded': seeded_case}[case]
    res = both(tmp_path, fill,
               lambda pkg, sess: PKGS[pkg]['ms'].associate(sess))
    assert res['torch'][0] == res['jax'][0]
    for name in ('sources', 'detections'):
        assert table(res['torch'][1], name) == table(res['jax'][1], name)
    matched, new = res['torch'][0]
    if case == 'scripts':
        assert (matched, new) == (1, 1)
    else:
        assert matched > 10 and new > 5
    dets = table(res['torch'][1], 'detections')
    for d in dets:
        assert (d['triggers_alert'] == 1) == (
            d['source_id'] is not None and d['id'] != len(dets))
    # a second pass over the same rows finds nothing more to match
    with bound('torch', res['torch'][1]) as sess:
        assert tms.associate(sess)[1] == 0


def test_generate_source_name_matches(config, tmp_path):
    def fill(pkg, sess):
        S = PKGS[pkg]['source'].Source
        sess.add_all([S(id=f'X{k}', ra=1.0, dec=2.0) for k in range(28)])
        sess.commit()
    res = both(tmp_path, fill,
               lambda pkg, sess: PKGS[pkg]['ms'].generate_source_name(sess))
    assert res['torch'][0] == res['jax'][0]
    assert res['torch'][0].endswith('aaaabc')


# ---- controller -------------------------------------------------------------

def pairs_case(pkg, sess):
    """tests/test_scripts.py's quadrant (one pair subtracted, one failed)
    and a second quadrant with two references."""
    Z = PKGS[pkg]['core'].ZTFFile
    F = PKGS[pkg]['book'].FailedSubtraction
    quad2 = dict(QUAD, field=680)
    recs = [Z(type='ref', basename='ref.fits', **QUAD),
            Z(type='sci', basename='sci1.fits', **QUAD),
            Z(type='sci', basename='sci2.fits', **QUAD),
            Z(type='sci', basename='sci3.fits', **QUAD),
            Z(type='ref', basename='refa.fits', **quad2),
            Z(type='ref', basename='refb.fits', **quad2),
            Z(type='sci', basename='sci4.fits', **quad2),
            Z(type='sci', basename='sci5.fits', **dict(QUAD, fid=1))]
    sess.add_all(recs)
    sess.commit()
    sess.add(Z(type='sesub', basename='sub2.fits', target_id=recs[2].id,
               reference_id=recs[0].id, **QUAD))
    sess.add(F(target_image_id=recs[3].id, reference_image_id=recs[0].id))
    sess.add(F(reason='no ids: the nightly worker writes these'))
    sess.commit()


def test_unprocessed_pairs_match(config, tmp_path):
    res = both(tmp_path, pairs_case,
               lambda pkg, sess: PKGS[pkg]['ctl'].unprocessed_pairs(sess))
    assert res['torch'][0] == res['jax'][0]
    assert sorted(res['torch'][0]) == [('sci1.fits', 'ref.fits'),
                                      ('sci4.fits', 'refa.fits'),
                                      ('sci4.fits', 'refb.fits')]


class FakeLauncher:
    def __init__(self):
        self.submitted = []

    def submit(self, path, *args):
        self.submitted.append(path)
        return f'job-{len(self.submitted)}'

    def status(self, job_id):
        return {'job-1': 'done', 'job-2': 'running'}.get(job_id, 'error')


def test_run_once_and_refresh_match(config, tmp_path, monkeypatch):
    monkeypatch.setattr(tctl, 'JOB_SIZE', 2)
    monkeypatch.setattr(jctl, 'JOB_SIZE', 2)
    res = {}
    for pkg in PKGS:
        work = tmp_path / f'work_{pkg}'
        work.mkdir()
        launcher = FakeLauncher()
        with bound(pkg, tmp_path / f'{pkg}.db') as sess, \
                contextlib.redirect_stdout(io.StringIO()):
            pairs_case(pkg, sess)
            jobs = PKGS[pkg]['ctl'].run_once(sess, launcher, str(work))
            lists = [Path(p).read_text() for p in launcher.submitted]
            after = PKGS[pkg]['ctl'].refresh_job_status(sess, launcher)
            again = PKGS[pkg]['ctl'].refresh_job_status(sess, launcher)
        res[pkg] = (len(jobs), lists, [j.status for j in after],
                    [j.status for j in again],
                    table(tmp_path / f'{pkg}.db', 'jobs'))
    assert res['torch'] == res['jax']
    njobs, lists, after, again, rows = res['torch']
    assert njobs == 2 and lists[0].count('\n') == 2
    assert after == ['done', 'running'] and again == ['running']
    assert [r['status'] for r in rows] == ['done', 'running']


def test_launchers_start_the_port_s_worker(tmp_path, monkeypatch):
    """The local launcher starts ``python -m zuds_tpu_torch.nightly`` with
    the package on PYTHONPATH; ``--device`` only where one is given. The
    slurm launcher's script runs the same module."""
    started = []

    class Popen:
        pid = 4242

        def __init__(self, cmd, env=None):
            started.append((cmd, env))

        def poll(self):
            return 0

    monkeypatch.setattr(tctl.subprocess, 'Popen', Popen)
    for device, extra in ((None, []), ('cpu', ['--device', 'cpu'])):
        launcher = tctl.LocalLauncher(device=device)
        assert launcher.submit('w.txt') == '4242'
        assert launcher.status('4242') == 'done'
        assert launcher.status('7') == 'done'
        cmd, env = started[-1]
        assert cmd == [sys.executable, '-m', 'zuds_tpu_torch.nightly',
                       'w.txt', *extra]
        assert env['PYTHONPATH'].split(os.pathsep)[0] == str(ROOT)
    batches = []

    def run(cmd, **kw):
        out = ''                          # squeue: the job is gone
        if cmd[0] == 'sbatch':
            batches.append(Path(cmd[1]).read_text())
            os.remove(cmd[1])
            out = 'Submitted batch job 77\n'
        return subprocess.CompletedProcess(cmd, 0, out, '')

    monkeypatch.setattr(tctl.subprocess, 'run', run)
    slurm = tctl.SlurmLauncher(device='cuda:0')
    assert slurm.submit(str(tmp_path / 'w.txt')) == '77'
    assert f'-m zuds_tpu_torch.nightly {tmp_path / "w.txt"} --device ' \
        'cuda:0\n' in batches[0]
    assert slurm.status('77') == 'done'
    assert worker.split_device(['x', '--device', 'cpu', 'y']) == (
        ['x', 'y'], 'cpu')
    assert worker.split_device(['x']) == (['x'], None)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tphot.cli(['phot', '--device', 'cpu']) == 2


# ---- phot_controller --------------------------------------------------------

def phot_case(pkg, sess):
    Z = PKGS[pkg]['core'].ZTFFile
    S = PKGS[pkg]['source'].Source
    F = PKGS[pkg]['source'].ForcedPhotometryRecord
    recs = [Z(type=t, basename=f'{t}{k}.fits', **QUAD)
            for k, t in enumerate(['sesub', 'mesub', 'sesub', 'sci',
                                   'sesub'])]
    sess.add_all(recs)
    sess.add_all([S(id=f'ZUDS26a{k}', ra=1.0 + k, dec=2.0) for k in range(2)])
    sess.commit()
    # subtraction 2 measured for both sources, 0 for one
    sess.add_all([F(source_id='ZUDS26a0', image_id=recs[2].id),
                  F(source_id='ZUDS26a1', image_id=recs[2].id),
                  F(source_id='ZUDS26a0', image_id=recs[0].id)])
    sess.commit()


def test_pending_subtractions_match(config, tmp_path):
    res = both(tmp_path, phot_case,
               lambda pkg, sess: PKGS[pkg]['pc'].pending_subtractions(sess))
    assert res['torch'][0] == res['jax'][0]
    assert sorted(res['torch'][0]) == ['mesub1.fits', 'sesub0.fits',
                                       'sesub4.fits']
    assert tpc.in_time_window() is jpc.in_time_window() is True


def test_load_output_rows_match(config, tmp_path):
    csv_path = tmp_path / 'phot.all.csv'
    rows = ['source_id,image_id,ra,dec,flux,fluxerr,flags,zp,obsjd,'
            'filtercode']
    rows += [f'ZUDS26a{k % 2},{1 + k // 2},1.0,2.0,{10.5 * k},1.5,{k % 3},'
             f'26.3,{2458300.5 + k},zr' for k in range(6)]
    csv_path.write_text('\n'.join(rows) + '\n')

    def fill(pkg, sess):
        D = PKGS[pkg]['det'].Detection
        sess.add_all([D(ra=1.0, dec=2.0, source_id=s, triggers_alert=t,
                        alert_ready=a)
                      for s, t, a in (('ZUDS26a0', 1, None),
                                      (None, 1, None),
                                      ('ZUDS26a1', None, None),
                                      ('ZUDS26a1', 1, 0),
                                      ('ZUDS26a1', 1, None))])
        sess.commit()

    def run(pkg, sess):
        with contextlib.redirect_stdout(io.StringIO()):
            return PKGS[pkg]['pc'].load_output(sess, str(csv_path))
    res = both(tmp_path, fill, run)
    assert res['torch'][0] == res['jax'][0] == 6
    for name in ('forcedphotometry', 'detections'):
        assert table(res['torch'][1], name) == table(res['jax'][1], name)
    assert [d['alert_ready'] for d in
            table(res['torch'][1], 'detections')] == [1, None, None, 0, 1]


PLANT = (60.0, 80.0, 2e4)      # x, y (0-based) and flux on the difference


def write_difference(d, H=256, W=256, seed=4):
    """A 256^2 difference frame as a subtraction leaves it on disk: zero
    sky with noise 5, one PSF of PLANT's flux (seeing 2.8 px), its
    ``.rms.fits`` (5 everywhere) and ``.mask.fits`` products. Returns
    (path, WCS)."""
    from zuds_tpu_torch.fits import HDU, Header, write_fits
    from zuds_tpu_torch.wcs import TPVWCS
    rng = np.random.default_rng(seed)
    wcs = TPVWCS.simple(crval=(150.1, 35.2), crpix=(W / 2 + .5, H / 2 + .5),
                        scale_deg=1.01 / 3600)
    yy, xx = np.mgrid[0:H, 0:W]
    x0, y0, flux = PLANT
    sig = 2.8 / 2.355
    img = (flux * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * sig ** 2))
           / (2 * np.pi * sig ** 2) + rng.normal(0, 5.0, (H, W))).astype('f4')
    h = Header()
    wcs.to_header(h)
    for key, v in (('MAGZP', 26.3), ('OBSMJD', 58345.0), ('FIELDID', 679),
                   ('CCDID', 1), ('QID', 2), ('FILTERID', 2),
                   ('SEEING', 2.8)):
        h.set(key, v)
    path = str(d / 'sub.night_n0_sciimg_night_ref_sciimg.fits')
    write_fits(path, [HDU(h, img)])
    write_fits(path.replace('.fits', '.rms.fits'),
               [HDU(h.copy(), np.full((H, W), 5.0, 'f4'))])
    write_fits(path.replace('.fits', '.mask.fits'),
               [HDU(h.copy(), np.zeros((H, W), np.uint16))])
    return path, wcs


def test_phot_controller_main_runs_its_worker(config, tmp_path, monkeypatch):
    """One real poll: a 256^2 difference frame recorded as a ``sesub``
    and three sources (two on it, one off it), the worker run as a
    process on the CPU from the frame's directory (the work list holds
    basenames), its CSV loaded, the detection that triggers an alert
    flagged ready; the planted source's forced flux within 15% of its
    flux in r = 3 px."""
    path, wcs = write_difference(tmp_path)
    db = tmp_path / 'phot.db'
    config.write_text(f'sqlite_path: {db}\n')
    tsecrets._manager.cache = None
    ra, dec = wcs.pix2sky_0(np.array([PLANT[0], 200.0, 900.0]),
                            np.array([PLANT[1], 150.0, 40.0]))
    with bound('torch', db) as sess:
        rec = tcore.record_from_image(TSci.from_file(path), 'sesub')
        sess.add(rec)
        sess.add_all([tsource.Source(id=f'ZUDS26b{k}', ra=float(r),
                                     dec=float(d))
                      for k, (r, d) in enumerate(zip(ra, dec))])
        sess.add(tdet.Detection(ra=float(ra[0]), dec=float(dec[0]),
                                image_id=1, source_id='ZUDS26b0',
                                triggers_alert=1, goodcut=1))
        sess.commit()
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tpc.main(workdir=str(tmp_path / 'phot'), once=True, device='cpu')
    unbind()
    jobs = table(db, 'forcephotjobs')
    assert [j['status'] for j in jobs] == ['done'], out.getvalue()
    fp = {r['source_id']: r for r in table(db, 'forcedphotometry')}
    # the two sources inside the footprint, not the one off it
    assert sorted(fp) == ['ZUDS26b0', 'ZUDS26b1']
    sig = 2.8 / 2.355
    want = PLANT[2] * (1 - np.exp(-9.0 / (2 * sig ** 2)))
    assert abs(fp['ZUDS26b0']['flux'] - want) < 0.15 * want
    assert abs(fp['ZUDS26b1']['flux']) < 5 * fp['ZUDS26b1']['fluxerr']
    assert table(db, 'detections')[0]['alert_ready'] == 1
    assert 'photometered 2 measurements' in out.getvalue()
