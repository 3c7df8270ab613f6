"""Forced-photometry daemon of the port (twin of
``control/phot_controller.py``; the reference is nersc/phot_controller.py).

    python -m zuds_tpu_torch.control.phot_controller [--once] [--device DEV]

binds the configured database and, every POLL_S seconds (within 16-19 UTC
with ``gate_hours``), lists the subtractions some source has no forced
photometry on, runs the forced-photometry worker over them as a process
(``python -m zuds_tpu_torch.phot``: H22 on the card, or on ``device``
where one is given), loads its CSV (``loadphot.load``) and flags
``alert_ready`` on each detection that triggers an alert and has a
source. Each run is a ``ForcePhotJob`` row.

The work list holds the records' basenames, as the reference writes it:
the worker opens them from its working directory, this process's, so the
daemon runs in the subtractions' directory.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time

__all__ = ['POLL_S', 'in_time_window', 'pending_subtractions',
           'run_phot_job', 'load_output', 'main']

POLL_S = 60


def in_time_window(gate=False):
    """True, or with ``gate`` whether the UTC hour is 16-18
    (phot_controller.py:21-27)."""
    if not gate:
        return True
    hour = datetime.datetime.now(datetime.timezone.utc).hour
    return 16 <= hour < 19


def pending_subtractions(session, limit=1_000_000):
    """Basenames of the ``sesub``/``mesub`` records lacking a forced
    measurement of some source (phot_controller.py:30-36; the string
    literals in double quotes, as there, which sqlite reads as strings)."""
    rows = session.execute(
        'SELECT DISTINCT z.basename FROM ztffiles z, sources s '
        'WHERE z.type IN ("sesub", "mesub") AND NOT EXISTS ('
        '  SELECT 1 FROM forcedphotometry fp WHERE fp.image_id = z.id '
        '  AND fp.source_id = s.id) LIMIT ?', (limit,)).fetchall()
    return [r[0] for r in rows]


def run_phot_job(worklist_path, outdir, device=None):
    """The forced-photometry worker over ``worklist_path`` as a process
    (phot_controller.py:39-45), ``--device`` only where ``device`` is
    given; raises ``CalledProcessError`` when it fails. Returns the merged
    CSV's path."""
    from ..worker import device_args, package_env
    subprocess.run([sys.executable, '-m', 'zuds_tpu_torch.phot',
                    worklist_path, outdir, *device_args(device)],
                   check=True, env=package_env())
    return os.path.join(outdir, 'phot.all.csv')


def load_output(session, csv_path):
    """Load the worker's CSV and flag ``alert_ready`` on the detections
    that trigger an alert, have a source and are not flagged yet
    (phot_controller.py:48-59). Returns the number of rows loaded."""
    from ..loadphot import load
    n = load(csv_path)
    session.execute(
        'UPDATE detections SET alert_ready = 1 WHERE triggers_alert = 1 '
        'AND source_id IS NOT NULL AND alert_ready IS NULL')
    session.conn.commit()
    return n


def main(workdir=None, once=False, gate_hours=False, device=None):
    """Bind the configured database; then each poll (one with ``once``):
    the pending subtractions to a work list in ``workdir`` (a
    ``zuds-tpu-phot`` directory of the temporary directory by default), a
    ``ForcePhotJob``, :func:`run_phot_job` and :func:`load_output`; the
    job ends ``done``, or ``error`` when the worker or the load
    failed."""
    from ..bookkeeping import ForcePhotJob
    from ..core import DBSession
    from ..model_util import init_db
    init_db()
    workdir = workdir or os.path.join(tempfile.gettempdir(),
                                      'zuds-tpu-phot')
    os.makedirs(workdir, exist_ok=True)
    while True:
        if in_time_window(gate_hours):
            sess = DBSession()
            subs = pending_subtractions(sess)
            if subs:
                path = os.path.join(workdir, f'phot_{int(time.time())}.txt')
                with open(path, 'w') as f:
                    f.write('\n'.join(subs) + '\n')
                job = ForcePhotJob(status='running', detection_file=path)
                sess.add(job)
                sess.commit()
                try:
                    csv_path = run_phot_job(path, workdir, device=device)
                    n = load_output(sess, csv_path)
                    job.status = 'done'
                    job.output_file = csv_path
                    print(f'photometered {n} measurements', flush=True)
                except Exception:
                    import traceback
                    traceback.print_exc()
                    job.status = 'error'
                sess.add(job)
                sess.commit()
        if once:
            break
        time.sleep(POLL_S)


if __name__ == '__main__':
    from ..worker import split_device
    _argv, _device = split_device(sys.argv)
    main(once='--once' in _argv, device=_device)
