"""Subtraction control daemon of the port (twin of ``control/controller.py``;
the reference is nersc/controller.py).

    python -m zuds_tpu_torch.control.controller [--once] [--device DEV]

binds the configured database and, every POLL_S seconds, refreshes the
status of its ``Job`` rows, lists the science frames that have a
reference of their quadrant and neither a ``sesub`` record nor a
``FailedSubtraction`` for that pair, writes them in chunks of JOB_SIZE to
work lists and starts a nightly worker on each (``python -m
zuds_tpu_torch.nightly``: the per-pair chain on the card, or on ``device``
where one is given), one ``Job`` row each. Workers run under slurm
(sbatch, squeue) where ``sbatch`` exists, else as local processes.

The work lists hold the records' basenames, as the reference writes them
(controller.py:113-115), while the worker opens each line as a path: the
daemon runs in the frames' directory, and a local worker inherits it.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

__all__ = ['JOB_SIZE', 'POLL_S', 'WORKER', 'unprocessed_pairs',
           'LocalLauncher', 'SlurmLauncher', 'run_once',
           'refresh_job_status', 'main']

JOB_SIZE = 64 * 15          # images per job (controller.py:21)
POLL_S = 30
WORKER = 'zuds_tpu_torch.nightly'


def unprocessed_pairs(session):
    """(sci basename, ref basename) of the pairs needing a subtraction
    (the anti-join of controller.py:24-37; its string literals in double
    quotes, which sqlite reads as strings)."""
    rows = session.execute(
        'SELECT s.basename, r.basename FROM ztffiles s '
        'JOIN ztffiles r ON r.type = "ref" AND r.field = s.field AND '
        ' r.ccdid = s.ccdid AND r.qid = s.qid AND r.fid = s.fid '
        'WHERE s.type = "sci" '
        'AND NOT EXISTS (SELECT 1 FROM ztffiles z WHERE z.type = "sesub" '
        '  AND z.target_id = s.id AND z.reference_id = r.id) '
        'AND NOT EXISTS (SELECT 1 FROM failedsubtractions f WHERE '
        '  f.target_image_id = s.id AND f.reference_image_id = r.id)'
    ).fetchall()
    return [(r[0], r[1]) for r in rows]


class LocalLauncher:
    """Workers as local processes (controller.py:40-58), started in this
    process's working directory, ``--device`` only where ``device`` is
    given."""

    def __init__(self, device=None):
        self.device = device
        self.procs = {}

    def submit(self, worklist_path):
        from ..worker import device_args, package_env
        p = subprocess.Popen([sys.executable, '-m', WORKER, worklist_path,
                              *device_args(self.device)],
                             env=package_env())
        self.procs[str(p.pid)] = p
        return str(p.pid)

    def status(self, job_id):
        p = self.procs.get(job_id)
        if p is None:
            return 'done'
        rc = p.poll()
        if rc is None:
            return 'running'
        return 'done' if rc == 0 else 'error'


class SlurmLauncher:
    """sbatch submission and squeue polling (controller.py:61-102)."""

    def __init__(self, nodes=1, ntasks=64, walltime='00:60:00',
                 queue='realtime', device=None):
        self.nodes = nodes
        self.ntasks = ntasks
        self.walltime = walltime
        self.queue = queue
        self.device = device

    @staticmethod
    def available():
        return shutil.which('sbatch') is not None

    def submit(self, worklist_path):
        from ..worker import device_args
        args = ' '.join([worklist_path, *device_args(self.device)])
        batch = f"""#!/bin/bash
#SBATCH -N {self.nodes}
#SBATCH -q {self.queue}
#SBATCH -t {self.walltime}
#SBATCH -o {worklist_path}.out
srun -n {self.ntasks} -c1 {sys.executable} -m {WORKER} {args}
"""
        with tempfile.NamedTemporaryFile('w', suffix='.sh',
                                         delete=False) as f:
            f.write(batch)
            path = f.name
        out = subprocess.run(['sbatch', path], capture_output=True,
                             text=True, check=True)
        return out.stdout.strip().split()[-1]

    def status(self, job_id):
        out = subprocess.run(['squeue', '-j', job_id, '-h', '-o', '%T'],
                             capture_output=True, text=True)
        state = out.stdout.strip()
        if not state:
            return 'done'   # gone from squeue: finished
        if state in ('PENDING', 'CONFIGURING'):
            return 'queued'
        if state == 'RUNNING':
            return 'running'
        return state.lower()


def run_once(session, launcher, workdir):
    """One control iteration (controller.py:105-122): the unprocessed
    pairs in chunks of JOB_SIZE, one work list and one submitted ``Job``
    a chunk. Returns the jobs."""
    from ..bookkeeping import Job
    pairs = unprocessed_pairs(session)
    submitted = []
    for i in range(0, len(pairs), JOB_SIZE):
        chunk = pairs[i:i + JOB_SIZE]
        path = os.path.join(workdir, f'work_{int(time.time())}_{i}.txt')
        with open(path, 'w') as f:
            for sci, ref in chunk:
                f.write(f'{sci} {ref}\n')
        job_id = launcher.submit(path)
        job = Job(slurm_id=job_id, status='submitted')
        session.add(job)
        session.commit()
        submitted.append(job)
        print(f'submitted job {job_id} with {len(chunk)} images', flush=True)
    return submitted


def refresh_job_status(session, launcher):
    """The launcher's status of every submitted, queued or running
    ``Job``, committed (controller.py:125-133). Returns those jobs."""
    from ..bookkeeping import Job
    jobs = session.query(Job).filter(
        'status IN ("submitted", "queued", "running")').all()
    for job in jobs:
        job.status = launcher.status(job.slurm_id)
        session.add(job)
    session.commit()
    return jobs


def main(workdir=None, once=False, device=None):
    """Bind the configured database, then every POLL_S seconds (once with
    ``once``) :func:`refresh_job_status` and :func:`run_once`, work lists
    in ``workdir`` (a ``zuds-tpu-work`` directory of the temporary
    directory by default), through slurm where ``sbatch`` exists, else
    local processes."""
    from ..core import DBSession
    from ..model_util import init_db
    init_db()
    workdir = workdir or os.path.join(tempfile.gettempdir(),
                                      'zuds-tpu-work')
    os.makedirs(workdir, exist_ok=True)
    launcher = SlurmLauncher(device=device) if SlurmLauncher.available() \
        else LocalLauncher(device=device)
    while True:
        sess = DBSession()
        refresh_job_status(sess, launcher)
        run_once(sess, launcher, workdir)
        if once:
            break
        time.sleep(POLL_S)


if __name__ == '__main__':
    from ..worker import split_device
    _argv, _device = split_device(sys.argv)
    main(once='--once' in _argv, device=_device)
