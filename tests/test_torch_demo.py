"""The demo twin (``python -m zuds_tpu_torch.demo``) on the CPU at 256^2,
the smallest size that holds its transient: the reference coadd, the
subtraction, the funnel, forced photometry, the records and the spooled
Avro alert, with the transient among the candidates and its forced flux
near the planted one. The process starts fresh, with no ``ZUDS_CONFIG``:
the demo seeds its own config in the work directory."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_demo_runs_on_the_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != 'ZUDS_CONFIG'}
    env['PYTHONPATH'] = str(ROOT)
    env['OMP_NUM_THREADS'] = '2'
    work = tmp_path / 'demo'
    proc = subprocess.run(
        [sys.executable, '-m', 'zuds_tpu_torch.demo', str(work), '--device',
         'cpu', '--size', '256'], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert 'demo complete' in out
    n = int(out.split(' candidates survive the funnel')[0].split()[-1])
    assert n >= 1
    flux = float(out.split('  flux ')[1].split()[0])
    # a 25000-count source in the r = 3 px aperture at seeing 2.4 px
    assert 0.8 * 25000 < flux < 1.05 * 25000
    assert (work / 'demo.db').exists() and (work / 'ref.fits').exists()
    spool = work / 'data' / 'alerts'
    files = [p for p in spool.rglob('*.avro')]
    assert len(files) == 1 and files[0].read_bytes()[:4] == b'Obj\x01'
    assert (work / 'config.yaml').stat().st_mode & 0o077 == 0
