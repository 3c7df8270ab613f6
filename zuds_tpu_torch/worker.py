"""What the port's worker processes share: the ``--device`` option of their
command lines and their start on that device.

The worker entry points (``python -m zuds_tpu_torch.nightly``,
``python -m zuds_tpu_torch.phot``) run on the card unless ``--device``
names another device; a worker that finds no card raises
(``inputs.resolve_device``), it never falls back to the CPU. The control
daemons pass ``--device`` only when their caller gave one.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

__all__ = ['split_device', 'device_args', 'package_env', 'process_seconds',
           'start', 'report_launches']


def split_device(argv):
    """(``argv`` without its ``--device DEV``, DEV or None)."""
    argv = list(argv)
    if '--device' not in argv:
        return argv, None
    i = argv.index('--device')
    if i + 1 >= len(argv):
        raise SystemExit('--device needs a value')
    return argv[:i] + argv[i + 2:], argv[i + 1]


def device_args(device):
    """The ``--device`` arguments a daemon gives a worker: none without a
    device, so the worker takes the card."""
    return [] if device is None else ['--device', str(device)]


def package_env():
    """This process's environment with the directory that holds
    ``zuds_tpu_torch`` first on ``PYTHONPATH``: a worker started as
    ``python -m zuds_tpu_torch.<name>`` imports this package from any
    working directory."""
    root = str(Path(__file__).resolve().parent.parent)
    path = os.environ.get('PYTHONPATH')
    return {**os.environ,
            'PYTHONPATH': root + (os.pathsep + path if path else '')}


def process_seconds():
    """Wall seconds since this process started (Linux ``/proc``; None
    elsewhere)."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        return None


def start(name, device):
    """Resolve ``device`` (the card for None) and, on a card, load the
    kernel library; print the seconds since the process started and
    whether the library was built already. Returns the device."""
    from .inputs import resolve_device
    dev = resolve_device(device)
    line = f'{name}: on {dev}'
    if dev.type == 'cuda':
        import torch
        from .kernels import build
        built = build.library_path().exists()
        t0 = time.perf_counter()
        build.library()
        torch.zeros(1, device=dev)          # the context, made here
        line += (f', kernel library {build.library_path()} '
                 f'{"loaded" if built else "built"} in '
                 f'{time.perf_counter() - t0:.2f} s')
    secs = process_seconds()
    if secs is not None:
        line += f', ready {secs:.2f} s after the process started'
    print(line, flush=True)
    return dev


def report_launches(name):
    """Print the kernel launches this process made (each wrapper's count):
    what a worker ran on the card."""
    from .kernels import all_wrappers
    used = {k: w.launches for k, w in all_wrappers().items() if w.launches}
    print(f'{name}: kernel launches {used}', flush=True)
