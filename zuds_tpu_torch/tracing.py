"""Structured tracing and profiling (twin of ``zuds_tpu/tracing.py``).

* ``timed(name)``: a context manager recording wall-clock spans into a
  process-local registry (the reference's ``print_time`` pairs, queryable
  and silent by default); ``traced(name)`` is its decorator form.
* ``device_profile(logdir)``: ``torch.profiler`` over the enclosed block,
  with CPU and, where a card is present, CUDA activities, exported as a
  Chrome trace (``trace.json``) into ``logdir``; the profile is yielded.
* ``report()``: the recorded spans as a table (count, total, mean, max).

``ZUDS_TRACE=1`` (any value but empty or ``0``) prints each span as it
closes.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time

__all__ = ['timed', 'traced', 'device_profile', 'report', 'spans', 'reset',
           'print_time']

_lock = threading.Lock()
_spans = {}          # name -> (count, total, max)
_live = os.environ.get('ZUDS_TRACE', '') not in ('', '0')


def reset():
    with _lock:
        _spans.clear()


def spans():
    """Snapshot {name: (count, total_s, mean_s, max_s)}."""
    with _lock:
        return {k: (c, t, t / c if c else 0.0, m)
                for k, (c, t, m) in _spans.items()}


def _record(name, dt):
    with _lock:
        c, t, m = _spans.get(name, (0, 0.0, 0.0))
        _spans[name] = (c + 1, t + dt, max(m, dt))
    if _live:
        print(f'[trace] {name}: {dt:.3f}s', flush=True)


@contextlib.contextmanager
def timed(name):
    """Record a wall-clock span."""
    t0 = time.time()
    try:
        yield
    finally:
        _record(name, time.time() - t0)


def traced(name=None):
    """Decorator form of :func:`timed` (the function's qualified name by
    default)."""
    def wrap(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def inner(*a, **kw):
            with timed(label):
                return fn(*a, **kw)
        return inner
    return wrap


@contextlib.contextmanager
def device_profile(logdir='/tmp/zuds-tpu-trace'):
    """``torch.profiler`` over the enclosed block (tracing.py:77-98, which
    wraps ``jax.profiler.trace``): CPU activities, and CUDA's where a card
    is present. On exit the trace is written to ``<logdir>/trace.json``
    (Chrome's format, read by Perfetto); the profile object is yielded, so
    ``prof.key_averages()`` reads the kernels' device times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


def report(out=None):
    """Formatted span table (the reference's end-of-run print analogue)."""
    import sys
    out = out or sys.stdout
    snap = spans()
    if not snap:
        return
    width = max(len(k) for k in snap)
    print(f'{"span".ljust(width)}  count   total     mean      max',
          file=out)
    for name, (c, t, mean, m) in sorted(snap.items(),
                                        key=lambda kv: -kv[1][1]):
        print(f'{name.ljust(width)}  {c:5d}  {t:7.2f}s  {mean:7.3f}s '
              f'{m:8.3f}s', file=out)


def print_time(start, stop, obj, step):
    """The reference's helper (utils.py:68-70) that also feeds the span
    registry."""
    dt = stop - start
    _record(str(step), dt)
    print(f'took {dt:.2f} sec to {step} for {obj}', flush=True)
