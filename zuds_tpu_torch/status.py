"""Terminal progress-line context manager (twin of ``zuds_tpu/status.py``)."""
import sys
import time
from contextlib import contextmanager

__all__ = ['status']


@contextmanager
def status(message):
    """Print ``[·] message``, then rewrite it as ``[✓]`` or ``[✗]`` with
    the elapsed time."""
    print(f'[·] {message}', end='')
    sys.stdout.flush()
    t0 = time.time()
    try:
        yield
    except Exception:
        print(f'\r[✗] {message}')
        raise
    else:
        elapsed = time.time() - t0
        print(f'\r[✓] {message} ({elapsed:.1f}s)')
    finally:
        sys.stdout.flush()
