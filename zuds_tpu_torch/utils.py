"""Small host-side helpers (twin of ``zuds_tpu/utils.py``): the
observation MJD of a header, the robust background estimate of a frame,
the group-property check of a stack's inputs, a fresh directory, and the
timing helpers."""
from __future__ import annotations

import shutil
import time as _time
from pathlib import Path

import numpy as np

from .constants import FID_MAP

__all__ = ['initialize_directory', 'get_time', 'quick_background_estimate',
           'fid_map', 'ensure_images_have_the_same_properties', 'print_time',
           'mjd_from_header', 'Timer']

fid_map = FID_MAP


def initialize_directory(directory):
    """An empty ``directory``: removed first if it exists (utils.py:22-27).
    Returns its Path."""
    directory = Path(directory)
    if directory.exists():
        shutil.rmtree(directory)
    directory.mkdir(parents=True, exist_ok=True)
    return directory

_TIME_KEYS = ('MJD-OBS', 'OBSMJD', 'MJD', 'DATE-OBS', 'DATE')


def _mjd_from_isot(value):
    """ISO-8601 'YYYY-MM-DD[THH:MM:SS[.sss]]' -> MJD (UTC, no leap handling)."""
    value = value.strip()
    if 'T' in value:
        date, clock = value.split('T')
    elif ' ' in value:
        date, clock = value.split(' ', 1)
    else:
        date, clock = value, '00:00:00'
    y, m, d = (int(x) for x in date.split('-'))
    parts = clock.split(':')
    h = int(parts[0]) if len(parts) > 0 else 0
    mi = int(parts[1]) if len(parts) > 1 else 0
    s = float(parts[2]) if len(parts) > 2 else 0.0
    # Fliegel & Van Flandern JD from Gregorian date
    a = (14 - m) // 12
    yy = y + 4800 - a
    mm = m + 12 * a - 3
    jdn = d + (153 * mm + 2) // 5 + 365 * yy + yy // 4 - yy // 100 \
        + yy // 400 - 32045
    frac = (h - 12) / 24 + mi / 1440 + s / 86400
    return jdn + frac - 2400000.5


def mjd_from_header(header):
    """Best-effort observation MJD from any of the usual header keywords."""
    for key in _TIME_KEYS:
        if key in header:
            val = header[key]
            if isinstance(val, (int, float)):
                return float(val)
            try:
                return _mjd_from_isot(str(val))
            except Exception:
                continue
    raise KeyError(f'no time keyword in header (tried {_TIME_KEYS})')


def get_time(header_or_image, output='mjd'):
    """The observation time of a header or an image's header as MJD or, with
    ``output='jd'``, JD (utils.py:69-76)."""
    header = getattr(header_or_image, 'header', header_or_image)
    mjd = mjd_from_header(header)
    if output == 'mjd':
        return mjd
    if output == 'jd':
        return mjd + 2400000.5
    raise ValueError(f"output must be 'mjd' or 'jd', got {output!r}")


def quick_background_estimate(image, mask_image=None):
    """Median and 1.4826 * MAD of the unmasked, finite pixels
    (utils.py:79-93). ``image`` and ``mask_image`` are image objects or
    arrays; a mask image is read through its ``boolean`` projection. The
    reference unwraps the mask after ``np.asarray`` and so reads an
    ndarray's buffer attribute and raises for every mask; this unwraps
    first and applies the mask the reference's docstring describes."""
    data = np.asarray(getattr(image, 'data', image), dtype=np.float64)
    if mask_image is not None:
        bad = getattr(mask_image, 'boolean', mask_image)
        bad = np.asarray(getattr(bad, 'data', bad)).astype(bool)
        data = data[~bad]
    data = data[np.isfinite(data)]
    med = float(np.median(data))
    mad = float(np.median(np.abs(data - med)))
    return med, 1.4826 * mad


def ensure_images_have_the_same_properties(images, properties):
    """Raise if any of `properties` differs across `images`."""
    for prop in properties:
        vals = {getattr(image, prop) for image in images}
        if len(vals) > 1:
            raise ValueError(
                f'images have differing {prop!r} values: {sorted(vals)}')


def print_time(start, stop, obj, stepname):
    """The reference's timing line (utils.py:105-106)."""
    print(f'took {stop - start:.2f} sec to {stepname} {obj}', flush=True)


class Timer:
    """Context timer: ``with Timer('warp') as t: ...; t.elapsed``
    (utils.py:109-124)."""

    def __init__(self, name='', quiet=True):
        self.name = name
        self.quiet = quiet
        self.elapsed = None

    def __enter__(self):
        self.t0 = _time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = _time.perf_counter() - self.t0
        if not self.quiet:
            print(f'[{self.name}] {self.elapsed:.3f}s', flush=True)
