"""Small host-side helpers (twin of ``zuds_tpu/utils.py:19-66, 79-102``):
the observation MJD of a header, the robust background estimate of a frame
and the group-property check of a stack's inputs."""
from __future__ import annotations

import numpy as np

__all__ = ['mjd_from_header', 'quick_background_estimate',
           'ensure_images_have_the_same_properties']

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
