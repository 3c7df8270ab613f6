"""Seeing from a catalog (twin of ``zuds_tpu/seeing.py:20-63``): the
median FWHM of a photometrically selected star sample (bright, round,
unsaturated, in the tight FWHM mode). This is the catalog branch of
``prepare_frame_inputs``; a frame without a catalog gets its SEEING from
the stamp moments (``ops.measure.seeing_from_stamps``)."""
from __future__ import annotations

import numpy as np

__all__ = ['estimate_seeing', 'select_stars']


def select_stars(cat, min_snr=20.0, max_elong=1.3, max_flags=0):
    """Star-like rows of a catalog structured array."""
    data = cat.data if hasattr(cat, 'data') else cat
    with np.errstate(invalid='ignore', divide='ignore'):
        snr = data['FLUX_APER'] / np.where(data['FLUXERR_APER'] > 0,
                                           data['FLUXERR_APER'], np.inf)
    good = ((snr > min_snr)
            & (data['ELONGATION'] < max_elong)
            & (data['FLAGS'] <= max_flags)
            & (data['IMAFLAGS_ISO'] == 0)
            & (data['FWHM_IMAGE'] > 0.5)
            & (data['FWHM_IMAGE'] < 15.0))
    stars = data[good]
    if len(stars) < 5:
        return stars
    # keep the tight FWHM mode: iteratively clip around the median
    fwhm = stars['FWHM_IMAGE'].astype(float)
    keep = np.ones(len(fwhm), dtype=bool)
    for _ in range(3):
        med = np.median(fwhm[keep])
        mad = np.median(np.abs(fwhm[keep] - med)) * 1.4826
        keep = np.abs(fwhm - med) < 3.0 * max(mad, 0.1)
    return stars[keep]


def estimate_seeing(image, catalog=None):
    """Write the ``SEEING`` header keyword (FWHM in pixels) of ``image``:
    the median FWHM of the star sample, the frame-wide median when fewer
    than 5 stars survive, 2.0 for an empty catalog."""
    cat = catalog if catalog is not None else image.catalog
    data = cat.data if hasattr(cat, 'data') else cat
    stars = select_stars(cat)
    if len(stars) >= 5:
        seeing = float(np.nanmedian(stars['FWHM_IMAGE']))
    elif len(data) > 0:
        seeing = float(np.nanmedian(data['FWHM_IMAGE']))
    else:
        seeing = 2.0  # ZTF-typical fallback; flagged in the header comment
    image.header.set('SEEING', seeing, 'FWHM of seeing in pixels [zuds-tpu]')
    image.header.set('NSTARSEE', int(len(stars)),
                     'number of stars used for SEEING')
    return seeing
