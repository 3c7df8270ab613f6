"""Forced aperture photometry, host API (twin of ``zuds_tpu/photometry.py``).

Both entry points keep the reference's signatures: the sky positions go
through the frame's own TPV WCS (``wcs.sky2pix_0``) and every r = 3 px
aperture of the call is measured in one launch of H22
(``ops/photometry.aperture_photometry_batched``) on ``device``, the card
unless the caller passes ``'cpu'``. An aperture that leaves the frame
(``oob``) gets NaN ``flux`` and ``fluxerr`` and ``bad=True``; ``zp`` is
``MAGZP``, plus ``APER_KEY`` under ``apply_calibration``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from .constants import APERTURE_RADIUS_PX, APER_KEY, BAD_SUM

__all__ = ['ForcedPhotometry', 'raw_aperture_photometry',
           'aperture_photometry']


@dataclass
class ForcedPhotometry:
    """One source x image forced-photometry measurement (its database row
    is ``source.ForcedPhotometryRecord``, as in the reference)."""

    flux: float = np.nan
    fluxerr: float = np.nan
    flags: int = 0
    ra: float = np.nan
    dec: float = np.nan
    zp: float = 0.0
    filtercode: Optional[str] = None
    obsjd: Optional[float] = None
    uniform: bool = False
    source: Any = None
    image: Any = None
    id: Optional[int] = None

    @property
    def mag(self):
        return self.zp - 2.5 * np.log10(self.flux) if self.flux > 0 \
            else np.nan

    @property
    def magerr(self):
        return 1.0857 * self.fluxerr / self.flux if self.flux > 0 else np.nan


def _measure(pixels, rms, mask, wcs, header, ra, dec, apply_calibration,
             device):
    """The r = 3 px apertures at the sky positions on host frames: one
    upload each, one H22 launch, one fetch. Returns the dict of
    :func:`raw_aperture_photometry`, ``zp`` from ``header``."""
    import torch
    from .ops.photometry import aperture_photometry_batched

    ra = np.atleast_1d(np.asarray(ra, dtype=float))
    dec = np.atleast_1d(np.asarray(dec, dtype=float))
    x, y = wcs.sky2pix_0(ra, dec)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)).to(
            device)

    out = aperture_photometry_batched(
        up(pixels, np.float32), up(rms, np.float32),
        None if mask is None else up(mask, np.int32),
        up(np.asarray(x, 'f4'), np.float32),
        up(np.asarray(y, 'f4'), np.float32), r=float(APERTURE_RADIUS_PX))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    flux, fluxerr, oob = out['flux'], out['fluxerr'], out['oob']
    flux[oob] = np.nan
    fluxerr[oob] = np.nan
    flags = out['flags']
    zp = header.get('MAGZP', 0.0) or 0.0
    if apply_calibration:
        zp = zp + (header.get(APER_KEY, 0.0) or 0.0)
    return {'flux': flux, 'fluxerr': fluxerr, 'flags': flags,
            'bad': ((flags & BAD_SUM) > 0) | oob, 'zp': zp, 'x': x, 'y': y}


def raw_aperture_photometry(sci_path, rms_path, mask_path, ra, dec,
                            apply_calibration=False, device=None):
    """Path-based forced photometry (photometry.py:49-90): the science,
    rms and mask frames from their files, the r = 3 px apertures at
    (ra, dec) on ``device``. Returns a dict of arrays ``flux``,
    ``fluxerr``, ``flags``, ``bad`` and the positions ``x``, ``y``, and
    the float ``zp``."""
    from .image import FITSImage
    from .inputs import resolve_device
    from .mask import MaskImageBase

    device = resolve_device(device)
    sci = FITSImage.from_file(sci_path)
    rms = FITSImage.from_file(rms_path)
    mask = MaskImageBase.from_file(mask_path)
    return _measure(sci.data, rms.data, mask.data, sci.wcs, sci.header, ra,
                    dec, apply_calibration, device)


def aperture_photometry(calibratable, ra, dec, apply_calibration=False,
                        assume_background_subtracted=False,
                        use_cutout=False, direct_load=None, device=None):
    """Object-based forced photometry (photometry.py:93-137): the image's
    pixels (its background-subtracted frame unless
    ``assume_background_subtracted``), its rms frame and its mask (zeros
    without one). ``use_cutout`` and ``direct_load`` are accepted and
    ignored, as in the reference: the whole frame goes to the card once.
    ``device``: where the apertures run, the image's ``device`` when None
    (the card unless ``'cpu'``); the background and rms products this call
    derives are computed there too, and the image keeps its own
    ``device``. Returns the dict of :func:`raw_aperture_photometry`."""
    from .inputs import resolve_device

    own = calibratable.device
    device = resolve_device(device if device is not None else own)
    calibratable.device = device
    try:
        pixels = (calibratable.data if assume_background_subtracted
                  else calibratable.background_subtracted_image.data)
        rms = calibratable.rms_image.data
    finally:
        calibratable.device = own
    mask = (calibratable.mask_image.data
            if calibratable.mask_image is not None else None)
    return _measure(pixels, rms, mask, calibratable.wcs, calibratable.header,
                    ra, dec, apply_calibration, device)
