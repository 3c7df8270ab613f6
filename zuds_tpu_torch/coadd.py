"""Coadded images (twin of ``zuds_tpu/coadd.py:276-299``): the reference
image the night driver subtracts. Building a coadd (``Coadd.from_images``,
K16) is ROADMAP queue 1, item "Coadd"."""
from __future__ import annotations

from .constants import REFERENCE_VERSION
from .image import CalibratedImage

__all__ = ['Coadd', 'ReferenceImage']


class Coadd(CalibratedImage):
    """Combination of multiple epochs of one quadrant."""

    __ztf_type__ = 'coadd'

    input_images = None


class ReferenceImage(Coadd):
    """Template coadd used as the subtraction reference."""

    __ztf_type__ = 'ref'

    version = REFERENCE_VERSION
