"""Bitmask images (twin of ``zuds_tpu/mask.py``): ZTF mask bit planes
(``constants.MASK_COMMENTS``), ``BAD_SUM`` selecting the science-fatal
subset."""
from __future__ import annotations

import numpy as np

from .constants import (BAD_SUM, MASK_BITS, MASK_COMMENTS,
                        MASK_BIT_NODATA_ALIGN)
from .image import FITSImage

__all__ = ['MaskImageBase', 'MaskImage']


class MaskImageBase(FITSImage):
    """Integer bitmask frame with boolean bad-pixel projection."""

    @property
    def boolean(self):
        """FITSImage whose data is True where any BAD_SUM bit is set
        (mask.py:22-36)."""
        try:
            return self._boolean
        except AttributeError:
            bad = (np.asarray(self.data).astype(np.uint32) & BAD_SUM) > 0
            b = FITSImage()
            b.data = bad
            b.header = self.header.copy()
            if self.basename:
                b.basename = self.basename.replace('.fits', '.bpm.fits')
            self._boolean = b
        return self._boolean

    def refresh_bit_mask_entries_in_header(self):
        """Write the bit-plane legend into the header."""
        for key, bit in MASK_BITS.items():
            self.header.set(key, bit, MASK_COMMENTS.get(key, ''))

    def update_from_weight_map(self, weight_image):
        """Set the no-data bit where the resampled weight or coverage is
        zero (mask.py:42-50)."""
        wd = np.asarray(getattr(weight_image, 'data', weight_image))
        mask = np.asarray(self.data).astype(np.int64)
        mask[wd == 0] |= (1 << MASK_BIT_NODATA_ALIGN)
        self.data = mask.astype(np.int32)
        if hasattr(self, '_boolean'):
            del self._boolean


class MaskImage(MaskImageBase):
    """A mask attached to a parent science image."""

    parent_image = None

    @classmethod
    def from_parent(cls, parent, data=None):
        obj = cls()
        obj.parent_image = parent
        obj.header = parent.header.copy()
        if data is not None:
            obj.data = data
        if parent.basename:
            obj.basename = parent.basename.replace('sciimg', 'mskimg')
        return obj
