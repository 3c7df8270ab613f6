"""FITS-backed files and the WCS-aware mixin (twin of
``zuds_tpu/fitsfile.py:21-160``).

``FITSFile`` couples the File protocol to the port's FITS codec; ``HasWCS``
adds the TPV WCS, sky footprints, the pixel mapping onto another frame and
``aligned_to``, the per-pair warp (``align.py``).
"""
from __future__ import annotations

import os

import numpy as np

from .file import File
from .fits import Header, HDU, read_fits, write_fits, read_header
from .wcs import TPVWCS, pixel_mapping

__all__ = ['FITSFile', 'HasWCS']


class FITSFile(File):
    """A File whose on-disk representation is a single-HDU FITS image."""

    __diskmapped_cached_properties__ = ['_path', '_data']

    header = None

    def __init__(self, basename=None, data=None, header=None):
        super().__init__(basename)
        if header is not None:
            self.header = header
        if self.header is None:
            self.header = Header()
        if data is not None:
            self._data = data

    @classmethod
    def from_file(cls, fname, load_data=False, **kwargs):
        obj = cls.__new__(cls)
        File.__init__(obj)
        obj.header = read_header(fname)
        obj.map_to_local_file(fname)
        obj.basename = os.path.basename(fname)
        if load_data:
            obj.load()
        return obj

    def load_header(self):
        """Read the header from the mapped file (fitsfile.py:59-60)."""
        self.header = read_header(self.local_path)

    @property
    def data(self):
        try:
            return self._data
        except AttributeError:
            self.load()
        return self._data

    @data.setter
    def data(self, value):
        self._data = value

    def load(self):
        hdus = read_fits(self.local_path)
        hdu = next((h for h in hdus if h.data is not None), hdus[0])
        self._data = hdu.data
        if len(hdu.header) > len(self.header or ()):
            self.header = hdu.header

    def unload(self):
        """Drop the pixels; the next read loads them again (fitsfile.py:
        91-93)."""
        if hasattr(self, '_data'):
            del self._data

    def save(self, path=None):
        if path is not None:
            self.map_to_local_file(path)
        data = self._data if hasattr(self, '_data') else None
        data = np.asarray(data) if data is not None else None
        write_fits(self.local_path, [HDU(self.header, data)])

    def __repr__(self):
        return f'<{type(self).__name__} {self.basename}>'


class HasWCS(FITSFile):
    """FITSFile with a TPV world coordinate system."""

    @property
    def wcs(self):
        try:
            return self._wcs
        except AttributeError:
            self._wcs = TPVWCS.from_header(self.header)
        return self._wcs

    @wcs.setter
    def wcs(self, value):
        self._wcs = value
        value.to_header(self.header)

    @classmethod
    def from_file(cls, fname, **kwargs):
        obj = super().from_file(fname, **kwargs)
        naxis1 = obj.header.get('NAXIS1')
        naxis2 = obj.header.get('NAXIS2')
        if naxis1 and naxis2 and 'CRVAL1' in obj.header:
            fp = obj.wcs.footprint(naxis1, naxis2)
            for i in range(4):
                setattr(obj, f'ra{i + 1}', float(fp[i, 0]))
                setattr(obj, f'dec{i + 1}', float(fp[i, 1]))
            ra, dec = obj.wcs.center(naxis1, naxis2)
            obj.ra = float(ra)
            obj.dec = float(dec)
        return obj

    @property
    def shape(self):
        if 'NAXIS2' in self.header and 'NAXIS1' in self.header:
            return (self.header['NAXIS2'], self.header['NAXIS1'])
        return self.data.shape

    @property
    def pixel_scale(self):
        """Pixel scale in arcsec (mean of axes, from the CD determinant)."""
        return self.wcs.pixel_scale_arcsec()

    def footprint(self):
        h, w = self.shape
        return self.wcs.footprint(w, h)

    def contains(self, ra, dec):
        """True where (ra, dec) lands inside the frame."""
        h, w = self.shape
        x, y = self.wcs.sky2pix_0(np.asarray(ra), np.asarray(dec))
        return (x >= -0.5) & (x <= w - 0.5) & (y >= -0.5) & (y <= h - 0.5)

    def mapping_to(self, other, step=32):
        """Coarse pixel mapping from this frame onto ``other``'s grid."""
        h, w = other.shape
        return pixel_mapping(self.wcs, other.wcs, (h, w), step=step)

    def aligned_to(self, other, persist_aligned=False, tmpdir=None,
                   device=None, **kw):
        """Resample this image onto ``other``'s WCS pixel grid
        (fitsfile.py:164-175): masks through the conservative OR warp,
        science frames through the Lanczos-3 warp. Returns a new in-memory
        object of matching kind with the target WCS and its ``coverage``.
        ``device``: the image's own when None (the card unless ``'cpu'``)."""
        from .align import align_image
        return align_image(self, other, persist_aligned=persist_aligned,
                           device=device)
