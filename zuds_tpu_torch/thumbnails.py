"""Detection stamp thumbnails (twin of ``zuds_tpu/thumbnails.py``).

63x63 cutouts around detections in new/ref/sub frames, gzip-FITS bytes
stored in the DB (BYTEA analogue: sqlite BLOB). The FITS bytes come from
the port's own writer (``fits.fits_bytes``), the same bytes the reference
writes to a temporary file; ``gzip.compress`` stamps the time into its
header, so two runs' blobs differ there and decompress to equal files.

Not ported yet: ``Thumbnail.persist``, the PNG rendering, which needs
matplotlib and ``image.zscale_limits`` (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import gzip

import numpy as np

from .constants import CUTOUT_SIZE
from .db.orm import Column, Model

__all__ = ['Thumbnail', 'make_stamp']


def make_stamp(name, ra, dec, vmin, vmax, data, wcs, save_fits=False,
               size=CUTOUT_SIZE):
    """Cut a size x size stamp centered on (ra, dec), zero past the frame's
    edges (thumbnails.py:18-33)."""
    x, y = wcs.sky2pix_0(ra, dec)
    x = int(round(float(x)))
    y = int(round(float(y)))
    half = size // 2
    H, W = data.shape
    stamp = np.zeros((size, size), dtype=data.dtype)
    y0, y1 = max(0, y - half), min(H, y + half + 1)
    x0, x1 = max(0, x - half), min(W, x + half + 1)
    sy0 = y0 - (y - half)
    sx0 = x0 - (x - half)
    stamp[sy0:sy0 + (y1 - y0), sx0:sx0 + (x1 - x0)] = data[y0:y1, x0:x1]
    return stamp


class Thumbnail(Model):
    """One stamp image of one detection (new/ref/sub/sdss/dr8)."""

    __tablename__ = 'thumbnails'

    type = Column('TEXT')                # new | ref | sub | sdss | dr8
    detection_id = Column('INTEGER', index=True)
    source_id = Column('TEXT', index=True)
    bytes = Column('BLOB')
    public_url = Column('TEXT')
    file_uri = Column('TEXT')

    @classmethod
    def from_detection(cls, detection, image, stamp_type='sub'):
        """A gzip-FITS thumbnail of ``detection`` cut from ``image``'s
        pixels on its own WCS (thumbnails.py:54-94). ``image.data`` is read
        once: a deferred subtraction fetches its frames from the card on
        the first stamp and keeps them."""
        from .fits import Header, HDU, fits_bytes

        stamp = make_stamp(None, detection.ra, detection.dec, None, None,
                           np.asarray(image.data), image.wcs)
        h = Header()
        h.set('RA', float(detection.ra))
        h.set('DEC', float(detection.dec))
        h.set('STMPTYPE', stamp_type)
        raw = fits_bytes([HDU(h, stamp.astype('f4'))])
        obj = cls(type=stamp_type,
                  detection_id=getattr(detection, 'id', None),
                  bytes=gzip.compress(raw))
        obj.detection = detection
        obj.stamp = stamp
        return obj

    def persist(self, directory=None):
        """The PNG rendering of the reference (thumbnails.py:96-119)."""
        raise NotImplementedError(
            'Thumbnail.persist (the PNG rendering: matplotlib and '
            'image.zscale_limits) is not ported yet (ROADMAP queue 1: item '
            '10, the rest of the surface)')
