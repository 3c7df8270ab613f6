"""Detection stamp thumbnails (twin of ``zuds_tpu/thumbnails.py``).

63x63 cutouts around detections in new/ref/sub frames, gzip-FITS bytes
stored in the DB (BYTEA analogue: sqlite BLOB), rendered to PNG by
``Thumbnail.persist``. The FITS bytes come from the port's own writer
(``fits.fits_bytes``), the same bytes the reference writes to a temporary
file; ``gzip.compress`` stamps the time into its header, so two runs'
blobs differ there and decompress to equal files.
"""
from __future__ import annotations

import gzip
import io
import struct
import zlib

import numpy as np

from .constants import CUTOUT_SIZE
from .db.orm import Column, Model

__all__ = ['Thumbnail', 'make_stamp', 'gray_levels', 'write_png_gray',
           'read_png_gray']


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
        """Render the stamp to ``thumb_<type>_<detection id>.png`` in
        ``directory`` (the configured ``base_data_directory`` by default),
        set ``file_uri`` and return the path (thumbnails.py:96-119). The
        stamp is ``self.stamp``, or the one in ``self.bytes``.

        Where matplotlib imports, the figure is the reference's, drawn with
        its calls (a 2x2 inch figure at 100 dpi, ``imshow`` in gray between
        the stamp's ``zscale_limits``, origin lower, no axes, saved tight);
        ``self.png_kind`` is then ``'matplotlib'``. Without matplotlib (the
        card machine has none) the PNG is the stamp itself, one 8-bit gray
        pixel a stamp pixel (:func:`gray_levels`: clipped at the zscale
        limits, the gray colormap's 256 levels, origin lower), written
        through ``zlib`` (:func:`write_png_gray`); ``png_kind`` is then
        ``'zlib'``."""
        import os
        from .image import zscale_limits
        from .secrets import get_secret

        directory = directory or get_secret('base_data_directory',
                                            '/tmp/zuds-tpu-data')
        os.makedirs(directory, exist_ok=True)
        name = f'thumb_{self.type}_{self.detection_id or "x"}.png'
        path = os.path.join(directory, name)
        stamp = getattr(self, 'stamp', None)
        if stamp is None and self.bytes:
            from .fits import read_fits
            raw = gzip.decompress(self.bytes)
            stamp = read_fits(io.BytesIO(raw))[0].data
        vmin, vmax = zscale_limits(stamp)
        try:
            import matplotlib
        except ImportError:
            write_png_gray(path, gray_levels(stamp, vmin, vmax)[::-1])
            self.png_kind = 'zlib'
        else:
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(2, 2), dpi=100)
            ax.imshow(stamp, vmin=vmin, vmax=vmax, cmap='gray',
                      origin='lower')
            ax.axis('off')
            fig.savefig(path, bbox_inches='tight', pad_inches=0)
            plt.close(fig)
            self.png_kind = 'matplotlib'
        self.file_uri = path
        return path


def gray_levels(stamp, vmin, vmax):
    """uint8 levels of ``stamp`` between ``vmin`` and ``vmax`` as
    matplotlib's ``Normalize`` and 256-entry ``gray`` colormap index them:
    in the stamp's float type, ``(x - vmin) / (vmax - vmin)`` each step
    rounded to it, times 256, 256 itself the top level, truncated; under
    the range 0, over it 255; a NaN pixel 0."""
    x = np.asarray(stamp)
    ft = np.float32 if x.dtype.kind in 'iub' or x.dtype.itemsize <= 4 \
        else np.float64
    if vmin == vmax:
        t = np.zeros(x.shape, ft)
    else:
        t = (x.astype(np.float64) - vmin).astype(ft)
        t = (t.astype(np.float64) / (vmax - vmin)).astype(ft)
    t = t * ft(256)
    t[t == 256] = 255
    with np.errstate(invalid='ignore'):
        lev = np.where(t < 0, 0, np.where(t >= 256, 255, t))
        lev = np.where(np.isnan(t), 0, lev).astype(np.int64)
    return lev.astype(np.uint8)


def _chunk(tag, data):
    return (struct.pack('>I', len(data)) + tag + data
            + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))


def write_png_gray(path, pixels):
    """An 8-bit grayscale PNG of the uint8 (H, W) ``pixels``, first row at
    the top, every scanline unfiltered."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    H, W = pixels.shape
    raw = b''.join(b'\x00' + row.tobytes() for row in pixels)
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + _chunk(b'IHDR', struct.pack('>IIBBBBB', W, H, 8, 0, 0, 0, 0))
                + _chunk(b'IDAT', zlib.compress(raw, 9))
                + _chunk(b'IEND', b''))


def read_png_gray(path):
    """The uint8 (H, W) pixels of an 8-bit grayscale PNG with unfiltered
    scanlines, as :func:`write_png_gray` writes them; any other PNG
    raises ``ValueError``."""
    with open(path, 'rb') as f:
        buf = f.read()
    if buf[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError(f'{path}: not a PNG')
    pos, idat, head = 8, b'', None
    while pos < len(buf):
        n, = struct.unpack('>I', buf[pos:pos + 4])
        tag, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b'IHDR':
            head = struct.unpack('>IIBBBBB', data)
        elif tag == b'IDAT':
            idat += data
    if head is None or head[2:] != (8, 0, 0, 0, 0):
        raise ValueError(f'{path}: not an 8-bit gray PNG without interlace')
    W, H = head[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, W + 1)
    if rows[:, 0].any():
        raise ValueError(f'{path}: filtered scanlines')
    return rows[:, 1:].copy()
