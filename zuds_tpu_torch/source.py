"""Named transient sources and their forced photometry rows (twin of
``zuds_tpu/source.py``)."""
from __future__ import annotations

import numpy as np

from .db.orm import Column, Model

__all__ = ['Source']


class Source(Model):
    """A named astrophysical transient (reference: zuds/source.py)."""

    __tablename__ = 'sources'
    __extra_ddl__ = (
        'CREATE INDEX IF NOT EXISTS sources_radec ON sources (ra, dec)',
    )

    id = Column('TEXT', primary=True)      # ZUDS names, e.g. ZUDS20abcdef
    ra = Column('REAL', index=True)
    dec = Column('REAL', index=True)
    origin = Column('TEXT')
    altdata = Column('TEXT')
    score = Column('REAL')
    redshift = Column('REAL')
    neighbor_info = Column('TEXT')

    def images(self, radius_arcsec=None):
        """Images whose footprint contains this source (q3c-poly analogue,
        reference zuds/source.py:60-71)."""
        from .core import DBSession, ZTFFile
        from .spatial import cone_where
        sess = DBSession()
        if sess.conn is None:
            return []
        # prefilter by center distance (< 0.7 deg = quadrant diagonal),
        # exact footprint test in python
        where, params = cone_where(self.ra, self.dec, 0.7)
        rows = sess.query(ZTFFile).filter(where, *params).all()
        from .spatial import HasPoly
        out = []
        for r in rows:
            corners = [[getattr(r, f'ra{i}'), getattr(r, f'dec{i}')]
                       for i in range(1, 5)]
            if None in [c[0] for c in corners]:
                continue
            if HasPoly.poly_contains(np.asarray(corners, dtype=float),
                                     self.ra, self.dec):
                out.append(r)
        return out

    @property
    def detections(self):
        from .core import DBSession
        from .detections import Detection
        sess = DBSession()
        if sess.conn is None:
            return []
        return sess.query(Detection).filter_by(source_id=self.id).all()

    @property
    def best_detection(self):
        """Highest-S/N detection (reference: zuds/source.py:73-81)."""
        dets = self.detections
        if not dets:
            return None
        return max(dets, key=lambda d: (d.flux_aper or 0)
                   / max(d.fluxerr_aper or np.inf, 1e-9))

    def light_curve(self):
        """Forced-photometry light curve as a structured array
        (reference: zuds/source.py:83-112)."""
        from .core import DBSession
        sess = DBSession()
        if sess.conn is None:
            return np.empty(0, dtype=[('obsjd', 'f8'), ('filtercode', 'U2'),
                                      ('zp', 'f8'), ('flux', 'f8'),
                                      ('fluxerr', 'f8'), ('flags', 'i4')])
        rows = sess.execute(
            'SELECT obsjd, filtercode, zp, flux, fluxerr, flags FROM '
            'forcedphotometry WHERE source_id = ? ORDER BY obsjd',
            (self.id,)).fetchall()
        out = np.empty(len(rows), dtype=[('obsjd', 'f8'),
                                         ('filtercode', 'U2'), ('zp', 'f8'),
                                         ('flux', 'f8'), ('fluxerr', 'f8'),
                                         ('flags', 'i4')])
        for i, r in enumerate(rows):
            out[i] = (r[0] or np.nan, r[1] or '', r[2] or 0.0,
                      r[3] or np.nan, r[4] or np.nan, r[5] or 0)
        return out

    def unphotometered_images(self):
        """Images of this source lacking forced photometry (anti-join,
        reference zuds/source.py:114-134)."""
        from .core import DBSession
        sess = DBSession()
        if sess.conn is None:
            return []
        rows = sess.execute(
            'SELECT z.id FROM ztffiles z WHERE z.type IN ("sesub", "mesub") '
            'AND NOT EXISTS (SELECT 1 FROM forcedphotometry fp WHERE '
            'fp.image_id = z.id AND fp.source_id = ?)', (self.id,)).fetchall()
        from .core import ZTFFile
        return [sess.get(ZTFFile, r[0]) for r in rows]

    def force_photometry(self, images):
        """Measure forced photometry on ``images`` at this source."""
        out = []
        for image in images:
            out.extend(image.force_photometry([self]))
        return out


class ForcedPhotometryRecord(Model):
    """DB table for forced photometry measurements."""

    __tablename__ = 'forcedphotometry'
    __extra_ddl__ = (
        'CREATE UNIQUE INDEX IF NOT EXISTS uq_fp_image_source ON '
        'forcedphotometry (image_id, source_id)',
    )

    source_id = Column('TEXT', index=True)
    image_id = Column('INTEGER', index=True)
    flux = Column('REAL')
    fluxerr = Column('REAL')
    zp = Column('REAL')
    filtercode = Column('TEXT')
    obsjd = Column('REAL')
    flags = Column('INTEGER')
    uniform = Column('INTEGER', default=0)
