"""Detections and real/bogus scores (twin of
``zuds_tpu/detections.py``)."""
from __future__ import annotations

import numpy as np

from .db.orm import Column, Model

__all__ = ['Detection', 'RealBogus']


class RealBogus(Model):
    """braai CNN score for one detection (reference:
    zuds/detections.py:13-22)."""

    __tablename__ = 'realbogus'

    rb_score = Column('REAL')
    rb_version = Column('TEXT')
    detection_id = Column('INTEGER', index=True)


class Detection(Model):
    """One catalog detection on a subtraction (reference:
    zuds/detections.py:25-109)."""

    __tablename__ = 'detections'
    __extra_ddl__ = (
        'CREATE INDEX IF NOT EXISTS detections_radec ON detections (ra, dec)',
    )

    ra = Column('REAL', index=True)
    dec = Column('REAL', index=True)
    image_id = Column('INTEGER', index=True)
    source_id = Column('TEXT', index=True)
    x_image = Column('REAL')
    y_image = Column('REAL')
    elongation = Column('REAL')
    a_image = Column('REAL')
    b_image = Column('REAL')
    fwhm_image = Column('REAL')
    flags_weight = Column('INTEGER')
    imaflags_iso = Column('INTEGER')
    goodcut = Column('INTEGER')
    rb = Column('REAL')
    flux = Column('REAL')
    fluxerr = Column('REAL')
    flux_aper = Column('REAL')
    fluxerr_aper = Column('REAL')
    zp = Column('REAL')
    triggers_alert = Column('INTEGER')
    triggers_phot = Column('INTEGER')
    alert_ready = Column('INTEGER', index=True)

    @property
    def snr(self):
        if self.fluxerr_aper:
            return self.flux_aper / self.fluxerr_aper
        return np.nan

    @property
    def mag(self):
        if self.flux_aper and self.flux_aper > 0 and self.zp is not None:
            return self.zp - 2.5 * np.log10(self.flux_aper)
        return np.nan

    @classmethod
    def from_catalog(cls, cat, filter=True):
        """Build Detection objects from a subtraction catalog.

        With ``filter=True``, first runs the full quality-cut + ML chain
        (``filter_sexcat``) and keeps only GOODCUT rows — the reference's
        behavior (zuds/detections.py:71-109).
        """
        from .filterobjects import filter_sexcat

        if filter:
            filter_sexcat(cat)
        data = cat.data
        rows = data[data['GOODCUT'] == 1] if filter else data

        image = cat.image
        image_id = getattr(image, 'id', None)
        out = []
        for row in rows:
            det = cls(
                ra=float(row['X_WORLD']), dec=float(row['Y_WORLD']),
                image_id=image_id,
                x_image=float(row['X_IMAGE']), y_image=float(row['Y_IMAGE']),
                elongation=float(row['ELONGATION']),
                a_image=float(row['A_IMAGE']), b_image=float(row['B_IMAGE']),
                fwhm_image=float(row['FWHM_IMAGE']),
                flags_weight=int(row['FLAGS_WEIGHT']),
                imaflags_iso=int(row['IMAFLAGS_ISO']),
                goodcut=int(row['GOODCUT']),
                rb=float(row['RB']) if np.isfinite(row['RB']) else None,
                flux=float(row['FLUX_ISO']),
                flux_aper=float(row['FLUX_APER']),
                fluxerr_aper=float(row['FLUXERR_APER']),
                zp=float(image.header.get('MAGZP', 0.0) or 0.0)
                if image is not None else None,
            )
            det.image = image
            out.append(det)
        return out
