"""Association tables (twin of ``zuds_tpu/joins.py``)."""
from __future__ import annotations

from .db.orm import Column, Model

__all__ = ['JobImage', 'CoaddImage', 'StackedSubtractionFrame']


class JobImage(Model):

    __tablename__ = 'job_images'

    calibratableimage_id = Column('INTEGER', index=True)
    job_id = Column('INTEGER', index=True)


class CoaddImage(Model):
    """coadd <-> input image association."""

    __tablename__ = 'coadd_images'
    __extra_ddl__ = (
        'CREATE UNIQUE INDEX IF NOT EXISTS uq_coadd_images ON coadd_images '
        '(coadd_id, calibratableimage_id)',
    )

    coadd_id = Column('INTEGER', index=True)
    calibratableimage_id = Column('INTEGER', index=True)


class StackedSubtractionFrame(Model):
    """multi-epoch subtraction <-> single-epoch subtraction association."""

    __tablename__ = 'stackedsubtraction_frames'

    stackedsubtraction_id = Column('INTEGER', index=True)
    singleepochsubtraction_id = Column('INTEGER', index=True)
