"""Job-tracking tables (twin of ``zuds_tpu/bookkeeping.py``)."""
from __future__ import annotations

from .db.orm import Column, Model

__all__ = ['Job', 'ForcePhotJob', 'AlertJob', 'FailedSubtraction']


class Job(Model):
    """One slurm (or local batch) submission of subtraction work."""

    __tablename__ = 'jobs'

    slurm_id = Column('TEXT', index=True)
    status = Column('TEXT', index=True, default='unsubmitted')


class ForcePhotJob(Model):

    __tablename__ = 'forcephotjobs'

    slurm_id = Column('TEXT', index=True)
    status = Column('TEXT', index=True, default='unsubmitted')
    detection_file = Column('TEXT')
    output_file = Column('TEXT')


class AlertJob(Model):

    __tablename__ = 'alertjobs'

    slurm_id = Column('TEXT', index=True)
    status = Column('TEXT', index=True, default='unsubmitted')


class FailedSubtraction(Model):
    """Known-bad science/reference pairs, excluded from re-queuing
    (reference: zuds/bookkeeping.py:32-46)."""

    __tablename__ = 'failedsubtractions'

    target_image_id = Column('INTEGER', index=True)
    reference_image_id = Column('INTEGER', index=True)
    reason = Column('TEXT')
