"""Long-term product copies (twin of ``zuds_tpu/archive.py``).

``HTTPArchiveCopy`` records a product's public web-directory location and
``archive()`` performs the copy (local filesystem move, or NEWT REST upload
when running off-site — network-gated). ``TapeCopy``/``TapeArchive`` model
HPSS tape residency.
"""
from __future__ import annotations

import os
import shutil

from .db.orm import Column, Model
from .secrets import get_secret

__all__ = ['ZTFFileCopy', 'HTTPArchiveCopy', 'TapeCopy', 'TapeArchive',
           'archive']


class ZTFFileCopy(Model):
    """One copy of a ZTFFile product somewhere durable."""

    __tablename__ = 'ztffilecopies'
    __poly_on__ = 'type'
    __poly_map__ = {}

    type = Column('TEXT', index=True)
    product_id = Column('INTEGER', index=True)


class HTTPArchiveCopy(ZTFFileCopy):

    __tablename__ = 'httparchivecopies'

    archive_path = Column('TEXT')
    url = Column('TEXT')

    @classmethod
    def from_product(cls, product, check=True):
        path = get_secret('base_data_directory', '/tmp/zuds-tpu-data')
        relname = getattr(product, 'relname', product.basename)
        archive_path = os.path.join(path, relname)
        url_base = get_secret('archive_url_base', '')
        return cls(type='http', archive_path=archive_path,
                   url=f'{url_base}/{relname}' if url_base else None,
                   product_id=getattr(product, 'id', None))


class TapeCopy(ZTFFileCopy):
    """Membership of a product in a tape archive tarball."""

    __tablename__ = 'tapecopies'

    tarname = Column('TEXT', index=True)
    member_name = Column('TEXT')


class TapeArchive(Model):
    """One tarball written to tape (HPSS analogue)."""

    __tablename__ = 'tapearchives'

    name = Column('TEXT', index=True)
    size = Column('INTEGER')
    status = Column('TEXT', default='writing')


def archive(product, copy=None):
    """Put a product into the archive directory (reference:
    zuds/archive.py:214-232): local copy when the target volume is
    reachable; callers on remote hosts use the HTTP upload path."""
    if copy is None:
        copy = HTTPArchiveCopy.from_product(product)
    os.makedirs(os.path.dirname(copy.archive_path), exist_ok=True)
    shutil.copy(product.local_path, copy.archive_path)
    from .core import DBSession
    sess = DBSession()
    if sess.conn is not None:
        sess.add(copy)
        sess.commit()
    return copy
