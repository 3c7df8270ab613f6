"""ORM core: sessions, base model, ZTFFile records (twin of
``zuds_tpu/core.py``; the reference is zuds/core.py). The port's
``DBSession`` and ``RefDBSession`` are its own objects: binding them leaves
the JAX package's unbound, and the reverse.

``DBSession``/``RefDBSession`` are scoped session factories exactly like the
reference's (``zuds/core.py:23-24``); the whole library works with no
database bound and upgrades to persistent mode via ``init_db()``
(``zuds/model_util.py:132-160`` -> here ``model_util.init_db``).

``ZTFFile`` is the polymorphic root record for every pipeline file product,
keyed by the ZTF quadrant tuple (field, ccdid, qid, fid) + basename
(``zuds/core.py:146-179``).
"""
from __future__ import annotations

import os

from .db.orm import Column, Model, ScopedSession, MODELS

__all__ = ['DBSession', 'RefDBSession', 'Base', 'ZTFFile', 'join_model',
           'models_registry']

DBSession = ScopedSession()
RefDBSession = ScopedSession()

Base = Model
models_registry = MODELS


class ZTFFile(Model):
    """Polymorphic record of one pipeline file product."""

    __tablename__ = 'ztffiles'
    __poly_on__ = 'type'
    __poly_map__ = {}
    __extra_ddl__ = (
        'CREATE INDEX IF NOT EXISTS ztffiles_field_ccdid_qid_fid ON '
        'ztffiles (field, ccdid, qid, fid)',
        'CREATE INDEX IF NOT EXISTS ztffiles_basename ON ztffiles (basename)',
    )

    type = Column('TEXT', index=True)
    basename = Column('TEXT')
    field = Column('INTEGER')
    ccdid = Column('INTEGER')
    qid = Column('INTEGER')
    fid = Column('INTEGER')
    ra = Column('REAL', index=True)
    dec = Column('REAL', index=True)
    ra1 = Column('REAL')
    dec1 = Column('REAL')
    ra2 = Column('REAL')
    dec2 = Column('REAL')
    ra3 = Column('REAL')
    dec3 = Column('REAL')
    ra4 = Column('REAL')
    dec4 = Column('REAL')
    header = Column('TEXT')          # JSON of the full FITS header
    seeing = Column('REAL')
    magzp = Column('REAL')
    maglimit = Column('REAL')
    obsjd = Column('REAL')
    infobits = Column('INTEGER')
    version = Column('TEXT')
    parent_id = Column('INTEGER', index=True)
    reference_id = Column('INTEGER', index=True)
    target_id = Column('INTEGER', index=True)

    @classmethod
    def get_by_basename(cls, basename):
        """Look up the newest record with this basename; None when no DB is
        bound (preserves database-free operation,
        reference zuds/core.py:195-213)."""
        sess = DBSession()
        if sess.conn is None:
            return None
        return sess.query(cls).filter_by(basename=basename) \
            .order_by('id DESC').first()

    @property
    def relname(self):
        """Canonical archive-relative path
        (reference path scheme, zuds/core.py:215-236)."""
        return os.path.join(f'{self.field:06d}', f'c{self.ccdid:02d}',
                            f'q{self.qid}', f'{self.fid}', self.basename)


def register_file_type(type_name):
    """Class decorator binding an image class to a ZTFFile polymorphic type."""
    def wrap(cls):
        ZTFFile.__poly_map__[type_name] = ZTFFile
        cls.__ztf_type__ = type_name
        return cls
    return wrap


def join_model(name, left, right, left_col=None, right_col=None):
    """Many-to-many association model factory (reference:
    zuds/core.py:73-136)."""
    left_col = left_col or f'{left.__tablename__[:-1]}_id'
    right_col = right_col or f'{right.__tablename__[:-1]}_id'
    attrs = {
        '__tablename__': name.lower() + 's',
        left_col: Column('INTEGER', index=True),
        right_col: Column('INTEGER', index=True),
        '__extra_ddl__': (
            f'CREATE UNIQUE INDEX IF NOT EXISTS uq_{name.lower()} ON '
            f'{name.lower()}s ({left_col}, {right_col})',
        ),
    }
    from .db.orm import ModelMeta
    return ModelMeta(name, (Model,), attrs)


def record_from_image(image, type_name):
    """Snapshot a pipeline image object into a ZTFFile record."""
    from .json_util import to_json
    rec = ZTFFile(
        type=type_name,
        basename=image.basename,
        field=getattr(image, 'field', None),
        ccdid=getattr(image, 'ccdid', None),
        qid=getattr(image, 'qid', None),
        fid=getattr(image, 'fid', None),
        ra=getattr(image, 'ra', None),
        dec=getattr(image, 'dec', None),
        seeing=image.header.get('SEEING') if image.header else None,
        magzp=image.header.get('MAGZP') if image.header else None,
        maglimit=image.header.get('MAGLIM') if image.header else None,
        obsjd=image.header.get('OBSJD') if image.header else None,
        infobits=image.header.get('INFOBITS') if image.header else None,
        header=to_json(image.header.to_dict()) if image.header else None,
    )
    for i in range(1, 5):
        for axis in ('ra', 'dec'):
            key = f'{axis}{i}'
            if hasattr(image, key):
                setattr(rec, key, getattr(image, key))
    existing_id = getattr(image, 'id', None)
    if existing_id is not None:
        rec.id = existing_id
        rec._persisted = True
    return rec
