"""External catalog records (twin of ``zuds_tpu/external.py``): the
models, their table names and columns.

The reference maps the full LegacySurvey DR8 north/south (~150 cols) and CLU
galaxy catalogs in postgres, and enriches alerts with PS1+sgscore through
Kowalski (``zuds/crossmatch.py:85-186``). Here the tables carry every
column the alert enrichment reads (the full ls*/ps* candidate blocks); bulk
DR8 columns live in the JSON ``extra`` blob. ``PS1`` is the local offline
equivalent of the Kowalski PS1-DR1 + sgscore path.
"""
from __future__ import annotations

from .db.orm import Column, Model

__all__ = ['DR8North', 'DR8South', 'CLU', 'PS1', 'Milliquas', 'TNSSource',
           'ZTFName']


class _DR8Base(Model):
    __abstract__ = True

    ra = Column('REAL', index=True)
    dec = Column('REAL', index=True)
    objid = Column('INTEGER')
    brickid = Column('INTEGER')
    type = Column('TEXT')
    ebv = Column('REAL')
    flux_g = Column('REAL')
    flux_r = Column('REAL')
    flux_z = Column('REAL')
    flux_w1 = Column('REAL')
    flux_w2 = Column('REAL')
    flux_w3 = Column('REAL')
    flux_w4 = Column('REAL')
    gaia_phot_g_mean_mag = Column('REAL')
    parallax = Column('REAL')
    z_phot_mean = Column('REAL')
    z_phot_median = Column('REAL')
    z_phot_std = Column('REAL')
    z_phot_l68 = Column('REAL')
    z_phot_u68 = Column('REAL')
    z_phot_l95 = Column('REAL')
    z_phot_u95 = Column('REAL')
    z_spec = Column('REAL')
    extra = Column('TEXT')     # JSON of remaining DR8 columns


class DR8North(_DR8Base):
    __tablename__ = 'dr8_north'


class DR8South(_DR8Base):
    __tablename__ = 'dr8_south'


class CLU(Model):
    """Census of the Local Universe galaxy catalog."""

    __tablename__ = 'clu'

    cluid = Column('INTEGER')
    name = Column('TEXT')
    ra = Column('REAL', index=True)
    dec = Column('REAL', index=True)
    z = Column('REAL')
    zerr = Column('REAL')
    distmpc = Column('REAL')
    sfr_fuv = Column('REAL')
    mstar = Column('REAL')
    a = Column('REAL')
    b2a = Column('REAL')
    pa = Column('REAL')
    btc = Column('REAL')
    extra = Column('TEXT')


class PS1(Model):
    """PS1 DR1 sources + star/galaxy score — local offline equivalent of
    the reference's Kowalski PS1_DR1 cone search + sgscore FITS table
    lookup (zuds/crossmatch.py:85-186)."""

    __tablename__ = 'ps1'

    objid = Column('INTEGER', index=True)
    ra = Column('REAL', index=True)
    dec = Column('REAL', index=True)
    sgscore = Column('REAL')
    gmag = Column('REAL')
    rmag = Column('REAL')
    imag = Column('REAL')
    zmag = Column('REAL')


class Milliquas(Model):
    """Million Quasars (milliquas_v6) — local offline equivalent of the
    reference's Kowalski cone search that fills the alert ``mqid`` field
    (zuds/crossmatch.py:291-336; 1.5 arcsec cone, unique names)."""

    __tablename__ = 'milliquas'

    name = Column('TEXT')
    ra = Column('REAL', index=True)
    dec = Column('REAL', index=True)
    rmag = Column('REAL')
    qso_class = Column('TEXT')
    z = Column('REAL')
    extra = Column('TEXT')


class TNSSource(Model):
    """Transient Name Server catalog — local offline equivalent of the
    reference's TNS cone search that fills the alert ``tnsid`` field
    (zuds/crossmatch.py:338-383)."""

    __tablename__ = 'tns'

    name = Column('TEXT')
    ra = Column('REAL', index=True)
    dec = Column('REAL', index=True)
    objtype = Column('TEXT')
    redshift = Column('REAL')
    internal_names = Column('TEXT')
    extra = Column('TEXT')


class ZTFName(Model):
    """Known ZTF alert object names — local offline equivalent of the
    reference's ZTF_alerts cone search that fills the alert ``ztfname``
    field (zuds/crossmatch.py:244-288)."""

    __tablename__ = 'ztf_names'

    objectid = Column('TEXT', index=True)
    ra = Column('REAL', index=True)
    dec = Column('REAL', index=True)
