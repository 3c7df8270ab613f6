"""Spatial indexing & cone searches, the q3c-equivalent layer (twin of
``zuds_tpu/spatial.py``).

The reference leans on the postgres q3c extension for all sky queries
(``zuds/spatial.py:34-65``, ``zuds/source.py:60-71``). Here the same
capability is provided backend-independently: great-circle distance SQL
functions are registered into sqlite (with the identical ``q3c_dist`` /
``q3c_radial_query`` names so raw-SQL call sites port over), and queries are
accelerated by a bounding-box prefilter on plain (ra, dec) indexes —
adequate for the catalog sizes one machine handles; the dialect seam allows
real q3c when running against postgres.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ['angular_distance', 'register_sqlite_functions', 'cone_where',
           'great_circle_deg', 'SpatiallyIndexed', 'HasPoly']

from .db.orm import Column


def great_circle_deg(ra1, dec1, ra2, dec2):
    """Great-circle distance in degrees (haversine, scalar math module)."""
    r1, d1, r2, d2 = (math.radians(v) for v in (ra1, dec1, ra2, dec2))
    sd = math.sin((d2 - d1) / 2)
    sr = math.sin((r2 - r1) / 2)
    a = sd * sd + math.cos(d1) * math.cos(d2) * sr * sr
    return math.degrees(2 * math.asin(min(1.0, math.sqrt(a))))


def angular_distance(ra1, dec1, ra2, dec2):
    """Vectorized great-circle distance in degrees."""
    r1, d1, r2, d2 = (np.radians(np.asarray(v, dtype=float))
                      for v in (ra1, dec1, ra2, dec2))
    sd = np.sin((d2 - d1) / 2)
    sr = np.sin((r2 - r1) / 2)
    a = sd ** 2 + np.cos(d1) * np.cos(d2) * sr ** 2
    return np.degrees(2 * np.arcsin(np.minimum(1.0, np.sqrt(a))))


def _q3c_join(ra1, dec1, ra2, dec2, radius):
    return great_circle_deg(ra1, dec1, ra2, dec2) <= radius


def register_sqlite_functions(conn):
    """Install q3c-named scalar functions into a sqlite connection."""
    conn.create_function('q3c_dist', 4, great_circle_deg, deterministic=True)
    conn.create_function('q3c_join', 5, _q3c_join, deterministic=True)


def cone_where(ra, dec, radius, ra_col='ra', dec_col='dec'):
    """(sql, params) WHERE fragment for a cone search.

    Bounding box on the indexed columns prunes the scan; the exact
    great-circle test runs on survivors only.
    """
    cosd = max(math.cos(math.radians(dec)), 1e-6)
    dra = min(radius / cosd, 180.0)
    lo_ra, hi_ra = ra - dra, ra + dra
    sql = (f'({dec_col} BETWEEN ? AND ?) AND '
           f'q3c_dist({ra_col}, {dec_col}, ?, ?) <= ?')
    params = [dec - radius, dec + radius]
    if lo_ra < 0 or hi_ra > 360:
        # wrap-around: skip the RA box, keep the exact test
        params += [ra, dec, radius]
        return sql, params
    sql = f'({ra_col} BETWEEN ? AND ?) AND ' + sql
    params = [lo_ra, hi_ra] + params + [ra, dec, radius]
    return sql, params


class SpatiallyIndexed:
    """Mixin declaring indexed ra/dec columns (reference:
    zuds/spatial.py:34-38)."""

    ra = Column('REAL', index=True)
    dec = Column('REAL', index=True)


class HasPoly:
    """Mixin declaring the 4-corner footprint columns (reference:
    zuds/spatial.py:41-65)."""

    ra1 = Column('REAL')
    dec1 = Column('REAL')
    ra2 = Column('REAL')
    dec2 = Column('REAL')
    ra3 = Column('REAL')
    dec3 = Column('REAL')
    ra4 = Column('REAL')
    dec4 = Column('REAL')

    @staticmethod
    def poly_contains(corners, ra, dec):
        """Point-in-spherical-quad via gnomonic projection winding test."""
        corners = np.asarray(corners, dtype=float)
        ra0 = corners[:, 0].mean()
        dec0 = corners[:, 1].mean()

        def proj(r, d):
            r = np.radians(np.asarray(r) - ra0)
            d = np.radians(np.asarray(d))
            d0 = math.radians(dec0)
            cosc = math.sin(d0) * np.sin(d) + math.cos(d0) * np.cos(d) \
                * np.cos(r)
            return (np.cos(d) * np.sin(r) / cosc,
                    (math.cos(d0) * np.sin(d)
                     - math.sin(d0) * np.cos(d) * np.cos(r)) / cosc)

        px, py = proj(corners[:, 0], corners[:, 1])
        qx, qy = proj(ra, dec)
        inside = np.ones(np.shape(qx), dtype=bool)
        sign = None
        for i in range(4):
            ex, ey = px[(i + 1) % 4] - px[i], py[(i + 1) % 4] - py[i]
            cx, cy = qx - px[i], qy - py[i]
            cross = ex * cy - ey * cx
            if sign is None:
                sign = np.sign(cross)
                continue
            inside &= (np.sign(cross) == sign) | (cross == 0)
        return inside
