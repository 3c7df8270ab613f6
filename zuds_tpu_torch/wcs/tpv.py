"""TPV (TAN + PV polynomial distortion) world coordinate systems (the
port's own copy of ``zuds_tpu/wcs/tpv.py``, its float64 numpy arithmetic
kept verbatim so the mapping grids are bit-equal;
``tests/test_torch_wcs.py`` holds the two to each other).

Design: WCS transforms run on the host in numpy float64 — pixel positions on a
3072-px quadrant need ~1e-4 px precision, beyond float32 on sky coordinates.
They are cheap: the device warp ops consume only a coarse (per-32px) mapping
grid produced here; the dense per-pixel mapping is upsampled on device in
float32, where it is exact to ~2e-4 px (see ``ops/resample.py``). Catalog-level
transforms (thousands of points) are vectorized numpy.

Conventions
-----------
* Pixel coordinates are FITS 1-based in ``pix2sky``/``sky2pix`` (matching
  header CRPIX); 0-based variants carry the ``_0`` suffix.
* The TPV distortion polynomial follows the registered TPV convention: the
  PV1 polynomial acts on (xi, eta, r) and PV2 on (eta, xi, r), with the
  standard 40-term ordering up to 7th degree (radial terms at 3, 11, 23, 39).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ['TPVWCS', 'tpv_terms', 'MappingGrid', 'pixel_mapping']

RAD = np.pi / 180.0

# TPV term exponent table: index -> (i, j, k) meaning x^i y^j r^k,
# where x is the polynomial's leading axis (xi for PV1, eta for PV2).
_ORDERED = [
    (0, 0, 0),
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (2, 0, 0), (1, 1, 0), (0, 2, 0),
    (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (0, 0, 3),
    (4, 0, 0), (3, 1, 0), (2, 2, 0), (1, 3, 0), (0, 4, 0),
    (5, 0, 0), (4, 1, 0), (3, 2, 0), (2, 3, 0), (1, 4, 0), (0, 5, 0),
    (0, 0, 5),
    (6, 0, 0), (5, 1, 0), (4, 2, 0), (3, 3, 0), (2, 4, 0), (1, 5, 0),
    (0, 6, 0),
    (7, 0, 0), (6, 1, 0), (5, 2, 0), (4, 3, 0), (3, 4, 0), (2, 5, 0),
    (1, 6, 0), (0, 7, 0), (0, 0, 7),
]
NUM_PV = len(_ORDERED)  # 40

_XPOW = np.array([t[0] for t in _ORDERED], dtype=np.int64)
_YPOW = np.array([t[1] for t in _ORDERED], dtype=np.int64)
_RPOW = np.array([t[2] for t in _ORDERED], dtype=np.int64)


_MAXPOW = int(max(_XPOW.max(), _YPOW.max(), _RPOW.max()))


def _pow_table(v):
    """(..., _MAXPOW+1) cumulative powers v**0..v**max by repeated
    multiplication — numpy's generic float**int-array pow is much slower
    and dominated pixel_mapping's Newton solve in the night driver's host
    path."""
    out = np.empty(v.shape + (_MAXPOW + 1,), dtype=np.float64)
    out[..., 0] = 1.0
    for p in range(1, _MAXPOW + 1):
        out[..., p] = out[..., p - 1] * v
    return out


def tpv_terms(x, y):
    """All 40 TPV monomials at (x, y): shape x.shape + (40,)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    r = np.sqrt(x * x + y * y)
    return (_pow_table(x)[..., _XPOW] * _pow_table(y)[..., _YPOW]
            * _pow_table(r)[..., _RPOW])


def _tpv_deriv_terms(x, y):
    """d(terms)/dx and d(terms)/dy, each shape x.shape + (40,)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    r = np.sqrt(x * x + y * y)
    rs = np.where(r == 0, 1.0, r)
    xt = _pow_table(x)
    yt = _pow_table(y)
    rt = _pow_table(r)
    xp = xt[..., _XPOW]
    yp = yt[..., _YPOW]
    rp = rt[..., _RPOW]
    xp1 = np.where(_XPOW > 0, xt[..., np.maximum(_XPOW - 1, 0)], 0.0)
    yp1 = np.where(_YPOW > 0, yt[..., np.maximum(_YPOW - 1, 0)], 0.0)
    rp1 = np.where(_RPOW > 0, rt[..., np.maximum(_RPOW - 1, 0)], 0.0)
    drdx = (x / rs)[..., None]
    drdy = (y / rs)[..., None]
    ddx = _XPOW * xp1 * yp * rp + xp * yp * _RPOW * rp1 * drdx
    ddy = xp * _YPOW * yp1 * rp + xp * yp * _RPOW * rp1 * drdy
    return ddx, ddy


def _tan_project(ra, dec, ra0, dec0):
    """Sky (deg) -> gnomonic intermediate world coords (deg)."""
    ra = np.asarray(ra, dtype=np.float64) * RAD
    dec = np.asarray(dec, dtype=np.float64) * RAD
    dra = ra - ra0 * RAD
    sd, cd = np.sin(dec), np.cos(dec)
    sd0, cd0 = np.sin(dec0 * RAD), np.cos(dec0 * RAD)
    cosc = sd0 * sd + cd0 * cd * np.cos(dra)
    xi = cd * np.sin(dra) / cosc
    eta = (cd0 * sd - sd0 * cd * np.cos(dra)) / cosc
    return xi / RAD, eta / RAD


def _tan_deproject(xi, eta, ra0, dec0):
    """Gnomonic intermediate world coords (deg) -> sky (deg)."""
    xi = np.asarray(xi, dtype=np.float64) * RAD
    eta = np.asarray(eta, dtype=np.float64) * RAD
    sd0, cd0 = np.sin(dec0 * RAD), np.cos(dec0 * RAD)
    denom = cd0 - eta * sd0
    dra = np.arctan2(xi, denom)
    dec = np.arctan(np.cos(dra) * (eta * cd0 + sd0) / denom)
    ra = np.mod(dra / RAD + ra0, 360.0)
    return ra, dec / RAD


@dataclass
class TPVWCS:
    """TAN/TPV WCS: crpix (2,), crval (2,), cd (2,2), pv1/pv2 (40,)."""

    crpix: np.ndarray
    crval: np.ndarray
    cd: np.ndarray
    pv1: np.ndarray
    pv2: np.ndarray

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_header(cls, header):
        """Build from a FITS header (CD matrix or CDELT/PC, optional PVs)."""
        get = header.get
        crpix = np.array([get('CRPIX1', 0.0), get('CRPIX2', 0.0)], dtype='f8')
        crval = np.array([get('CRVAL1', 0.0), get('CRVAL2', 0.0)], dtype='f8')
        if 'CD1_1' in header:
            cd = np.array([[get('CD1_1', 0.0), get('CD1_2', 0.0)],
                           [get('CD2_1', 0.0), get('CD2_2', 0.0)]], dtype='f8')
        else:
            cdelt = np.array([get('CDELT1', 1.0), get('CDELT2', 1.0)])
            pc = np.array([[get('PC1_1', 1.0), get('PC1_2', 0.0)],
                           [get('PC2_1', 0.0), get('PC2_2', 1.0)]])
            cd = pc * cdelt[:, None]
        pv1 = np.zeros(NUM_PV)
        pv2 = np.zeros(NUM_PV)
        # the registered TPV convention defaults each axis independently:
        # an axis with no PVi_* cards gets the identity polynomial PVi_1=1
        # (a header with PV terms on only one axis must not collapse the
        # other intermediate coordinate to zero)
        have_pv1 = have_pv2 = False
        for i in range(NUM_PV):
            if f'PV1_{i}' in header:
                pv1[i] = header[f'PV1_{i}']
                have_pv1 = True
            if f'PV2_{i}' in header:
                pv2[i] = header[f'PV2_{i}']
                have_pv2 = True
        if not have_pv1:
            pv1[1] = 1.0
        if not have_pv2:
            pv2[1] = 1.0
        return cls(crpix, crval, cd, pv1, pv2)

    @classmethod
    def simple(cls, crval, crpix, scale_deg, rot_deg=0.0):
        """Undistorted TAN WCS with pixel scale in deg/px and rotation."""
        c, s = np.cos(rot_deg * RAD), np.sin(rot_deg * RAD)
        # astronomical convention: RA increases to the left (negative CD1_1)
        cd = scale_deg * np.array([[-c, s], [s, c]])
        pv1 = np.zeros(NUM_PV)
        pv2 = np.zeros(NUM_PV)
        pv1[1] = 1.0
        pv2[1] = 1.0
        return cls(np.asarray(crpix, dtype='f8'),
                   np.asarray(crval, dtype='f8'), cd, pv1, pv2)

    def to_header(self, header=None):
        from ..fits import Header
        h = header if header is not None else Header()
        h.set('CTYPE1', 'RA---TPV', 'TAN + TPV distortion')
        h.set('CTYPE2', 'DEC--TPV')
        h.set('CRPIX1', float(self.crpix[0]))
        h.set('CRPIX2', float(self.crpix[1]))
        h.set('CRVAL1', float(self.crval[0]))
        h.set('CRVAL2', float(self.crval[1]))
        for i in range(2):
            for j in range(2):
                h.set(f'CD{i + 1}_{j + 1}', float(self.cd[i, j]))
        trivial1 = self.pv1[1] == 1.0 and np.count_nonzero(self.pv1) == 1
        trivial2 = self.pv2[1] == 1.0 and np.count_nonzero(self.pv2) == 1
        if not (trivial1 and trivial2):
            for i in range(NUM_PV):
                if self.pv1[i] != 0:
                    h.set(f'PV1_{i}', float(self.pv1[i]))
                if self.pv2[i] != 0:
                    h.set(f'PV2_{i}', float(self.pv2[i]))
        return h

    # -- transforms -----------------------------------------------------------
    def _distort(self, xi, eta):
        return tpv_terms(xi, eta) @ self.pv1, tpv_terms(eta, xi) @ self.pv2

    def pix2sky(self, x, y):
        """FITS 1-based pixel coords -> (ra, dec) in degrees."""
        dx = np.asarray(x, dtype=np.float64) - self.crpix[0]
        dy = np.asarray(y, dtype=np.float64) - self.crpix[1]
        xi = self.cd[0, 0] * dx + self.cd[0, 1] * dy
        eta = self.cd[1, 0] * dx + self.cd[1, 1] * dy
        xit, etat = self._distort(xi, eta)
        return _tan_deproject(xit, etat, self.crval[0], self.crval[1])

    def sky2pix(self, ra, dec, iters=8):
        """(ra, dec) in degrees -> FITS 1-based pixel coords.

        The TPV polynomial is inverted with step-clamped Newton iterations
        (analytic jacobian); ZTF-scale distortions converge to <1e-10 px in
        <=5 steps, and the clamp (0.1 deg/step, ~field scale) keeps points
        where an unclamped Newton overshoots a cubic's turning point from
        diverging.
        """
        xi_t, eta_t = _tan_project(ra, dec, self.crval[0], self.crval[1])
        a1 = self.pv1[1] if self.pv1[1] != 0 else 1.0
        b1 = self.pv2[1] if self.pv2[1] != 0 else 1.0
        # LINEAR fast path: when only the constant + linear PV terms are
        # set (TPVWCS.simple, typical coadd product WCS), the inverse is
        # closed form — skip the Newton machinery entirely
        lin_mask = np.zeros(NUM_PV, bool)
        lin_mask[[0, 1, 2]] = True   # 1, x, y
        if (not self.pv1[~lin_mask].any() and not self.pv2[~lin_mask].any()):
            # xi_t = p0 + p1*xi + p2*eta ; eta_t = q0 + q1*eta + q2*xi
            p0, p1, p2 = self.pv1[0], a1, self.pv1[2]
            q0, q1, q2 = self.pv2[0], b1, self.pv2[2]
            det0 = p1 * q1 - p2 * q2
            det0 = det0 if abs(det0) > 1e-300 else 1.0
            rx = np.asarray(xi_t, np.float64) - p0
            ry = np.asarray(eta_t, np.float64) - q0
            xi = (q1 * rx - p2 * ry) / det0
            eta = (p1 * ry - q2 * rx) / det0
        else:
            xi = (xi_t - self.pv1[0]) / a1
            eta = (eta_t - self.pv2[0]) / b1
            clamp = 0.1
            for _ in range(iters):
                fx = tpv_terms(xi, eta) @ self.pv1
                fy = tpv_terms(eta, xi) @ self.pv2
                d1x, d1y = _tpv_deriv_terms(xi, eta)
                d2x, d2y = _tpv_deriv_terms(eta, xi)
                j11 = d1x @ self.pv1      # dfx/dxi
                j12 = d1y @ self.pv1      # dfx/deta
                j21 = d2y @ self.pv2      # dfy/dxi (pv2 leading axis: eta)
                j22 = d2x @ self.pv2      # dfy/deta
                det = j11 * j22 - j12 * j21
                det = np.where(np.abs(det) < 1e-300, 1.0, det)
                rx = fx - xi_t
                ry = fy - eta_t
                sx = np.clip((j22 * rx - j12 * ry) / det, -clamp, clamp)
                sy = np.clip((-j21 * rx + j11 * ry) / det, -clamp, clamp)
                xi = xi - sx
                eta = eta - sy
                # converged to float64 resolution (<1e-12 deg ~ 4e-9 px):
                # ZTF-scale solves exit after 3-4 of the 8 allowed steps
                if (np.abs(sx).max() if np.size(sx) else 0.0) < 1e-12 and \
                        (np.abs(sy).max() if np.size(sy) else 0.0) < 1e-12:
                    break
        cdinv = np.linalg.inv(self.cd)
        dx = cdinv[0, 0] * xi + cdinv[0, 1] * eta
        dy = cdinv[1, 0] * xi + cdinv[1, 1] * eta
        return dx + self.crpix[0], dy + self.crpix[1]

    def pix2sky_0(self, x, y):
        """0-based (array index) pixel coords -> sky degrees."""
        return self.pix2sky(np.asarray(x) + 1.0, np.asarray(y) + 1.0)

    def sky2pix_0(self, ra, dec):
        x, y = self.sky2pix(ra, dec)
        return x - 1.0, y - 1.0

    # -- geometry helpers -----------------------------------------------------
    def pixel_scale_arcsec(self):
        """Mean pixel scale in arcsec/px from the CD determinant."""
        return float(np.sqrt(np.abs(np.linalg.det(self.cd)))) * 3600.0

    def footprint(self, naxis1, naxis2):
        """Sky corners (4, 2) of an image with this WCS, rows = (ra, dec)."""
        xs = np.array([0.5, naxis1 + 0.5, naxis1 + 0.5, 0.5])
        ys = np.array([0.5, 0.5, naxis2 + 0.5, naxis2 + 0.5])
        ra, dec = self.pix2sky(xs, ys)
        return np.stack([ra, dec], axis=-1)

    def center(self, naxis1, naxis2):
        return self.pix2sky((naxis1 + 1) / 2.0, (naxis2 + 1) / 2.0)


@dataclass
class MappingGrid:
    """Coarse dst->src pixel mapping, the host-side input to device warps.

    ``u``/``v`` hold 0-based source x/y pixel coords at dst pixel positions
    ``(i*step, j*step)``; device code bilinearly upsamples. float32 is exact
    to ~2.4e-4 px at ZTF image sizes, far below Lanczos-3 sensitivity.
    """

    u: np.ndarray      # (GH, GW) float32 source x at grid points
    v: np.ndarray      # (GH, GW) float32 source y
    shape: tuple       # (H, W) of the destination image
    step: int

    @property
    def max_offset(self):
        """Upper bound on |src - dst| displacement in px (for warp windows)."""
        H, W = self.shape
        gy = np.arange(self.u.shape[0]) * self.step
        gx = np.arange(self.u.shape[1]) * self.step
        du = self.u - gx[None, :]
        dv = self.v - gy[:, None]
        return float(max(np.abs(du).max(), np.abs(dv).max()))


def pixel_mapping(src_wcs: TPVWCS, dst_wcs: TPVWCS, shape, step=32):
    """Build the coarse dst->src mapping grid between two TPV systems.

    For each ``step``-spaced destination pixel, computes the source pixel at
    the same sky position (both 0-based). The mapping between two TPV frames
    of the same sky region is smooth; bilinear interpolation at 32 px spacing
    contributes <1e-4 px error (the same astrometric-approximation strategy
    SWarp applies, cf. its PROJECTION_ERR parameter).
    """
    H, W = shape
    # uniform grid; last point extrapolates past the edge so every pixel is
    # inside a grid cell (uniform spacing keeps the device upsample trivial)
    ny = int(np.ceil((H - 1) / step)) + 1
    nx = int(np.ceil((W - 1) / step)) + 1
    gy = np.arange(ny, dtype=np.float64) * step
    gx = np.arange(nx, dtype=np.float64) * step
    gyy, gxx = np.meshgrid(gy, gx, indexing='ij')
    ra, dec = dst_wcs.pix2sky_0(gxx, gyy)
    su, sv = src_wcs.sky2pix_0(ra, dec)
    return MappingGrid(u=su.astype(np.float32), v=sv.astype(np.float32),
                       shape=(H, W), step=step)
