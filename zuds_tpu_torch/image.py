"""Image hierarchy (twin of the parts of ``zuds_tpu/image.py:53-410`` that
the night run and the coadd path touch).

The classes, the header reflection of ``ScienceImage.from_file`` and the
product naming are the reference's. The background, rms and weight
products of an image (``image.py:112-198``) are computed by the port's
``background_mesh`` on the image's ``device`` (the card unless ``'cpu'``)
and cached beside it; a subtraction's products come from the pipeline
(``subtraction.py``).
"""
from __future__ import annotations

import os

import numpy as np

from .constants import (APER_KEY, BIG_RMS, BKG_BOX_SIZE, FID_MAP,
                        SATUR_FRAC)
from .fitsfile import HasWCS

__all__ = ['FITSImage', 'CalibratableImageBase', 'CalibratableImage',
           'CalibratedImage', 'ScienceImage']


class FITSImage(HasWCS):
    """FITS file with pixel data."""

    parent_image = None


class CalibratableImageBase(FITSImage):
    """Image whose calibration products are cached beside it."""

    _product_suffixes = {
        '_weightimg': '.weight.fits', '_rmsimg': '.rms.fits',
        '_bkgimg': '.bkg.fits', '_bkgsubimg': '.bkgsub.fits',
        '_segmimg': '.segm.fits',
    }

    mask_image = None
    # where the derived products are computed: the card unless 'cpu'
    device = None

    def _bad_pixel_array(self):
        if self.mask_image is not None:
            return np.asarray(self.mask_image.boolean.data).astype(bool)
        return np.zeros(self.shape, dtype=bool)

    def _run_background(self):
        """One background-mesh pass -> background, rms and the
        background-subtracted frame (image.py:117-127)."""
        import torch
        from .inputs import resolve_device
        from .ops.background import background_mesh
        device = resolve_device(self.device)
        data = np.ascontiguousarray(self.data).astype(np.float32)
        bad = self._bad_pixel_array()
        res = background_mesh(torch.from_numpy(data).to(device),
                              torch.from_numpy(~bad).to(device),
                              box=BKG_BOX_SIZE)
        back = res['back'].cpu().numpy()
        self._set_product('_bkgimg', back)
        self._set_product('_rmsimg', res['rms'].cpu().numpy())
        self._set_product('_bkgsubimg', data - back)

    def _set_product(self, attr, data, dtype='f4'):
        prod = FITSImage()
        prod.data = np.asarray(data).astype(dtype)
        prod.header = self.header.copy()
        prod.parent_image = self
        if self.basename:
            prod.basename = self.basename.replace(
                '.fits', self._product_suffixes.get(attr, f'{attr}.fits'))
        if self.ismapped and attr in self._product_suffixes:
            path = os.path.join(os.path.dirname(self.local_path),
                                prod.basename)
            prod.map_to_local_file(path)
            prod.save()
        setattr(self, attr, prod)
        return prod

    @property
    def background_image(self):
        try:
            return self._bkgimg
        except AttributeError:
            self._run_background()
        return self._bkgimg

    @property
    def background_subtracted_image(self):
        try:
            return self._bkgsubimg
        except AttributeError:
            self._run_background()
        return self._bkgsubimg

    @property
    def rms_image(self):
        try:
            return self._rmsimg
        except AttributeError:
            if hasattr(self, '_weightimg'):
                # derived from the weight map (image.py:166-176)
                ind = self._bad_pixel_array()
                w = np.asarray(self._weightimg.data)
                rms = np.full_like(w, BIG_RMS, dtype=np.float32)
                ok = (~ind) & (w > 0)
                rms[ok] = 1.0 / np.sqrt(w[ok])
                if 'SATURATE' in self.header:
                    rms[np.asarray(self.data)
                        >= SATUR_FRAC * self.header['SATURATE']] = BIG_RMS
                self._set_product('_rmsimg', rms)
            else:
                self._run_background()
        return self._rmsimg

    @property
    def weight_image(self):
        """Inverse-variance map from rms + mask + saturation
        (image.py:181-198)."""
        try:
            return self._weightimg
        except AttributeError:
            ind = self._bad_pixel_array()
            rms = np.asarray(self.rms_image.data)
            wgt = np.zeros(self.shape, dtype=np.float32)
            ok = (~ind) & (rms > 0)
            wgt[ok] = 1.0 / rms[ok] ** 2
            if 'SATURATE' in self.header:
                sat = np.asarray(self.data) \
                    >= SATUR_FRAC * self.header['SATURATE']
                wgt[sat] = 0.0
            self._set_product('_weightimg', wgt)
        return self._weightimg

    @property
    def segm_image(self):
        try:
            return self._segmimg
        except AttributeError:
            from .catalog import PipelineFITSCatalog
            PipelineFITSCatalog.from_image(self)
        return self._segmimg

    @property
    def catalog(self):
        try:
            return self._catalog
        except AttributeError:
            from .catalog import PipelineFITSCatalog
            self._catalog = PipelineFITSCatalog.from_image(self)
        return self._catalog

    @catalog.setter
    def catalog(self, value):
        self._catalog = value

    @classmethod
    def from_file(cls, fname, load_others=True, **kwargs):
        obj = super().from_file(fname, **kwargs)
        if load_others:
            d = os.path.dirname(os.path.abspath(fname))
            for attr, suffix in cls._product_suffixes.items():
                path = os.path.join(d, obj.basename.replace('.fits', suffix))
                if os.path.exists(path):
                    prod = FITSImage.from_file(path)
                    prod.parent_image = obj
                    setattr(obj, attr, prod)
            catpath = os.path.join(d, obj.basename.replace('.fits', '.cat'))
            if os.path.exists(catpath):
                from .catalog import PipelineFITSCatalog
                obj._catalog = PipelineFITSCatalog.from_file(catpath)
            maskpath = os.path.join(
                d, obj.basename.replace('sciimg', 'mskimg'))
            if maskpath != os.path.join(d, obj.basename) \
                    and os.path.exists(maskpath):
                from .mask import MaskImage
                m = MaskImage.from_file(maskpath)
                m.parent_image = obj
                obj.mask_image = m
        return obj


class CalibratableImage(CalibratableImageBase):
    """Calibratable image (the reference's DB relations come with
    ``db=True``, ROADMAP queue 1)."""


class CalibratedImage(CalibratableImage):
    """Image with a photometric solution (MAGZP + aperture correction)."""

    @property
    def magzp(self):
        return self.header.get('MAGZP', self.header.get('BZP', 0.0))

    @property
    def apcor(self):
        return self.header.get(APER_KEY, 0.0)

    def force_photometry(self, sources, assume_background_subtracted=False,
                         use_cutout=False, direct_load=None, device=None):
        """Forced aperture photometry at the sources' sky positions
        (image.py:289-320): objects with ``.ra`` and ``.dec``, dicts, or
        (ra, dec) pairs, measured in one launch of H22 on ``device`` (the
        image's own when None; the card unless ``'cpu'``) with the
        aperture correction applied. Returns a list of
        :class:`~zuds_tpu_torch.photometry.ForcedPhotometry` records."""
        from .photometry import ForcedPhotometry, aperture_photometry
        ra = [_sky(s, 'ra', 0) for s in sources]
        dec = [_sky(s, 'dec', 1) for s in sources]
        result = aperture_photometry(
            self, np.asarray(ra, dtype=float), np.asarray(dec, dtype=float),
            apply_calibration=True,
            assume_background_subtracted=assume_background_subtracted,
            device=device)
        return [ForcedPhotometry(
            source=s, image=self, flux=float(result['flux'][i]),
            fluxerr=float(result['fluxerr'][i]),
            flags=int(result['flags'][i]), ra=float(ra[i]),
            dec=float(dec[i]), obsjd=self.header.get('OBSJD'),
            zp=float(result['zp']),
            filtercode=self.header.get('FILTER',
                                       self.header.get('FILTERCODE')))
            for i, s in enumerate(sources)]


def _sky(source, key, i):
    """``source[key]`` of a dict, else its attribute ``key``, else item
    ``i`` of a (ra, dec) pair. (The reference's ``getattr(s, 'ra', s[0])``
    indexes every source first, so an object with ``.ra`` that cannot be
    indexed raises there: ROADMAP section 3.)"""
    if isinstance(source, dict):
        return source[key]
    return getattr(source, key) if hasattr(source, key) else source[i]


class ScienceImage(CalibratedImage):
    """A single-epoch IPAC science quadrant frame; ``from_file`` reflects
    the IPAC header keywords into attributes as the reference does
    (image.py:328-377)."""

    _header_attr_map = [
        ('obsjd', 'OBSJD'), ('infobits', 'INFOBITS'), ('pid', 'DBPID'),
        ('nid', 'DBNID'), ('expid', 'DBEXPID'), ('seeing', 'SEEING'),
        ('airmass', 'AIRMASS'), ('moonillf', 'MOONILLF'),
        ('moonesb', 'MOONESB'), ('maglimit', 'MAGLIM'),
        ('crpix1', 'CRPIX1'), ('crpix2', 'CRPIX2'), ('crval1', 'CRVAL1'),
        ('crval2', 'CRVAL2'), ('cd11', 'CD1_1'), ('cd12', 'CD1_2'),
        ('cd21', 'CD2_1'), ('cd22', 'CD2_2'), ('ipac_gid', 'PROGRMID'),
        ('exptime', 'EXPTIME'),
    ]

    field = None
    ccdid = None
    qid = None
    fid = None
    filtercode = None
    imgtypecode = None
    filefracday = None

    @classmethod
    def from_file(cls, f, load_others=True, **kwargs):
        obj = super().from_file(f, load_others=load_others, **kwargs)
        h = obj.header
        obj.field = h.get('FIELDID', obj.field)
        obj.ccdid = h.get('CCDID', obj.ccdid)
        obj.qid = h.get('QID', obj.qid)
        obj.fid = h.get('FILTERID', obj.fid)
        if obj.filtercode is None and obj.fid is not None:
            obj.filtercode = FID_MAP.get(obj.fid)
        fname = h.get('FILENAME')
        if fname:
            if obj.imgtypecode is None:
                obj.imgtypecode = fname.split('.')[0][-1]
            if obj.filefracday is None:
                try:
                    obj.filefracday = int(fname.split('_')[1])
                except (IndexError, ValueError):
                    pass
        for attr, kw in cls._header_attr_map:
            if getattr(obj, attr, None) is None and kw in h:
                setattr(obj, attr, h[kw])
        return obj

    @property
    def mjd(self):
        """Observation MJD from the header (image.py:379-382)."""
        from .utils import mjd_from_header
        return mjd_from_header(self.header)
