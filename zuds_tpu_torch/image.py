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
           'CalibratedImage', 'ScienceImage', 'zscale_limits']


def zscale_limits(data, contrast=0.25, nsamples=1000):
    """Approximate IRAF/ds9 zscale display limits (image.py:24-50): a
    robust line through the sorted samples of the finite pixels."""
    flat = np.asarray(data, dtype=np.float64).ravel()
    flat = flat[np.isfinite(flat)]
    if flat.size == 0:
        return 0.0, 1.0
    stride = max(1, flat.size // nsamples)
    samples = np.sort(flat[::stride])
    n = samples.size
    if n < 10:
        return float(samples.min()), float(samples.max())
    x = np.arange(n) - n / 2
    keep = np.ones(n, dtype=bool)
    slope, mid = 0.0, np.median(samples)
    for _ in range(5):
        xs, ys = x[keep], samples[keep]
        if xs.size < 5:
            break
        slope, mid = np.polyfit(xs, ys, 1)
        resid = samples - (slope * x + mid)
        sig = np.std(resid[keep])
        keep = np.abs(resid) < 2.5 * sig
    if contrast > 0:
        slope = slope / contrast
    zmed = np.median(samples)
    return float(zmed + slope * (0 - n / 2)), float(zmed + slope * (n / 2))


class FITSImage(HasWCS):
    """FITS file with pixel data and display helpers (image.py:53-89); the
    display imports matplotlib when it is called."""

    parent_image = None

    @property
    def datatype(self):
        return 'float' if 'float' in self.data.dtype.name else 'int'

    def cmap_limits(self):
        if self.datatype == 'float':
            return zscale_limits(self.data)
        return (None, None)

    def cmap(self):
        if self.datatype == 'float':
            return 'gray'
        from .plotting import discrete_cmap
        return discrete_cmap(len(np.unique(self.data)))

    def cmap_norm(self):
        if self.datatype == 'float':
            return None
        from matplotlib import colors
        boundaries = np.unique(self.data)
        return colors.BoundaryNorm(boundaries, len(boundaries))

    def show(self, axis=None, align_to=None, figsize=(5, 5), limits=None):
        """Draw the image on ``axis`` (a new figure's without one), aligned
        to ``align_to`` first when given; returns the figure."""
        import matplotlib.pyplot as plt
        if axis is None:
            _, axis = plt.subplots(figsize=figsize)
        image = self.aligned_to(align_to) if align_to is not None else self
        vmin, vmax = limits if limits is not None else image.cmap_limits()
        axis.imshow(image.data, vmin=vmin, vmax=vmax,
                    norm=image.cmap_norm(), cmap=image.cmap(),
                    interpolation='none')
        return axis.figure


class CalibratableImageBase(FITSImage):
    """Image whose calibration products are cached beside it."""

    __diskmapped_cached_properties__ = [
        '_path', '_data', '_weightimg', '_bkgimg', '_rmsimg', '_bkgsubimg',
        '_segmimg', '_catalog', '_detect_raw',
    ]

    _product_suffixes = {
        '_weightimg': '.weight.fits', '_rmsimg': '.rms.fits',
        '_bkgimg': '.bkg.fits', '_bkgsubimg': '.bkgsub.fits',
        '_segmimg': '.segm.fits',
    }

    mask_image = None
    # where the derived products are computed: the card unless 'cpu'
    device = None

    def cmap_limits(self):
        return zscale_limits(self.data)

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
    """DB-aware calibratable image (detections, thumbnails relations)."""

    detections = None
    thumbnails = None

    @classmethod
    def from_file(cls, f, use_existing_record=True, load_others=True):
        """The image of file ``f`` (image.py:254-266); with
        ``use_existing_record``, every column of the newest ``ZTFFile``
        record with its basename (``id`` among them) fills an attribute
        the file left unset. No database bound: no record, as there."""
        obj = super().from_file(f, load_others=load_others)
        if use_existing_record:
            from .core import ZTFFile
            existing = ZTFFile.get_by_basename(obj.basename)
            if existing is not None:
                for k, v in existing.items():
                    if getattr(obj, k, None) is None:
                        try:
                            setattr(obj, k, v)
                        except AttributeError:
                            pass
        return obj


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
    def from_file(cls, f, use_existing_record=True, load_others=True):
        obj = super().from_file(f, use_existing_record=use_existing_record,
                                load_others=load_others)
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

    @property
    def obsdate(self):
        """The observation's UTC date, ISO format (image.py:384-391)."""
        if self.obsjd:
            import datetime as dt
            mjd = self.obsjd - 2400000.5
            base = dt.datetime(1858, 11, 17) + dt.timedelta(days=mjd)
            return base.date().isoformat()
        return None

    def ipac_path(self, suffix):
        """IRSA archive URL of this quadrant's ``suffix`` product
        (image.py:393-401)."""
        sffd = str(self.filefracday)
        return (
            f'https://irsa.ipac.caltech.edu/ibe/data/ztf/products/sci/'
            f'{sffd[:4]}/{sffd[4:8]}/{sffd[8:]}/'
            f'ztf_{sffd}_{self.field:06d}_{self.filtercode}_c'
            f'{self.ccdid:02d}_{self.imgtypecode}_q{self.qid}_{suffix}')

    def download(self, suffix='sciimg.fits', destination=None, cookie=None):
        """Fetch the product from IRSA and map to it (image.py:403-410)."""
        from .download import ipac_authenticate, safe_download
        if destination is None:
            destination = self.basename
        if cookie is None:
            cookie = ipac_authenticate()
        safe_download(self.ipac_path(suffix), destination, cookie)
        self.map_to_local_file(str(destination))
