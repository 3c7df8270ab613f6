"""Image hierarchy (twin of the parts of ``zuds_tpu/image.py:53-410`` that
the night driver touches).

The classes, the header reflection of ``ScienceImage.from_file`` and the
product naming are the reference's. The background and rms products of
an image that was not produced by the fused pipeline (the per-image
background run, ``image.py:117-198``) come with the per-pair path and
raise until then; a subtraction's products come from the pipeline
(``subtraction.py``).
"""
from __future__ import annotations

import os

from .constants import APER_KEY, FID_MAP
from .fitsfile import HasWCS

__all__ = ['FITSImage', 'CalibratableImageBase', 'CalibratableImage',
           'CalibratedImage', 'ScienceImage']


class FITSImage(HasWCS):
    """FITS file with pixel data."""

    parent_image = None


def _not_ported(what):
    return NotImplementedError(
        f'{what} of an image the fused pipeline did not produce is not '
        'ported yet (ROADMAP queue 1: the per-pair path, K17)')


class CalibratableImageBase(FITSImage):
    """Image whose calibration products are cached beside it."""

    _product_suffixes = {
        '_weightimg': '.weight.fits', '_rmsimg': '.rms.fits',
        '_bkgimg': '.bkg.fits', '_bkgsubimg': '.bkgsub.fits',
        '_segmimg': '.segm.fits',
    }

    mask_image = None

    def _product(self, attr, what):
        try:
            return getattr(self, attr)
        except AttributeError:
            raise _not_ported(what) from None

    @property
    def background_image(self):
        return self._product('_bkgimg', 'the background map')

    @property
    def background_subtracted_image(self):
        return self._product('_bkgsubimg', 'the background-subtracted frame')

    @property
    def rms_image(self):
        return self._product('_rmsimg', 'the rms map')

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
