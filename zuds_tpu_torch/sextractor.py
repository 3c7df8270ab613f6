"""Detection entry points (twin of ``zuds_tpu/sextractor.py``).

``run_sextractor`` keeps the reference's call signature and product list
(the catalog and the requested check images): the catalog is
``PipelineFITSCatalog.from_image`` (the port's detection on the image's
``device``), the check images the image's cached products.
"""
from __future__ import annotations

__all__ = ['run_sextractor', 'prepare_sextractor', 'CHECKIMAGE_TYPES']

CHECKIMAGE_TYPES = ('rms', 'segm', 'bkgsub', 'bkg')

_ATTRS = {'rms': 'rms_image', 'bkg': 'background_image',
          'bkgsub': 'background_subtracted_image', 'segm': 'segm_image'}


def run_sextractor(calibratable, checkimage_type=None, tmpdir='/tmp',
                   use_weightmap=True, sextractor_kws=None):
    """[catalog, <check images...>] of ``calibratable`` in the order asked
    (sextractor.py:15-38): ``checkimage_type`` a name or a list of
    ``rms``, ``segm``, ``bkgsub`` and ``bkg``; another name raises
    ``ValueError``."""
    from .catalog import PipelineFITSCatalog
    checkimage_type = checkimage_type or []
    if isinstance(checkimage_type, str):
        checkimage_type = [checkimage_type]
    for ct in checkimage_type:
        if ct not in _ATTRS:
            raise ValueError(f'unknown checkimage type {ct!r}')
    results = [PipelineFITSCatalog.from_image(calibratable)]
    for ct in checkimage_type:
        results.append(getattr(calibratable, _ATTRS[ct]))
    return results


def prepare_sextractor(image, checkimage_type=None, **kwargs):
    """The detection parameters (sextractor.py:41-46)."""
    from .constants import BKG_BOX_SIZE, DETECT_NPIX, DETECT_NSIGMA
    return {'detect_thresh': DETECT_NSIGMA, 'detect_minarea': DETECT_NPIX,
            'back_size': BKG_BOX_SIZE,
            'checkimages': checkimage_type or []}
