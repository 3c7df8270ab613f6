"""Resampling entry points (twin of ``zuds_tpu/swarp.py``): the callables
that built swarp command lines upstream drive the port's Lanczos warp, and
the ``prepare_*`` functions return the parameters their device equivalents
consume. Host only."""
from __future__ import annotations

from .align import align_image
from .constants import BKG_BOX_SIZE, COADD_ZP

__all__ = ['run_align', 'prepare_swarp_sci', 'prepare_swarp_mask',
           'prepare_swarp_align']


def run_align(image, other, tmpdir='/tmp', nthreads=1,
              persist_aligned=False, device=None):
    """Align ``image`` onto ``other``'s WCS grid (swarp.py:18-22).
    ``device``: the card unless ``'cpu'``."""
    return align_image(image, other, persist_aligned=persist_aligned,
                       device=device)


def prepare_swarp_sci(images, outname, directory=None, swarp_kws=None,
                      swarp_zp_key='MAGZP'):
    """Coadd parameters (swarp.py:25-39): the FLXSCALE normalization of
    each image to the common zeropoint, written into its header."""
    from .ops.coadd import fluxscale
    scales = []
    for im in images:
        zp = im.header.get(swarp_zp_key)
        s = float(fluxscale(zp)) if zp is not None else 1.0
        im.header.set('FLXSCALE', s, 'Flux scale factor for coadd')
        im.header.set('FLXSCLZP', COADD_ZP, 'FLXSCALE equivalent ZP')
        scales.append(s)
    return {'outname': outname, 'scales': scales,
            'back_size': BKG_BOX_SIZE, 'combine': 'CLIPPED',
            'resampling': 'LANCZOS3'}


def prepare_swarp_mask(masks, outname, mskoutweightname=None, directory=None,
                       swarp_kws=None):
    return {'outname': outname, 'combine': 'AND', 'subtract_back': False}


def prepare_swarp_align(image, other, directory=None, nthreads=1,
                        persist_aligned=False):
    from .mask import MaskImageBase
    combtype = 'OR' if isinstance(image, MaskImageBase) else 'CLIPPED'
    extension = f'_aligned_to_{other.basename[:-5]}.remap' \
        if other.basename else '_aligned.remap'
    outname = (image.basename or 'image.fits').replace(
        '.fits', f'{extension}.fits')
    return {'target_wcs': other.wcs, 'combine': combtype,
            'outname': outname}
