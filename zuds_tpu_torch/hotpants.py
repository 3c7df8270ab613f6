"""PSF-matching parameters (twin of ``zuds_tpu/hotpants.py``):
``prepare_hotpants`` returns, as a dict, the quantities the upstream
hotpants command line carried (kernel radius 2.5x seeing, stamp half-width
6x seeing, 3x3 regions, -ko 4 -bgo 0, the data limits). Host only."""
from __future__ import annotations

from .constants import (BIG_RMS, BKG_VAL, HOTPANTS_SATLEV,
                        KERNEL_RADIUS_SEEING, RSS_SEEING, NREG_SIDE,
                        KERNEL_SPATIAL_ORDER, BKG_SPATIAL_ORDER)
from .utils import quick_background_estimate

__all__ = ['prepare_hotpants']


def prepare_hotpants(sci, ref, outname=None, submask=None, directory=None,
                     tmpdir='/tmp', nreg_side=NREG_SIDE,
                     subtract_new_back=True, hotpants_kws=None):
    """Solver parameters for one subtraction (hotpants.py:18-49)."""
    from .seeing import estimate_seeing
    if 'SEEING' not in sci.header:
        estimate_seeing(sci)
    seeing = float(sci.header['SEEING'])
    scibkg, scibkgstd = quick_background_estimate(
        sci, mask_image=sci.mask_image)
    refbkg, refbkgstd = quick_background_estimate(ref)
    params = {
        'r': KERNEL_RADIUS_SEEING * seeing,
        'rss': RSS_SEEING * seeing,
        'nsx': sci.header.get('NAXIS1', 3072) / 100.0 / nreg_side,
        'nsy': sci.header.get('NAXIS2', 3080) / 100.0 / nreg_side,
        'nrx': nreg_side,
        'nry': nreg_side,
        'ko': KERNEL_SPATIAL_ORDER,
        'bgo': BKG_SPATIAL_ORDER,
        'il': scibkg - 10 * scibkgstd,
        'tl': refbkg - 10 * refbkgstd,
        'tu': HOTPANTS_SATLEV,
        'iu': HOTPANTS_SATLEV,
        'fin': BIG_RMS,
        'bkg_val': BKG_VAL,
        'subtract_new_back': subtract_new_back,
    }
    if hotpants_kws:
        params.update(hotpants_kws)
    return params
