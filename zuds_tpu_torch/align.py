"""Image alignment (twin of ``zuds_tpu/align.py``): the host shell around
the Lanczos-3 warps of ``ops/resample.py``.

A mapping that ``plan_warp`` can reduce to an integer offset plus a small
residual runs the windowed warp (hand kernel H1 on the card); any other
mapping runs the gather warp (hand kernel H10). One launch warps the
pixels or the mask and returns the coverage with them.
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import MASK_BIT_NODATA_ALIGN
from .ops.resample import (plan_warp, upsample_mapping, warp_gather,
                           warp_planned)
from .wcs import pixel_mapping

__all__ = ['align_image', 'CARRIED_KEYS']

# photometric / observational keywords an aligned frame carries over from
# its source (align.py:76-81)
CARRIED_KEYS = ('MAGZP', 'SEEING', 'OBSMJD', 'OBSJD', 'FILTER', 'FILTERID',
                'EXPTIME', 'SATURATE', 'APCOR4', 'APCOR4ERR', 'FIELDID',
                'CCDID', 'QID', 'MJD-OBS', 'BZP', 'LMT_MG')


def align_image(image, other, persist_aligned=False, device=None):
    """Resample ``image`` onto ``other``'s WCS grid (align.py:19-97).

    Science-like frames use Lanczos-3; mask frames use the conservative OR
    warp, are promoted to 32 bit and get MASK_BIT_NODATA_ALIGN outside the
    coverage. Returns a new in-memory object of matching kind with
    ``other``'s header and WCS, the carried keywords of ``image``, numpy
    ``data`` and ``coverage``, and ``parent_image``. ``device``: where the
    warp runs; ``image.device`` when None (the card unless ``'cpu'``)."""
    from .image import FITSImage
    from .inputs import resolve_device, upload
    from .mask import MaskImageBase

    device = resolve_device(device if device is not None
                            else getattr(image, 'device', None))
    h, w = other.shape
    grid = pixel_mapping(image.wcs, other.wcs, (h, w))
    u, v = upsample_mapping(upload(np.asarray(grid.u, 'f4'), device),
                            upload(np.asarray(grid.v, 'f4'), device),
                            grid.shape, grid.step)

    is_mask = isinstance(image, MaskImageBase)
    extension = f'_aligned_to_{other.basename[:-5]}.remap' \
        if other.basename else '_aligned.remap'

    src_shape = tuple(np.asarray(image.data).shape)
    plan = plan_warp(grid, (h, w), src_shape)

    if is_mask:
        # the no-data bit is bit 16: the mask is warped as int32
        data = upload(np.ascontiguousarray(image.data).astype(np.int32),
                      device)
        if plan is not None:
            _, warped_m, cov = warp_planned(
                torch.zeros(src_shape, dtype=torch.float32, device=device),
                data, u, v, plan, (h, w))
        else:
            # the gather warp returns the coverage with the mask
            _, _, warped_m, cov = warp_gather(None, data, u, v)
        warped = warped_m.cpu().numpy()
        cov_np = cov.cpu().numpy()
        out_data = np.where(cov_np > 0, warped,
                            warped | np.int32(1 << MASK_BIT_NODATA_ALIGN)
                            ).astype(np.int32)
        result = MaskImageBase()
    else:
        data = upload(np.ascontiguousarray(image.data).astype(np.float32),
                      device)
        if plan is not None:
            warped, _, cov = warp_planned(
                data, torch.zeros(src_shape, dtype=torch.int32,
                                  device=device), u, v, plan, (h, w))
        else:
            warped, _, _, cov = warp_gather(data, None, u, v)
        out_data = warped.cpu().numpy()
        cov_np = cov.cpu().numpy()
        result = FITSImage()

    header = other.header.copy()
    for key in CARRIED_KEYS:
        if key in image.header:
            header.set(key, image.header[key],
                       image.header.comments.get(key, ''))
    other.wcs.to_header(header)
    header.set('NAXIS1', w)
    header.set('NAXIS2', h)

    result.header = header
    result.data = out_data
    result.basename = (image.basename or 'image.fits').replace(
        '.fits', f'{extension}.fits')
    result.parent_image = image
    result.coverage = cov_np
    result._wcs = other.wcs

    if persist_aligned and image.ismapped:
        out = image.local_path.replace('.fits', f'{extension}.fits')
        result.save(out)
    return result
