"""Coaddition (twin of ``zuds_tpu/coadd.py``): ``Coadd.from_images`` builds
a reference or science stack from FITS epochs.

The transaction keeps the reference's shape (validate -> output grid ->
prepare epochs -> combine -> masks and headers -> seeing -> save); the
middle is :class:`~zuds_tpu_torch.parallel.pipeline.CoaddPipeline` on the
card: per epoch the background mesh (H2), the inverse-variance weight and
one two-plane Lanczos-3 warp (H1), then the CLIPPED combine with the mask
AND (H9).

``fused=False``, ``addbkg=False`` (a stack of subtractions) or an epoch
whose mapping residual exceeds the ``max_shift`` bucket take the per-epoch
loop ``_coadd_loop``: each epoch's own products, one planned (H1) or gather
(H10) warp of pixels, weight and mask, then the same combine (H9).

``solve_astrometry=True`` refits each epoch's WCS first
(``scamp.calibrate_astrometry``): each epoch's catalog is detected on the
stack's device, matched to a Gaia cache or the first epoch's stars, and
the refit WCS saved into the epoch's file.

With a database bound (``model_util.init_db()``) the stack is recorded as
in the reference: its ``ZTFFile`` record and one ``CoaddImage`` join for
each input image that has an id.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .constants import (BKG_VAL, COADD_ZP, GROUP_PROPERTIES,
                        MASK_BIT_NODATA_ALIGN, REFERENCE_VERSION)
from .image import CalibratedImage
from .mask import MaskImage
from .utils import ensure_images_have_the_same_properties, mjd_from_header
from .wcs import TPVWCS

__all__ = ['Coadd', 'ReferenceImage', 'ScienceCoadd', 'coadd_grid',
           'fused_inputs', 'PHASES']

# the stack's phases as torch.profiler ranges (python -m
# zuds_tpu_torch.profile --coadd); they record only while a profiler runs
PHASES = ('prepare', 'pipeline', 'fetch', 'write')
_phase = torch.profiler.record_function


def coadd_grid(images):
    """Output WCS + shape covering the union of the input footprints: an
    undistorted TAN grid at the median centre and the first image's pixel
    scale (coadd.py:26-52)."""
    centers = np.array([[im.ra, im.dec] for im in images])
    ra0 = np.median(centers[:, 0])
    dec0 = np.median(centers[:, 1])
    scale = images[0].pixel_scale / 3600.0
    # probe WCS to measure required extent
    probe = TPVWCS.simple(crval=(ra0, dec0), crpix=(0.0, 0.0),
                          scale_deg=scale)
    xs, ys = [], []
    for im in images:
        fp = im.footprint()
        x, y = probe.sky2pix(fp[:, 0], fp[:, 1])
        xs.extend(x)
        ys.extend(y)
    xmin, xmax = np.floor(min(xs)), np.ceil(max(xs))
    ymin, ymax = np.floor(min(ys)), np.ceil(max(ys))
    w = int(xmax - xmin + 1)
    h = int(ymax - ymin + 1)
    wcs = TPVWCS.simple(crval=(ra0, dec0), crpix=(1 - xmin, 1 - ymin),
                        scale_deg=scale)
    return wcs, (h, w)


def fused_inputs(images, wcs, H, W, device=None, stats=None):
    """The configuration and the eight :class:`CoaddPipeline` inputs of a
    stack on the (H, W) grid ``wcs`` (coadd.py:71-100). The output canvas
    is rounded up to 128 on both axes, as the reference rounds it; the
    epoch count is not padded (the reference pads it to a power of two to
    share compiles). Raises ``ValueError`` when an epoch's mapping residual
    exceeds the warp bucket."""
    from .inputs import resolve_device, to_torch
    from .parallel.pipeline import PipelineConfig, prepare_epoch_inputs

    device = resolve_device(device)
    cfg = PipelineConfig(height=-(-H // 128) * 128, width=-(-W // 128) * 128)
    eps = [prepare_epoch_inputs(im, wcs, cfg, device=device, stats=stats)
           for im in images]
    return cfg, to_torch(
        [torch.stack([e['img'] for e in eps]),
         np.stack([e['sat'] for e in eps]),
         torch.stack([e['mask'] for e in eps])]
        + [np.stack([e[k] for e in eps])
           for k in ('grid_u', 'grid_v', 'cov_bounds', 'scale')]
        + [np.ones(len(eps), 'f4')], device)


def _coadd_fused(images, wcs, H, W, subtract_back=True, device=None,
                 stats=None):
    """Run the whole stack through one :class:`CoaddPipeline`
    (coadd.py:58-103). Returns (coadd, weight, mask) numpy arrays cropped
    to (H, W). ``stats`` gains the host seconds of ``prepare_s`` (with
    ``upload_s`` and ``upload_bytes`` inside it), ``pipeline_s`` and
    ``fetch_s``."""
    from .parallel.pipeline import CoaddPipeline

    st = stats if stats is not None else {}
    t0 = time.perf_counter()
    with _phase('prepare'):
        cfg, args = fused_inputs(images, wcs, H, W, device, st)
    t1 = time.perf_counter()
    with _phase('pipeline'):
        out = CoaddPipeline(cfg, subtract_back=subtract_back)(*args)
        if args[0].is_cuda:
            # the fetch below would wait for the card anyway: wait here, so
            # that pipeline_s is the pipeline's time and fetch_s the copy's
            torch.cuda.synchronize()
    t2 = time.perf_counter()
    with _phase('fetch'):
        res = (out['coadd'][:H, :W].cpu().numpy(),
               out['weight'][:H, :W].cpu().numpy(),
               out['mask'][:H, :W].cpu().numpy().astype(np.int64))
    for k, dt in (('prepare_s', t1 - t0), ('pipeline_s', t2 - t1),
                  ('fetch_s', time.perf_counter() - t2)):
        st[k] = st.get(k, 0.0) + dt
    return res


def _coadd_loop(images, wcs, H, W, addbkg, device=None):
    """Per-epoch warp and combine (coadd.py:219-273), for mappings past the
    fused route's bucket and for ``addbkg=False`` stacks of subtractions.
    Per epoch: the background-subtracted pixels (the pixels as they are
    without ``addbkg``), the weight map and the mask go through one planned
    or gather warp; the weight is ``max(w, 0) * coverage``; the mask keeps
    its low 16 bits. Then the CLIPPED combine with the mask AND. Returns
    (coadd, weight, mask) numpy arrays of shape (H, W)."""
    from .inputs import resolve_device, upload, upload_mask
    from .ops.coadd import clipped_combine, fluxscale
    from .ops.resample import (plan_warp, upsample_mapping, warp_gather,
                               warp_planned)
    from .wcs import pixel_mapping

    device = resolve_device(device)
    N = len(images)
    iw = torch.empty((N, H, W), dtype=torch.float32, device=device)
    ww = torch.empty_like(iw)
    mw = torch.empty((N, H, W), dtype=torch.int32, device=device)
    cov = torch.empty((N, H, W), dtype=torch.bool, device=device)
    scales = []
    for n, im in enumerate(images):
        if getattr(im, 'device', None) is None:
            im.device = device
        grid = pixel_mapping(im.wcs, wcs, (H, W))
        u, v = upsample_mapping(upload(np.asarray(grid.u, 'f4'), device),
                                upload(np.asarray(grid.v, 'f4'), device),
                                grid.shape, grid.step)
        src = im.background_subtracted_image if addbkg else im
        data = upload(np.ascontiguousarray(src.data).astype(np.float32),
                      device)
        wdat = upload(np.ascontiguousarray(im.weight_image.data)
                      .astype(np.float32), device)
        m = upload_mask(im.mask_image.data if im.mask_image is not None
                        else None, tuple(data.shape), device)
        plan = plan_warp(grid, (H, W), tuple(data.shape))
        if plan is not None:
            img_w, wgt_w, m_w, c = warp_planned(data, m, u, v, plan, (H, W),
                                                img2=wdat)
        else:
            img_w, wgt_w, m_w, c = warp_gather(data, m, u, v, img2=wdat)
        iw[n] = img_w
        ww[n] = torch.clamp(wgt_w, min=0.0) * c
        mw[n] = m_w & 0xFFFF
        cov[n] = c > 0
        zp = im.header.get('MAGZP')
        scales.append(float(fluxscale(zp)) if zp is not None else 1.0)
    out = clipped_combine(iw, ww, mw, cov,
                          torch.tensor(scales, dtype=torch.float32,
                                       device=device))
    return (out['coadd'].cpu().numpy(), out['weight'].cpu().numpy(),
            out['mask'].cpu().numpy().astype(np.int64))


def _coadd_from_images(cls, images, outfile_name, nthreads=1, addbkg=True,
                       calculate_seeing=True, tmpdir='/tmp',
                       copy_inputs=False, swarp_kws=None, scamp_kws=None,
                       sci_swarp_kws=None, mask_swarp_kws=None,
                       solve_astrometry=False, fused=True, device=None,
                       stats=None):
    """Build a coadd of ``images`` (coadd.py:106-216) and save it, its
    ``.mask.fits`` sibling and its ``.weight.fits`` product.

    ``device``: where the stack is built, the card unless ``'cpu'``.
    ``solve_astrometry``: refit the epochs' WCS first, in place
    (``scamp.calibrate_astrometry``; an epoch without a device of its own
    has its catalog detected on ``device``).
    ``stats`` (dict, optional) gains the host seconds of each phase
    (``catalog_s`` and ``scamp_s`` when the astrometry is solved: the
    epochs' catalogs and the fit with the epochs' saves; ``prepare_s``,
    ``upload_s`` within it, ``pipeline_s``, ``fetch_s``, ``write_s``,
    ``seeing_s``; ``loop_s`` when the per-epoch loop ran) and
    ``upload_bytes``. With a database bound, the coadd's record and its
    ``CoaddImage`` joins are committed (coadd.py:200-214) and ``coadd.id``
    set; a ``ReferenceImage``'s record carries ``REFERENCE_VERSION``. The
    swarp and thread arguments of the reference are accepted and unused,
    as there."""
    from .seeing import estimate_seeing

    images = list(images)
    properties = GROUP_PROPERTIES
    ensure_images_have_the_same_properties(images, properties)

    st = stats if stats is not None else {}
    if solve_astrometry:
        from .inputs import resolve_device
        from .scamp import calibrate_astrometry
        t0 = time.perf_counter()
        for im in images:
            if getattr(im, 'device', None) is None:
                im.device = resolve_device(device)
            im.catalog          # detected here where the epoch has none
        t1 = time.perf_counter()
        calibrate_astrometry(images, scamp_kws=scamp_kws, tmpdir=tmpdir,
                             inplace=True)
        st['catalog_s'] = st.get('catalog_s', 0.0) + t1 - t0
        st['scamp_s'] = st.get('scamp_s', 0.0) + time.perf_counter() - t1

    wcs, (H, W) = coadd_grid(images)

    mjds = []
    for im in images:
        try:
            mjds.append(mjd_from_header(im.header))
        except KeyError:
            pass

    coadd_data = None
    if fused and addbkg:
        try:
            coadd_data, coadd_weight, mask_data = _coadd_fused(
                images, wcs, H, W, subtract_back=True, device=device,
                stats=st)
        except ValueError as e:
            print(f'coadd: fused path unavailable ({e}); '
                  f'per-epoch fallback', flush=True)

    if coadd_data is None:
        t0 = time.perf_counter()
        coadd_data, coadd_weight, mask_data = _coadd_loop(
            images, wcs, H, W, addbkg, device=device)
        st['loop_s'] = st.get('loop_s', 0.0) + time.perf_counter() - t0

    t0 = time.perf_counter()
    with _phase('write'):
        # no-data bit where no epoch contributed
        mask_data[coadd_weight == 0] |= (1 << MASK_BIT_NODATA_ALIGN)
        if addbkg:
            coadd_data = coadd_data + BKG_VAL

        coadd = cls()
        coadd.device = device
        header = images[0].header.copy()
        # the first epoch's distortion cards would outlive the grid's
        # undistorted WCS, which writes none (the JAX package keeps them:
        # ROADMAP section 3)
        for key in [k for k in header.keys() if k.startswith(('PV1_',
                                                               'PV2_'))]:
            del header[key]
        wcs.to_header(header)
        header.set('NAXIS1', W)
        header.set('NAXIS2', H)
        header.set('MAGZP', COADD_ZP,
                   'coadd zeropoint (FLXSCALE-normalized)')
        header.set('NCOADD', len(images), 'number of input epochs')
        if mjds:
            header.set('MJD-OBS', float(np.median(mjds)),
                       'median MJD of inputs')
            header.set('OBSMJD', float(np.median(mjds)))
        for prop in properties:
            val = getattr(images[0], prop, None)
            if val is not None:
                setattr(coadd, prop, val)
        coadd.header = header
        coadd.data = coadd_data.astype('f4')
        coadd.basename = os.path.basename(outfile_name)
        coadd.input_images = images

        coadd.map_to_local_file(outfile_name)

        mask = MaskImage.from_parent(coadd, data=mask_data.astype(np.int32))
        mask.basename = coadd.basename.replace('.fits', '.mask.fits')
        mask.refresh_bit_mask_entries_in_header()
        mask.map_to_local_file(os.path.join(os.path.dirname(outfile_name),
                                            mask.basename))
        coadd.mask_image = mask

        coadd._set_product('_weightimg', coadd_weight)

        coadd.save()
        mask.save()
    t1 = time.perf_counter()
    st['write_s'] = st.get('write_s', 0.0) + t1 - t0

    if calculate_seeing:
        estimate_seeing(coadd)
        coadd.save()
        st['seeing_s'] = st.get('seeing_s', 0.0) + time.perf_counter() - t1

    # DB association when a database is bound
    from .core import DBSession
    sess = DBSession()
    if sess.conn is not None:
        from .core import record_from_image
        from .joins import CoaddImage
        rec = record_from_image(coadd, getattr(cls, '__ztf_type__', 'coadd'))
        # a reference's record carries its version, which queryref reads
        # (the JAX package leaves it NULL: ROADMAP section 3)
        rec.version = getattr(cls, 'version', None)
        sess.add(rec)
        sess.commit()
        coadd.id = rec.id
        for im in images:
            if getattr(im, 'id', None) is not None:
                sess.add(CoaddImage(coadd_id=rec.id,
                                    calibratableimage_id=im.id))
        sess.commit()
    return coadd


class Coadd(CalibratedImage):
    """Combination of multiple epochs of one quadrant."""

    __ztf_type__ = 'coadd'

    input_images = None

    from_images = classmethod(_coadd_from_images)

    @property
    def mjd(self):
        return mjd_from_header(self.header)

    @property
    def min_mjd(self):
        return min(mjd_from_header(i.header) for i in self.input_images)

    @property
    def max_mjd(self):
        return max(mjd_from_header(i.header) for i in self.input_images)


class ReferenceImage(Coadd):
    """Template coadd used as the subtraction reference."""

    __ztf_type__ = 'ref'

    version = REFERENCE_VERSION


class ScienceCoadd(Coadd):
    """Time-binned science stack."""

    __ztf_type__ = 'scicoadd'

    binleft = None
    binright = None
