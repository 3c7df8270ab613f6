"""Batched subtract -> detect -> photometer pipeline (twin of
``zuds_tpu/parallel/pipeline.py:make_subtract_detect_pipeline``) and its
host feed (``prepare_frame_inputs``, pipeline.py:581-764).

:class:`SubtractDetectPipeline` runs ``one_frame`` of the reference
(:153-398) frame by frame over the batch, as ``jax.lax.map`` does. On a
CUDA device the warp (H1, or H28 at ``sep_warp=True``), the background
cells (H2), the model convolution (H3), the matched filter (H4), the
deblend tree's level labels (H5), the compactions (H6) and the
whole-frame medians (H8) run as
hand-written kernels, and so do the measure stage's apertures (H22), its
windowed and Kron refinement (H23) and its negative-pixel veto (H14);
everything between them is plain PyTorch. With
``ref_rms_mesh=True`` the noise stage is H3 at one term (the reference
variance through the squared centre kernels) and H11 (difference, noise
and no-data fills).

:class:`CoaddPipeline` is the twin of ``make_coadd_pipeline``
(pipeline.py:430-505) with its host feed ``prepare_epoch_inputs``
(:528-578): per epoch the background mesh (H2), the inverse-variance
weight and one two-plane warp (H1), then the CLIPPED combine of the stack
with the mask AND (H9).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..constants import (BAD_SUM, BIG_RMS, BKG_BOX_SIZE, BKG_VAL,
                         DETECT_NSIGMA, MASK_BIT_NODATA_ALIGN,
                         MASK_BIT_NODATA_SUB, SATUR_FRAC,
                         SUB_NODATA_SENTINEL)
from ..kernels.launch import REFINE_KEYS
from ..ops.background import background_mesh, frame_median
from ..ops.coadd import clipped_combine, fluxscale
from ..ops.cutouts import NEGPIX_BOX, clamped_corners, negpix_veto
from ..ops.detect import DETECTION_FIELDS, detect_sources
from ..ops.measure import refine_detections
from ..ops.photometry import aperture_photometry_batched, aperture_sums
from ..ops.ordered import sum_last2
from ..ops.resample import (SUPPORT, upsample_mapping, warp_epoch,
                            warp_reference, warp_reference_sep)
from ..ops.subtract import (apply_kernel_fast, center_kernels, fit_kernel,
                            propagate_ref_var, region_edges,
                            subtract_epilogue)
from .mesh import all_gather, axis_index, axis_size, local_batch

__all__ = ['PipelineConfig', 'SubtractDetectPipeline', 'prepare_frame_inputs',
           'REF_CACHE_SIZE', 'CoaddPipeline', 'embed_roll',
           'prepare_epoch_inputs']



@dataclass(frozen=True)
class PipelineConfig:
    """Static pipeline shape parameters: the fields and defaults of the
    reference's ``PipelineConfig`` (pipeline.py:38-99), whose module
    imports JAX. ``interleave`` is a TPU scheduling knob that does not
    change outputs and is ignored. ``dbg_stop_after`` ('warp', 'bkg',
    'fit', 'fitdiag', 'ksum', 'apply', 'noise', 'detect', 'phot',
    'refine' or 'aps') ends each frame after that stage with the
    reference's partial dict; ``det_dbg_stop_after`` ends it inside
    ``detect_sources`` (see :func:`~zuds_tpu_torch.ops.detect.
    detect_sources`). Any other stop value runs to the full outputs."""

    height: int = 3080
    width: int = 3072
    map_step: int = 32
    ksize: int = 15
    stamp: int = 41
    smax: int = 64
    order: int = 2
    nreg: int = 1
    max_det: int = 1024
    nsigma: float = DETECT_NSIGMA
    box: int = BKG_BOX_SIZE
    max_shift: int = 2
    ref_rms_mesh: bool = False
    sep_warp: bool = False
    deblend: object = True
    det_cap: int = 0
    deb_cap: int = 0
    interleave: int = 1
    dbg_stop_after: str = None
    det_dbg_stop_after: str = None


# named ranges for torch.profiler (python -m zuds_tpu_torch.profile); they
# record only while a profiler runs
_stage = torch.profiler.record_function


class SubtractDetectPipeline(nn.Module):
    """Subtract + detect + photometer a batch of quadrant pairs.

    ``forward`` takes the 14 batched inputs of the reference
    (pipeline.py:133-140; see :data:`zuds_tpu_torch.inputs.INPUT_NAMES`)
    with masks int32 and ``stamp_valid`` bool, and returns the reference's
    output dict (pipeline.py:367-397) with a leading batch dimension. The
    module holds no weights: its state is the configuration.

    With a ``mesh`` (:func:`zuds_tpu_torch.parallel.mesh.quadrant_mesh`)
    the batch is data parallel over its 'data' axis, as the reference's
    ``shard_map`` over ``batch_axis`` (pipeline.py:129-147, :420-424):
    each rank runs its contiguous block of frames (the split of
    ``P('data')``) one by one and returns that block;
    ``gather_batch(mesh, out)`` assembles the global dict. Give the inputs
    as ``place_batch(mesh, *host_arrays)`` does, ``DTensor`` s of which
    each rank holds only its block on its card, as ``P('data')`` places
    them; a plain tensor is taken to hold the whole batch, of which the
    rank slices its block (:func:`~zuds_tpu_torch.parallel.mesh.
    local_batch`). A batch that does not divide by the 'data' size raises
    ``ValueError``. Ranks that differ only over 'space' compute the same
    frames.

    With ``sep_warp`` the reference is warped by the separable form (H28
    on the card). A stop (``dbg_stop_after``, ``det_dbg_stop_after``)
    truncates each frame where the reference does and returns its partial
    dict, stacked over the batch; the stages before it run as in a full
    run.
    """

    def __init__(self, cfg: PipelineConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh

    def forward(self, *args):
        if len(args) != 14:
            raise ValueError(f'expected 14 batched inputs, got {len(args)}')
        if self.mesh is not None:
            args = local_batch(self.mesh, *args)
        outs = [self.one_frame(*(a[i] for a in args))
                for i in range(args[0].shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def one_frame(self, sci, sci_mask, ref, ref_mask, gu, gv, sx, sy, sv,
                  bgx, bgy, bsums, b0, covb):
        """One quadrant pair (pipeline.py:153-398), or its partial dict
        at the configured stop."""
        cfg = self.cfg
        H, W = cfg.height, cfg.width
        dev = sci.device
        stop = cfg.dbg_stop_after
        with _stage('warp'):
            u, v = upsample_mapping(gu, gv, (H, W), cfg.map_step)
            warp = warp_reference_sep if cfg.sep_warp else warp_reference
            refw, refm, cov = warp(ref, ref_mask, u, v, covb, cfg.max_shift)
            submask = (sci_mask | refm
                       | torch.where(cov == 0, 1 << MASK_BIT_NODATA_ALIGN, 0)
                       .to(torch.int32))
            bad = (submask & BAD_SUM) > 0
        if stop == 'warp':
            return {'diff': refw + cov}

        with _stage('background'):
            bres = background_mesh(sci, ~bad, box=cfg.box)
            scimbkg = (sci - bres['back']) + BKG_VAL
            rms = bres['rms']
            if cfg.ref_rms_mesh:
                # the warped reference's own mesh (pipeline.py:194-196)
                ref_rms = background_mesh(refw, cov > 0, box=cfg.box)['rms']
            else:
                # global robust sigma of the warped reference from a ::4
                # subsample (pipeline.py:198-209)
                sub = refw[::4, ::4]
                okf = cov[::4, ::4] > 0
                med = frame_median(sub, okf)
                ref_rms = 1.4826 * frame_median(sub, okf, center=med)
            ivar = 1.0 / torch.clamp(rms ** 2 + ref_rms ** 2, min=1e-6)
            ivar = torch.where(bad, 0.0, ivar)
        if stop == 'bkg':
            return {'diff': scimbkg + ivar}

        with _stage('fit'):
            fit = fit_kernel(refw, scimbkg, ivar, sx, sy, sv, bgx, bgy,
                             bsums, b0, stamp=cfg.stamp, order=cfg.order,
                             nreg=cfg.nreg)
        if stop == 'fit':
            return {'diff': scimbkg + fit['coeffs'].sum()}
        if stop == 'fitdiag':
            return {'diff': scimbkg, 'stamp_ok': fit['stamp_ok'],
                    'stamp_chi2': fit['stamp_chi2'], 'coeffs': fit['coeffs']}

        with _stage('apply'):
            if stop == 'ksum':
                # the fitted kernel applied to a constant frame
                # (pipeline.py:221-227)
                return {'diff': apply_kernel_fast(
                    torch.ones_like(refw), fit['coeffs'], bgx, bgy, bsums,
                    b0, order=cfg.order, nreg=cfg.nreg)}
            model = apply_kernel_fast(refw, fit['coeffs'], bgx, bgy, bsums,
                                      b0, order=cfg.order, nreg=cfg.nreg)
        if stop == 'apply':
            return {'diff': scimbkg - model}

        if cfg.ref_rms_mesh:
            with _stage('noise'):
                # the reference variance through the squared centre
                # kernels (H3 at one term), then the difference, the noise
                # and the no-data fills in one pass (H11); XLA contracts
                # rms^2 + var into one FMA here (pipeline.py:242-269)
                ref_var_m = propagate_ref_var(ref_rms, fit['coeffs'], bgx,
                                              bgy, bsums, b0,
                                              order=cfg.order, nreg=cfg.nreg)
                diff, rms_out, submask = subtract_epilogue(
                    scimbkg, model, rms, ref_var_m, bad, submask,
                    contract=True)
        else:
            with _stage('noise'):
                # constant reference sigma: conv(var, K^2) == var *
                # sum(K^2), per static region rectangle
                # (pipeline.py:247-263)
                diff = scimbkg - model
                kerns = center_kernels(fit['coeffs'], bgx, bgy, bsums, b0,
                                       order=cfg.order, nreg=cfg.nreg)
                k2sum = sum_last2(kerns * kerns)
                y_e = region_edges(H, cfg.nreg)
                x_e = region_edges(W, cfg.nreg)
                rid = torch.zeros((H, W), dtype=torch.int64, device=dev)
                for ri in range(cfg.nreg):
                    for rj in range(cfg.nreg):
                        rid[y_e[ri]:y_e[ri + 1], x_e[rj]:x_e[rj + 1]] = \
                            ri * cfg.nreg + rj
                ref_var_m = ref_rms ** 2 * k2sum[rid]
                rms_out = torch.sqrt(rms ** 2 + ref_var_m)
                rms_out = torch.where(bad, BIG_RMS, rms_out)
                diff = torch.where(bad, SUB_NODATA_SENTINEL, diff)
                submask = submask | torch.where(diff == SUB_NODATA_SENTINEL,
                                                1 << MASK_BIT_NODATA_SUB,
                                                0).to(torch.int32)
        if stop == 'noise':
            return {'diff': diff + rms_out}

        with _stage('detect'):
            det = detect_sources(diff, rms_out, submask, ~bad,
                                 nsigma=cfg.nsigma, max_det=cfg.max_det,
                                 return_labels=False, deblend=cfg.deblend,
                                 det_cap=(cfg.det_cap or None),
                                 deb_cap=(cfg.deb_cap or None),
                                 dbg_stop_after=cfg.det_dbg_stop_after)
        if cfg.det_dbg_stop_after is not None:
            # a probe that never fires leaves no 'dbg': KeyError, as the
            # reference (pipeline.py:279-282)
            dbg = det['dbg']
            if dbg.ndim > 0:
                return {'dbg': dbg}
            return {'diff': diff + dbg.to(torch.float32)}
        if stop == 'detect':
            return {'diff': diff + det['n'].to(torch.float32)}

        with _stage('measure'):
            phot = aperture_photometry_batched(diff, rms_out, submask,
                                               det['x'], det['y'])
            if stop == 'phot':
                return {'diff': diff + phot['flux'].sum()}
            ref_meas = refine_detections(diff, rms_out, det['x'], det['y'],
                                         det['a'], det['b'], det['theta'],
                                         det['fwhm'])
            if stop == 'refine':
                return {'diff': diff + ref_meas['flux_auto'].sum()}
            # the r=6 rms and bad-pixel sums in one two-plane pass
            # (pipeline.py:306-328)
            rms_ap6, bpm_ap6 = aperture_sums(
                (rms_out, bad.to(torch.float32)), det['x'], det['y'], r=6.0)
            rms_med = frame_median(rms_out[::4, ::4], ~bad[::4, ::4])
            if stop == 'aps':
                return {'diff': diff + rms_ap6.sum() + bpm_ap6.sum()
                        + rms_med}
            negpix = self._negpix(diff, det['x'], det['y'])

        out = {
            'diff': diff, 'rms': rms_out, 'submask': submask,
            'det_n': det['n'],
            'det_pix_overflow': det['pix_overflow'],
            'det_deblend_overflow': det['deblend_overflow'],
            'det_obj_overflow': det['obj_overflow'],
            'ap_flux': phot['flux'], 'ap_fluxerr': phot['fluxerr'],
            'ap_flags': phot['flags'],
            'kernel_coeffs': fit['coeffs'],
            'fit_stamps_ok': fit['stamp_ok'].sum().to(torch.int32),
        }
        for f in DETECTION_FIELDS:
            out[f'det_{f}'] = det[f]
        out['det_elong'] = det['elongation']
        out['det_valid'] = det['valid']
        for k in REFINE_KEYS:
            out[f'det_{k}'] = ref_meas[k]
        out['det_rms_ap'] = rms_ap6
        out['det_bpm_ap'] = bpm_ap6
        out['det_negpix'] = negpix
        out['rms_med'] = rms_med
        return out

    def _negpix(self, diff, xs, ys):
        """Negative-pixel veto: a < -5 sigma pixel next to a > +5 sigma one
        inside the 11x11 box around each candidate (pipeline.py:338-365),
        standardised by the frame's ::4 median and 1.48 MAD (H8). The
        reference takes it full-frame (a 3x3 and an 11x11 max dilation,
        then one gather); every inner pixel of the per-candidate 13x13
        window has its 3x3 neighbourhood inside the window and the frame,
        so the stencil H14 on the windows decides alike."""
        H, W = diff.shape
        dsub = diff[::4, ::4]
        dmed = frame_median(dsub)
        dmad = frame_median(dsub, center=dmed)
        dsig = torch.clamp(1.48 * dmad, min=1e-12)
        x0, y0 = clamped_corners(xs, ys, NEGPIX_BOX, H, W)
        return negpix_veto(diff, dmed, dsig, x0, y0)


# references kept on the card by prepare_frame_inputs' ref_cache
# (pipeline.py:692)
REF_CACHE_SIZE = 4


def _as_f4(a):
    a = np.ascontiguousarray(a)
    return a if a.dtype == np.float32 else a.astype('f4')


def prepare_frame_inputs(sci, ref, cfg: PipelineConfig, smax=None,
                         ref_cache=None, device=None, stats=None):
    """The batched pipeline's inputs for one pair (pipeline.py:581-764):
    the ref->sci mapping grid, star stamps and the seeing-scaled kernel
    basis. Returns a dict of INPUT_NAMES -> tensors on ``device`` (the
    card unless ``'cpu'``), so a batch is stacked on the device.

    - The reference is moved into the ``max_shift`` warp bucket by the
      integer pre-roll (median offset of the grid), and the grid and the
      coverage bounds follow; a residual past the bucket raises
      ``ValueError`` (the night driver's per-pair fallback). A reference
      of another shape is embedded into the canvas, zero-filled.
    - ``ref_cache`` (dict): the unrolled reference and its mask stay on
      the device, keyed by ``local_path`` only (at most REF_CACHE_SIZE,
      oldest evicted); each pair's roll runs there (``torch.roll``).
    - Stamps come from the science catalog when it has one, else from
      ``select_stamps_device`` on the uploaded frame (H8, H7, H6); SEEING
      from the stamp moments when the header lacks it.
    - A raw 16-bit mask is sent as is and widened on the device.

    ``stats`` (dict, optional) gains the uploads' host seconds and bytes.
    """
    from ..inputs import KernelBasis, resolve_device, upload, upload_mask
    from ..ops.measure import select_stamps_device, seeing_from_stamps
    from ..ops.resample import SUPPORT
    from ..subtraction import _select_stamps
    from ..wcs import pixel_mapping

    device = resolve_device(device)
    smax = smax or cfg.smax
    H, W = cfg.height, cfg.width
    grid = pixel_mapping(ref.wcs, sci.wcs, (H, W), step=cfg.map_step)
    Hs, Ws = ref.data.shape
    grid_u, grid_v = np.asarray(grid.u, 'f4'), np.asarray(grid.v, 'f4')
    cov_bounds = np.asarray([SUPPORT - 1, Ws - SUPPORT,
                             SUPPORT - 1, Hs - SUPPORT], 'f4')
    gx = np.arange(grid_u.shape[1], dtype='f4') * cfg.map_step
    gy = np.arange(grid_v.shape[0], dtype='f4') * cfg.map_step
    du = grid_u - gx[None, :]
    dv = grid_v - gy[:, None]
    resid = max(np.abs(du).max(), np.abs(dv).max())
    du0 = dv0 = 0
    need_embed = (Hs, Ws) != (H, W)
    need_roll = resid > cfg.max_shift or need_embed
    if need_roll:
        du0 = int(round(float(np.median(du))))
        dv0 = int(round(float(np.median(dv))))
        resid2 = max(np.abs(du - du0).max(), np.abs(dv - dv0).max())
        if resid2 > cfg.max_shift:
            raise ValueError(
                f'mapping residual {resid2:.2f} exceeds the '
                f'max_shift={cfg.max_shift} bucket; per-pair fallback')
        grid_u = grid_u - np.float32(du0)
        grid_v = grid_v - np.float32(dv0)
        cov_bounds = cov_bounds - np.asarray([du0, du0, dv0, dv0], 'f4')

    def upload_ref():
        rd = upload(_as_f4(ref.data), device, stats)
        rm = upload_mask(ref.mask_image.data if ref.mask_image is not None
                         else None, (Hs, Ws), device, stats)
        if need_embed:
            # zero-filled canvas, the mask too (pipeline.py:663-679); the
            # coverage bounds above gate the strips the roll wraps
            h, w = min(Hs, H), min(Ws, W)
            cd = torch.zeros((H, W), dtype=torch.float32, device=device)
            cm = torch.zeros((H, W), dtype=torch.int32, device=device)
            cd[:h, :w] = rd[:h, :w]
            cm[:h, :w] = rm[:h, :w]
            rd, rm = cd, cm
        return rd, rm

    # keyed by local_path only: a basename collides across directories
    # and id() is reused after garbage collection (pipeline.py:681-687)
    cache_key = (str(ref.local_path)
                 if getattr(ref, 'local_path', None) else None)
    if ref_cache is not None and cache_key is not None:
        if cache_key not in ref_cache:
            if len(ref_cache) >= REF_CACHE_SIZE:
                ref_cache.pop(next(iter(ref_cache)))
            ref_cache[cache_key] = upload_ref()
        refdata, refmask = ref_cache[cache_key]
    else:
        refdata, refmask = upload_ref()
    if need_roll:
        refdata = torch.roll(refdata, (-dv0, -du0), dims=(0, 1))
        refmask = torch.roll(refmask, (-dv0, -du0), dims=(0, 1))

    scidata = upload(_as_f4(sci.data), device, stats)
    if getattr(sci, '_catalog', None) is not None:
        xs, ys, valid = (upload(a, device, stats)
                         for a in _select_stamps(sci, smax=smax))
        if 'SEEING' not in sci.header:
            from ..seeing import estimate_seeing
            estimate_seeing(sci)
    else:
        sat = float(sci.header.get('SATURATE', 5e4) or 5e4)
        xs, ys, valid = select_stamps_device(
            scidata, smax=smax, nreg=cfg.nreg, sat_level=sat,
            margin=cfg.stamp // 2 + 1)
        if 'SEEING' not in sci.header:
            see = float(seeing_from_stamps(scidata, xs, ys, valid))
            sci.header.set('SEEING', see, 'FWHM from stamp moments')
    basis = KernelBasis(cfg.ksize,
                        seeing_sigma=float(sci.header['SEEING']) / 2.355)
    mraw = sci.mask_image.data if sci.mask_image is not None else None
    return {
        'sci': scidata,
        'sci_mask': upload_mask(mraw, (H, W), device, stats),
        'ref': refdata,
        'ref_mask': refmask,
        'grid_u': upload(grid_u, device, stats),
        'grid_v': upload(grid_v, device, stats),
        'stamp_x': xs, 'stamp_y': ys, 'stamp_valid': valid,
        'basis_gx': upload(basis.gx, device, stats),
        'basis_gy': upload(basis.gy, device, stats),
        'basis_sums': upload(basis.sums, device, stats),
        'b0': upload(basis.b0_2d, device, stats),
        'cov_bounds': upload(cov_bounds, device, stats),
    }


class CoaddPipeline(nn.Module):
    """Coadd one epoch stack (pipeline.py:430-505).

    ``forward`` takes the reference's eight inputs, each with a leading
    epoch dimension N (see :data:`zuds_tpu_torch.inputs.COADD_INPUT_NAMES`;
    the epochs already embedded and rolled into the (H, W) canvas by
    :func:`prepare_epoch_inputs`): imgs (N, H, W) f32, sats (N,) f32
    saturation levels, masks (N, H, W) int32, grid_u/grid_v (N, GH, GW) f32
    (canvas -> epoch mapping), cov_bounds (N, 4) f32, scales (N,) f32
    FLXSCALE, valid (N,) f32 (an epoch with 0 contributes nothing). It
    returns ``coadd`` and ``weight`` (H, W) f32, ``mask`` (H, W) int32 and
    ``nexp`` (H, W) int32.

    Epochs run one by one, as ``jax.lax.map`` runs them, each written into
    its slice of the warped stack; the stack is combined once. With
    ``subtract_back`` each epoch loses its background mesh, else the noise
    is 1.4826 MAD of a ``::4`` subsample; with ``compute_weight`` the
    weight is 1/rms^2 less bad and saturated pixels, else 1 off bad
    pixels. The module holds no weights.

    With a ``mesh`` whose 'space' axis holds more than one rank, the
    output rows are split over it, the exchanges the reference leaves to
    XLA (``__graft_entry__.py:166-192``) made explicit: rank s of n owns
    the band of ``ceil(H / n)`` rows from ``s ceil(H / n)``. The
    whole-frame statistics (the background mesh, or the ``::4`` MAD) stay
    whole-frame on every rank; each epoch's band is then warped from its
    source rows with a halo of ``max_shift + SUPPORT`` rows on each side
    (H1's reads wrap around the frame, so the first and last bands take
    their halos from the opposite edge), combined (H9, row by row) and
    the bands are gathered over 'space' into the whole stack on every
    rank, bit-equal to the single-process result. The band relies on the
    epochs lying in the ``max_shift`` bucket, as :func:`prepare_epoch_inputs`
    leaves them: a live epoch's grid further off raises ``ValueError``.
    """

    def __init__(self, cfg: PipelineConfig, subtract_back=True,
                 compute_weight=True, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.subtract_back = subtract_back
        self.compute_weight = compute_weight
        self.mesh = mesh

    def forward(self, imgs, sats, masks, gus, gvs, covbs, scales, valid):
        cfg = self.cfg
        N, H, W = imgs.shape
        if (H, W) != (cfg.height, cfg.width):
            raise ValueError(f'epochs of shape {(H, W)} do not fill the '
                             f'{(cfg.height, cfg.width)} canvas')
        if self.mesh is not None and axis_size(self.mesh, 'space') > 1:
            return self._forward_rows(imgs, sats, masks, gus, gvs, covbs,
                                      scales, valid)
        dev = imgs.device
        iw = torch.empty((N, H, W), dtype=torch.float32, device=dev)
        ww = torch.empty_like(iw)
        mw = torch.empty((N, H, W), dtype=torch.int32, device=dev)
        cov = torch.empty((N, H, W), dtype=torch.bool, device=dev)
        for n in range(N):
            self.warp_epoch(imgs[n], sats[n], masks[n], gus[n], gvs[n],
                            covbs[n], valid[n], iw[n], ww[n], mw[n], cov[n])
        with _stage('combine'):
            out = clipped_combine(iw, ww, mw, cov, scales)
        return {'coadd': out['coadd'], 'weight': out['weight'],
                'mask': out['mask'], 'nexp': out['nexp']}

    def _forward_rows(self, imgs, sats, masks, gus, gvs, covbs, scales,
                      valid):
        """The stack with its rows over the mesh's 'space' axis (see the
        class docstring)."""
        cfg = self.cfg
        N, H, W = imgs.shape
        dev = imgs.device
        ns, s = axis_size(self.mesh, 'space'), axis_index(self.mesh, 'space')
        gvs = torch.as_tensor(gvs)
        gy = torch.arange(gvs.shape[1], dtype=torch.float32,
                          device=gvs.device)[:, None] * cfg.map_step
        keep = torch.as_tensor(valid, device=gvs.device) > 0
        if keep.any() and float((gvs[keep] - gy).abs().amax()) \
                > cfg.max_shift + 0.5:
            raise ValueError('row bands need every epoch within the '
                             f'max_shift={cfg.max_shift} bucket '
                             '(prepare_epoch_inputs)')
        band = -(-H // ns)
        halo = cfg.max_shift + SUPPORT
        # the band's source rows from ``off``, its own rows at ``inner``;
        # band 0 starts at row 0 and keeps its upper halo (the frame's last
        # rows) at its end, where the warp's wrap-around reads them, so
        # that no band shifts a row by more than its own offset: the rows'
        # v - off and their offsets from the band's rows are then exact,
        # the single-process arithmetic
        off = s * band - halo if s else 0
        rows = (torch.arange(band + 2 * halo, device=dev) + off) % H
        if s == 0:
            rows[band + halo:] = torch.arange(H - halo, H, device=dev)
        inner = slice(s * band - off, s * band - off + band)
        iw = torch.empty((N, band, W), dtype=torch.float32, device=dev)
        ww = torch.empty_like(iw)
        mw = torch.empty((N, band, W), dtype=torch.int32, device=dev)
        cov = torch.empty((N, band, W), dtype=torch.bool, device=dev)
        for n in range(N):
            self.warp_epoch(imgs[n], sats[n], masks[n], gus[n], gvs[n],
                            covbs[n], valid[n], iw[n], ww[n], mw[n], cov[n],
                            band=(rows, off, inner))
        with _stage('combine'):
            out = clipped_combine(iw, ww, mw, cov, scales)
        group = self.mesh.get_group('space')
        return {k: torch.cat(all_gather(out[k].contiguous(), group))[:H]
                for k in ('coadd', 'weight', 'mask', 'nexp')}

    def _epoch_planes(self, img, sat, mask):
        """An epoch's pixels less its background and its weight map, each
        of the whole frame (pipeline.py:460-481)."""
        cfg = self.cfg
        bad = (mask & BAD_SUM) > 0
        with _stage('background'):
            if self.subtract_back:
                bres = background_mesh(img, ~bad, box=cfg.box)
                img_b = img - bres['back']
                rms = bres['rms']
            else:
                img_b = img
                sub, okf = img[::4, ::4], (~bad)[::4, ::4]
                med = frame_median(sub, okf)
                rms = (1.4826 * frame_median(sub, okf, center=med)).expand(
                    img.shape)
        with _stage('weight'):
            if self.compute_weight:
                wgt = torch.where(bad | (rms <= 0), 0.0,
                                  1.0 / torch.clamp(rms, min=1e-12) ** 2)
                wgt = torch.where(img >= SATUR_FRAC * sat, 0.0, wgt)
            else:
                wgt = torch.where(bad, 0.0, 1.0)
        return img_b, wgt

    def warp_epoch(self, img, sat, mask, gu, gv, covb, vld, iw, ww, mw, cov,
                   band=None):
        """One epoch onto the canvas (pipeline.py:460-491), written into
        the stack slices ``iw``, ``ww``, ``mw``, ``cov``. With ``band``,
        ``(rows, off, inner)`` of :meth:`_forward_rows`, only the band's
        source rows are warped and its own rows written."""
        cfg = self.cfg
        img_b, wgt = self._epoch_planes(img, sat, mask)
        with _stage('warp'):
            u, v = upsample_mapping(gu, gv, img.shape, cfg.map_step)
            inner = slice(None)
            if band is not None:
                rows, off, inner = band
                H = img.shape[0]
                # the bounds fold in the whole frame's own source test
                covb = torch.stack([
                    covb[0], covb[1],
                    torch.clamp(covb[2], min=SUPPORT - 1) - off,
                    torch.clamp(covb[3], max=H - SUPPORT) - off])
                img_b, wgt, mask, u = (t[rows] for t in (img_b, wgt, mask, u))
                v = v[rows] - off
            e_iw, e_ww, e_mw, e_cov = (t[inner] for t in warp_epoch(
                img_b, wgt.contiguous(), mask.contiguous(), u.contiguous(),
                v.contiguous(), covb.contiguous(), cfg.max_shift))
            # ``valid`` gates the epoch as the coverage does (the weight is
            # multiplied by it, as the reference multiplies)
            live = vld > 0
            cov.copy_(e_cov & live)
            iw.copy_(torch.where(live, e_iw, 0.0))
            torch.mul(e_ww, vld, out=ww)
            mw.copy_(torch.where(live, e_mw, 0))


def embed_roll(img, mask, H, W, dv0, du0, bit):
    """Embed an epoch frame (f32) and its mask (int32) into the (H, W)
    canvas and apply the integer pre-roll, on the tensors' device
    (pipeline.py:508-525). The canvas padding carries mask bit ``bit``, so
    the background mesh never takes it for sky."""
    Hs, Ws = img.shape
    h, w = min(Hs, H), min(Ws, W)
    canvas = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    canvas[:h, :w] = img[:h, :w]
    mcanvas = torch.full((H, W), 1 << bit, dtype=torch.int32,
                         device=img.device)
    mcanvas[:h, :w] = mask[:h, :w]
    return (torch.roll(canvas, (-dv0, -du0), dims=(0, 1)),
            torch.roll(mcanvas, (-dv0, -du0), dims=(0, 1)))


def prepare_epoch_inputs(im, out_wcs, cfg: PipelineConfig, device=None,
                         stats=None):
    """:class:`CoaddPipeline`'s inputs for one epoch (pipeline.py:528-578):
    the mapping grid from the output canvas into the epoch frame, the
    integer pre-roll into the ``max_shift`` bucket (a residual past it
    raises ``ValueError``), the FLXSCALE factor. The frame and its mask (a
    raw 16-bit mask as its int16 bits) are uploaded once to ``device`` (the
    card unless ``'cpu'``) and embedded and rolled there; the grids and
    scalars stay numpy. ``stats`` gains the uploads' host seconds and
    bytes."""
    from ..inputs import resolve_device, upload, upload_mask
    from ..ops.resample import SUPPORT
    from ..wcs import pixel_mapping

    device = resolve_device(device)
    grid = pixel_mapping(im.wcs, out_wcs, (cfg.height, cfg.width),
                         step=cfg.map_step)
    gu, gv = np.asarray(grid.u, 'f4'), np.asarray(grid.v, 'f4')
    data = _as_f4(im.data)
    Hs, Ws = data.shape
    cov_bounds = np.asarray([SUPPORT - 1, Ws - SUPPORT,
                             SUPPORT - 1, Hs - SUPPORT], 'f4')
    gx = np.arange(gu.shape[1], dtype='f4') * cfg.map_step
    gy = np.arange(gv.shape[0], dtype='f4') * cfg.map_step
    du = gu - gx[None, :]
    dv = gv - gy[:, None]
    resid = max(np.abs(du).max(), np.abs(dv).max())
    du0 = dv0 = 0
    if resid > cfg.max_shift or (Hs, Ws) != (cfg.height, cfg.width):
        du0 = int(round(float(np.median(du))))
        dv0 = int(round(float(np.median(dv))))
        resid2 = max(np.abs(du - du0).max(), np.abs(dv - dv0).max())
        if resid2 > cfg.max_shift:
            raise ValueError(
                f'mapping residual {resid2:.2f} exceeds the '
                f'max_shift={cfg.max_shift} bucket; per-pair fallback')
        gu = gu - np.float32(du0)
        gv = gv - np.float32(dv0)
        cov_bounds = cov_bounds - np.asarray([du0, du0, dv0, dv0], 'f4')
    mraw = im.mask_image.data if im.mask_image is not None else None
    img_d, mask_d = embed_roll(
        upload(data, device, stats),
        upload_mask(mraw, (Hs, Ws), device, stats), cfg.height, cfg.width,
        dv0, du0, bit=MASK_BIT_NODATA_ALIGN)
    zp = im.header.get('MAGZP')
    return {
        'img': img_d, 'mask': mask_d,
        'sat': np.float32(im.header.get('SATURATE', 0) or 3e38),
        'grid_u': gu, 'grid_v': gv, 'cov_bounds': cov_bounds,
        'scale': np.float32(fluxscale(zp) if zp is not None else 1.0),
    }
