"""Batched subtract -> detect -> photometer pipeline (twin of
``zuds_tpu/parallel/pipeline.py:make_subtract_detect_pipeline``).

:class:`SubtractDetectPipeline` runs ``one_frame`` of the reference
(:153-398) frame by frame over the batch, as ``jax.lax.map`` does. On a
CUDA device the warp (H1), the background cells (H2), the model
convolution (H3), the matched filter (H4), the deblend tree's level labels
(H5) and the compactions (H6) run as hand-written kernels; everything
between them is plain PyTorch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..constants import (BAD_SUM, BIG_RMS, BKG_BOX_SIZE, BKG_VAL,
                         DETECT_NSIGMA, MASK_BIT_NODATA_ALIGN,
                         MASK_BIT_NODATA_SUB, SUB_NODATA_SENTINEL)
from ..ops.background import background_mesh, bisect_median
from ..ops.detect import DETECTION_FIELDS, detect_sources
from ..ops.measure import refine_detections
from ..ops.photometry import (aperture_photometry_batched,
                              circle_pixel_overlap, cutouts)
from ..ops.ordered import sum_last2
from ..ops.resample import upsample_mapping, warp_reference
from ..ops.subtract import (apply_kernel_fast, center_kernels, fit_kernel,
                            region_edges)

__all__ = ['PipelineConfig', 'SubtractDetectPipeline']

REFINE_KEYS = ('xwin', 'ywin', 'kron_radius', 'flux_auto', 'fluxerr_auto',
               'awin', 'bwin', 'thetawin', 'errawin', 'errbwin',
               'errthetawin')


@dataclass(frozen=True)
class PipelineConfig:
    """Static pipeline shape parameters: the fields and defaults of the
    reference's ``PipelineConfig`` (pipeline.py:38-99), whose module
    imports JAX. :class:`SubtractDetectPipeline` raises
    ``NotImplementedError`` for the values this port does not run yet;
    ``interleave`` is a TPU scheduling knob that does not change outputs
    and is ignored."""

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


def _check_supported(cfg):
    unsupported = [
        (cfg.sep_warp, 'sep_warp=True',
         "queue 2 'Not ported' (separable warp variants)"),
        (cfg.ref_rms_mesh, 'ref_rms_mesh=True',
         'K3/K5 follow-up (reference rms mesh + propagate_ref_var)'),
        (cfg.dbg_stop_after is not None,
         f'dbg_stop_after={cfg.dbg_stop_after!r}', 'stage-bisection knobs'),
        (cfg.det_dbg_stop_after is not None,
         f'det_dbg_stop_after={cfg.det_dbg_stop_after!r}',
         'stage-bisection knobs'),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f'{what} is not ported yet (ROADMAP {item})')


def _dilate_max(x, reach, fill=-math.inf):
    """(2*reach+1)^2 sliding max by log-doubling shifted maxes, edges
    padded with ``fill`` (pipeline.py:102)."""
    def shift2(a, k, dim):
        pad_shape = list(a.shape)
        pad_shape[dim] = k
        pad = torch.full(pad_shape, fill, dtype=a.dtype, device=a.device)
        n = a.shape[dim]
        lo = torch.cat([a.narrow(dim, k, n - k), pad], dim)
        hi = torch.cat([pad, a.narrow(dim, 0, n - k)], dim)
        return torch.maximum(a, torch.maximum(lo, hi))

    covered, step = 0, 1
    while covered < reach:
        k = min(step, reach - covered)
        for dim in (0, 1):
            x = shift2(x, k, dim)
        covered += k
        step = covered + 1
    return x


# named ranges for torch.profiler (python -m zuds_tpu_torch.profile); they
# record only while a profiler runs
_stage = torch.profiler.record_function


def _median_of(x, ok):
    """bisect_median of a whole (sub)frame."""
    return bisect_median(x.reshape(1, -1), ok.reshape(1, -1))[0]


class SubtractDetectPipeline(nn.Module):
    """Subtract + detect + photometer a batch of quadrant pairs.

    ``forward`` takes the 14 batched inputs of the reference
    (pipeline.py:133-140; see :data:`zuds_tpu_torch.inputs.INPUT_NAMES`)
    with masks int32 and ``stamp_valid`` bool, and returns the reference's
    output dict (pipeline.py:367-397) with a leading batch dimension. The
    module holds no weights: its state is the configuration.
    """

    def __init__(self, cfg: PipelineConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg

    def forward(self, *args):
        if len(args) != 14:
            raise ValueError(f'expected 14 batched inputs, got {len(args)}')
        outs = [self.one_frame(*(a[i] for a in args))
                for i in range(args[0].shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def one_frame(self, sci, sci_mask, ref, ref_mask, gu, gv, sx, sy, sv,
                  bgx, bgy, bsums, b0, covb):
        """One quadrant pair (pipeline.py:153-398)."""
        cfg = self.cfg
        H, W = cfg.height, cfg.width
        dev = sci.device
        with _stage('warp'):
            u, v = upsample_mapping(gu, gv, (H, W), cfg.map_step)
            refw, refm, cov = warp_reference(ref, ref_mask, u, v, covb,
                                             cfg.max_shift)
            submask = (sci_mask | refm
                       | torch.where(cov == 0, 1 << MASK_BIT_NODATA_ALIGN, 0)
                       .to(torch.int32))
            bad = (submask & BAD_SUM) > 0

        with _stage('background'):
            bres = background_mesh(sci, ~bad, box=cfg.box)
            scimbkg = (sci - bres['back']) + BKG_VAL
            rms = bres['rms']
            # global robust sigma of the warped reference from a ::4
            # subsample (pipeline.py:198-209)
            sub = refw[::4, ::4]
            okf = cov[::4, ::4] > 0
            med = _median_of(sub, okf)
            ref_rms = 1.4826 * _median_of((sub - med).abs(), okf)
            ivar = 1.0 / torch.clamp(rms ** 2 + ref_rms ** 2, min=1e-6)
            ivar = torch.where(bad, 0.0, ivar)

        with _stage('fit'):
            fit = fit_kernel(refw, scimbkg, ivar, sx, sy, sv, bgx, bgy,
                             bsums, b0, stamp=cfg.stamp, order=cfg.order,
                             nreg=cfg.nreg)

        with _stage('apply'):
            model = apply_kernel_fast(refw, fit['coeffs'], bgx, bgy, bsums,
                                      b0, order=cfg.order, nreg=cfg.nreg)
            diff = scimbkg - model

        with _stage('noise'):
            # constant reference sigma: conv(var, K^2) == var * sum(K^2),
            # per static region rectangle (pipeline.py:247-263)
            kerns = center_kernels(fit['coeffs'], bgx, bgy, bsums, b0,
                                   order=cfg.order, nreg=cfg.nreg)
            k2sum = sum_last2(kerns * kerns)
            y_e, x_e = region_edges(H, cfg.nreg), region_edges(W, cfg.nreg)
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

        with _stage('detect'):
            det = detect_sources(diff, rms_out, submask, ~bad,
                                 nsigma=cfg.nsigma, max_det=cfg.max_det,
                                 return_labels=False, deblend=cfg.deblend,
                                 det_cap=(cfg.det_cap or None),
                                 deb_cap=(cfg.deb_cap or None))

        with _stage('measure'):
            phot = aperture_photometry_batched(diff, rms_out, submask,
                                               det['x'], det['y'])
            ref_meas = refine_detections(diff, rms_out, det['x'], det['y'],
                                         det['a'], det['b'], det['theta'],
                                         det['fwhm'])
            rms_ap6, bpm_ap6 = self._aperture6(rms_out, bad, det['x'],
                                               det['y'])
            rms_med = _median_of(rms_out[::4, ::4], ~bad[::4, ::4])
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

    def _aperture6(self, rms_out, bad, xs, ys, r6=6.0, cut6=15):
        """r=6 rms and bad-pixel aperture sums (pipeline.py:306-328)."""
        H, W = rms_out.shape
        half6 = cut6 // 2
        x0 = torch.clamp(torch.round(xs).to(torch.int64) - half6, 0, W - cut6)
        y0 = torch.clamp(torch.round(ys).to(torch.int64) - half6, 0, H - cut6)
        sr, sb = cutouts(torch.stack([rms_out, bad.to(torch.float32)]),
                         x0, y0, cut6)
        ar = torch.arange(cut6, dtype=torch.float32, device=xs.device)
        yy = y0.to(torch.float32)[:, None, None] + ar[None, :, None]
        xx = x0.to(torch.float32)[:, None, None] + ar[None, None, :]
        w = circle_pixel_overlap(xx - xs[:, None, None],
                                 yy - ys[:, None, None], r6).clamp(0.0, 1.0)
        return sum_last2(sr * w), sum_last2(sb * w)

    def _negpix(self, diff, xs, ys, big=13):
        """Negative-pixel veto: a < -5 sigma pixel next to a > +5 sigma one
        inside the 11x11 box around each candidate (pipeline.py:338-365)."""
        H, W = diff.shape
        dsub = diff[::4, ::4]
        allok = torch.ones_like(dsub, dtype=torch.bool)
        dmed = _median_of(dsub, allok)
        dmad = _median_of((dsub - dmed).abs(), allok)
        dsig = torch.clamp(1.48 * dmad, min=1e-12)
        half = big // 2
        x0 = torch.clamp(torch.round(xs).to(torch.int64) - half, 0, W - big)
        y0 = torch.clamp(torch.round(ys).to(torch.int64) - half, 0, H - big)
        s_full = (diff - dmed) / dsig
        m3 = _dilate_max(s_full, 1)
        badpx = ((s_full < -5.0) & (m3 > 5.0)).to(torch.float32)
        or11 = _dilate_max(badpx, half - 1, fill=0.0)
        return or11[y0 + half, x0 + half] > 0.0
