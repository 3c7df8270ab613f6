"""Stack combination (twin of ``zuds_tpu/ops/coadd.py``): the CLIPPED
weighted-mean combine of a warped epoch stack, the AND / OR combine of its
masks, and the two-pass streaming variant.

:func:`clipped_coadd`, :func:`combine_masks` and :func:`clipped_coadd_scan`
are plain PyTorch. :func:`clipped_combine` is what the coadd pipeline
calls: on a CUDA tensor it runs hand kernel H9 (``kernels/coadd.cu``), which
does the clip, the mask AND and the no-data bit in one pass over the stack;
on a CPU tensor it runs :func:`clipped_combine_plain`, the same function
composed of the plain versions.

Arithmetic kept from the reference's CPU results, so integer outputs agree
with it:

* with ``scales`` the deviation is ``|fma(x, s, -med)|`` (XLA:CPU contracts
  the scaling into the subtraction);
* the clip threshold is ``nsigma*sigma + amp_frac*|med|`` in two roundings
  for stacks of up to 32 epochs, and ``fma(amp_frac, |med|, nsigma*sigma)``
  for deeper ones (probed on 2-17, 32, 33 and 64 epochs);
* the sums over epochs run in epoch order for up to 32 epochs and in
  XLA:CPU's windows of 32 beyond (:mod:`.ordered`; the reference's own
  order inside ``clipped_coadd`` was confirmed for 2-17, 33 and 64 epochs
  and differs from both for 24-32, where the port adds in epoch order).

``sigma = 1/sqrt(w)`` is correctly rounded here and in H9. XLA:CPU
evaluates it with an approximate ``rsqrt`` that is one ulp off for about a
quarter of all weights, so a pixel within one ulp of its clip threshold can
fall on the other side in the reference.
"""
from __future__ import annotations

import torch

from ..constants import CLIP_NSIGMA, COADD_ZP, MASK_BIT_NODATA_ALIGN
from ..kernels import launch
from .ordered import fma, sum_last

__all__ = ['fluxscale', 'clipped_coadd', 'combine_masks',
           'clipped_coadd_scan', 'clipped_combine', 'clipped_combine_plain',
           'SEQUENTIAL_EPOCHS']

# stacks up to this depth are summed in epoch order
SEQUENTIAL_EPOCHS = 32


def fluxscale(magzp, target_zp=COADD_ZP):
    """SWarp FLXSCALE factor normalizing a frame to the common zeropoint."""
    return 10.0 ** (-0.4 * (magzp - target_zp))


def _scaled(imgs, weights, scales):
    s = scales[:, None, None]
    return imgs * s, weights / (s * s)


def _sum_epochs(x):
    """Sum over the leading (epoch) axis in the reference's order."""
    if x.shape[0] > SEQUENTIAL_EPOCHS:
        return sum_last(x.movedim(0, -1))
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def clipped_coadd(imgs, weights, scales=None, nsigma=CLIP_NSIGMA,
                  amp_frac=0.3):
    """CLIPPED-mean combine of a warped epoch stack (coadd.py:42).

    ``imgs``, ``weights``: (N, H, W) float32, weight 0 marks no data;
    ``scales``: optional (N,) FLXSCALE factors (pixels multiply, weights
    divide by the square). An epoch is rejected at a pixel where it
    deviates from the median of the valid epochs by more than ``nsigma`` of
    its own sigma plus ``amp_frac`` of ``|median|``. Returns dict:
    ``coadd`` and ``weight`` (H, W) float32, ``nclip`` and ``nexp`` (H, W)
    int32.
    """
    n = imgs.shape[0]
    raw = imgs
    if scales is not None:
        imgs, weights = _scaled(imgs, weights, scales)
    ok = weights > 0
    inf = torch.tensor(float('inf'), dtype=imgs.dtype, device=imgs.device)
    sigma = torch.where(ok, 1.0 / torch.sqrt(torch.clamp(weights, min=1e-30)),
                        inf)

    # stack median over valid epochs (per pixel)
    svals = torch.sort(torch.where(ok, imgs, inf), dim=0).values
    cnt = ok.sum(0)
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode='floor'), 0, n - 1)
    hi = torch.clamp(torch.div(cnt, 2, rounding_mode='floor'), 0, n - 1)
    med = 0.5 * (torch.gather(svals, 0, lo[None])
                 + torch.gather(svals, 0, hi[None]))[0]
    med = torch.where(cnt > 0, med, 0.0)

    amed = med.abs()[None]
    if n <= SEQUENTIAL_EPOCHS:
        tol = nsigma * sigma + amp_frac * amed
    else:
        af = torch.tensor(amp_frac, dtype=imgs.dtype, device=imgs.device)
        tol = fma(af, amed, nsigma * sigma)
    if scales is None:
        dev = (imgs - med[None]).abs()
    else:
        dev = fma(raw, scales[:, None, None], -med[None]).abs()
    keep = ok & (dev <= tol)
    wsum = _sum_epochs(torch.where(keep, weights, 0.0))
    csum = _sum_epochs(torch.where(keep, weights * imgs, 0.0))
    coadd = csum / torch.where(wsum > 0, wsum, 1.0)
    return {
        'coadd': torch.where(wsum > 0, coadd, 0.0),
        'weight': wsum,
        'nclip': (cnt - keep.sum(0)).to(torch.int32),
        'nexp': cnt.to(torch.int32),
    }


def combine_masks(masks, coverage=None, mode='and'):
    """Combine warped int32 bitmasks: 'and' (a bit survives only if set in
    every covering epoch; 0 where none covers) or 'or' (coadd.py:93)."""
    if mode not in ('and', 'or'):
        raise ValueError(f"mode must be 'and' or 'or', got {mode!r}")
    masks = masks.to(torch.int32)
    if coverage is None:
        coverage = torch.ones(masks.shape, dtype=torch.bool,
                              device=masks.device)
    else:
        coverage = coverage.to(torch.bool)
    # uncovered epochs contribute no bit to the OR and every bit (-1) to
    # the AND
    out = torch.where(coverage[0], masks[0], 0 if mode == 'or' else -1)
    for i in range(1, masks.shape[0]):
        if mode == 'or':
            out = out | torch.where(coverage[i], masks[i], 0)
        else:
            out = out & torch.where(coverage[i], masks[i], -1)
    if mode == 'or':
        return out
    return torch.where(coverage.any(0), out, 0)


def clipped_coadd_scan(imgs, weights, scales=None, nsigma=CLIP_NSIGMA,
                       amp_frac=0.3, med=None):
    """Memory-bounded CLIPPED combine in two passes over the epochs
    (coadd.py:116): pass 1 takes the weighted mean as the centre (or the
    supplied ``med``), pass 2 clips against it."""
    if scales is not None:
        imgs, weights = _scaled(imgs, weights, scales)
    zero = torch.zeros(imgs.shape[1:], dtype=imgs.dtype, device=imgs.device)
    if med is None:
        s, w = zero, zero
        for x, wt in zip(imgs, weights):
            s, w = s + x * wt, w + wt
        med = s / torch.where(w > 0, w, 1.0)

    s, w = zero, zero
    nc = torch.zeros(imgs.shape[1:], dtype=torch.int32, device=imgs.device)
    ne = torch.zeros_like(nc)
    inf = torch.tensor(float('inf'), dtype=imgs.dtype, device=imgs.device)
    for x, wt in zip(imgs, weights):
        ok = wt > 0
        sig = torch.where(ok, 1.0 / torch.sqrt(torch.clamp(wt, min=1e-30)),
                          inf)
        keep = ok & ((x - med).abs() <= nsigma * sig + amp_frac * med.abs())
        s = s + torch.where(keep, x * wt, 0.0)
        w = w + torch.where(keep, wt, 0.0)
        nc = nc + (ok & ~keep).to(torch.int32)
        ne = ne + ok.to(torch.int32)
    coadd = s / torch.where(w > 0, w, 1.0)
    return {'coadd': torch.where(w > 0, coadd, 0.0), 'weight': w,
            'nclip': nc, 'nexp': ne}


def clipped_combine_plain(imgs, weights, masks, coverage, scales=None,
                          nsigma=CLIP_NSIGMA, amp_frac=0.3):
    """Plain version of H9: :func:`clipped_coadd`, the AND of ``masks``
    (int32) over ``coverage`` (bool), and the no-data bit where no epoch
    contributed (pipeline.py:497-501). Returns the dict of
    :func:`clipped_coadd` plus ``mask`` (H, W) int32."""
    out = clipped_coadd(imgs, weights, scales, nsigma=nsigma,
                        amp_frac=amp_frac)
    mask = combine_masks(masks, coverage, mode='and')
    out['mask'] = torch.where(out['weight'] == 0,
                              mask | (1 << MASK_BIT_NODATA_ALIGN), mask)
    return out


def clipped_combine(imgs, weights, masks, coverage, scales=None,
                    nsigma=CLIP_NSIGMA, amp_frac=0.3):
    """The coadd pipeline's combine: H9 on a CUDA stack,
    :func:`clipped_combine_plain` on a CPU stack."""
    if imgs.is_cuda:
        return launch.clipped_combine(imgs, weights, masks, coverage, scales,
                                      nsigma, amp_frac,
                                      MASK_BIT_NODATA_ALIGN)
    return clipped_combine_plain(imgs, weights, masks, coverage, scales,
                                 nsigma=nsigma, amp_frac=amp_frac)
