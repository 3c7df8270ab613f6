"""H4: matched filter + threshold, in Triton.

Replaces ``zuds_tpu/ops/detect.py:607-616`` (the good-pixel mask, the 3x3
pyramid correlation of ``zuds_tpu/ops/convolve.py:conv2_same`` with zero
padding, and the nsigma*rms threshold), which the TPU runs as nine
unrolled shift-FMA taps. Here each program loads a 2-D tile with its
one-pixel halo through masked loads, recomputes ``good`` for every tap, and
writes the three planes the detection stage reads: ``img``, ``filt`` and
``det``.

Bound: memory. 9 bytes in and 9 bytes out per pixel (f32 diff and rms, a
bool), the halo re-reads hit L1/L2. The taps are summed in the reference's
row-major order; the pyramid weights are powers of two, so every product
is exact and ``filt`` does not depend on FMA contraction.

``triton`` is imported on the first launch, never at module import.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ['detect_filter']

_BLOCK_H, _BLOCK_W = 16, 64
_FLT_MAX = float(np.finfo(np.float32).max)


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(diff_ptr, rms_ptr, wok_ptr, img_ptr, filt_ptr, det_ptr,
               H, W, nsigma, FLT_MAX: tl.constexpr,
               BLOCK_H: tl.constexpr, BLOCK_W: tl.constexpr):
        ys = tl.program_id(0) * BLOCK_H + tl.arange(0, BLOCK_H)[:, None]
        xs = tl.program_id(1) * BLOCK_W + tl.arange(0, BLOCK_W)[None, :]
        inb = (ys < H) & (xs < W)
        off = ys * W + xs
        dc = tl.load(diff_ptr + off, mask=inb, other=0.0)
        rc = tl.load(rms_ptr + off, mask=inb, other=0.0)
        wc = tl.load(wok_ptr + off, mask=inb, other=0)
        gc = (wc != 0) & (rc > 0.0) & (tl.abs(dc) <= FLT_MAX)
        acc = tl.zeros((BLOCK_H, BLOCK_W), dtype=tl.float32)
        # the 3x3 pyramid (1 2 1 / 2 4 2 / 1 2 1) / 16 in row-major tap
        # order, as conv2_same adds them; "good" is recomputed per tap
        for dy in tl.static_range(-1, 2):
            for dx in tl.static_range(-1, 2):
                yy = ys + dy
                xx = xs + dx
                ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
                o = yy * W + xx
                d = tl.load(diff_ptr + o, mask=ok, other=0.0)
                r = tl.load(rms_ptr + o, mask=ok, other=0.0)
                w = tl.load(wok_ptr + o, mask=ok, other=0)
                g = (w != 0) & (r > 0.0) & (tl.abs(d) <= FLT_MAX)
                acc = acc + ((2 - dy * dy) * (2 - dx * dx) * 0.0625) \
                    * tl.where(g, d, 0.0)
        tl.store(img_ptr + off, tl.where(gc, dc, 0.0), mask=inb)
        tl.store(filt_ptr + off, acc, mask=inb)
        tl.store(det_ptr + off, (gc & (acc > nsigma * rc)).to(tl.uint8),
                 mask=inb)

    return triton, kernel


def detect_filter(diff, rms, weight_ok, nsigma):
    """H4: (img f32, filt f32, det bool), each (H, W), for CUDA tensors
    ``diff``/``rms`` (f32) and ``weight_ok`` (bool)."""
    H, W = diff.shape
    for name, t, dt in (('diff', diff, torch.float32),
                        ('rms', rms, torch.float32),
                        ('weight_ok', weight_ok, torch.bool)):
        if not t.is_cuda or t.dtype != dt or tuple(t.shape) != (H, W) \
                or not t.is_contiguous():
            raise ValueError(f'detect_filter: {name} must be a contiguous '
                             f'CUDA {dt} tensor of shape {(H, W)}')
    if H * W >= 2 ** 31:
        raise ValueError('detect_filter: frame too large for int32 offsets')
    triton, kernel = _kernel()
    img = torch.empty_like(diff)
    filt = torch.empty_like(diff)
    det = torch.empty((H, W), dtype=torch.uint8, device=diff.device)
    grid = (triton.cdiv(H, _BLOCK_H), triton.cdiv(W, _BLOCK_W))
    kernel[grid](diff, rms, weight_ok.view(torch.uint8), img, filt, det,
                 H, W, float(nsigma), FLT_MAX=_FLT_MAX, BLOCK_H=_BLOCK_H,
                 BLOCK_W=_BLOCK_W, num_warps=4)
    detect_filter.launches += 1
    return img, filt, det.view(torch.bool)


detect_filter.launches = 0
