"""Convolution helpers (twin of ``zuds_tpu/ops/convolve.py``) and the
sliding maximum of the pipeline and the stamp selector. No path of the
pipeline runs :func:`fft_convolve_same` or :func:`gaussian_kernel`: they are
the reference's exported helpers, in plain torch (``torch.fft`` as the
reference uses ``jnp.fft``)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['DEFAULT_FILTER', 'conv2_same', 'fft_convolve_same',
           'gaussian_kernel', 'dilate_max']

# SExtractor's default.conv pyramid filter, normalised to unit sum
DEFAULT_FILTER = np.array([[1.0, 2.0, 1.0],
                           [2.0, 4.0, 2.0],
                           [1.0, 2.0, 1.0]]) / 16.0


def conv2_same(img, kernel):
    """'Same'-size correlation with zero padding (convolve.py:18):
    ``out[y, x] = sum k[dy, dx] * pad[y + dy, x + dx]``, the taps added in
    row-major order starting from zero, zero-weight taps skipped."""
    k = np.asarray(kernel, dtype=np.float32)
    kh, kw = k.shape
    H, W = img.shape
    pad = F.pad(img, (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    out = torch.zeros_like(img)
    for dy in range(kh):
        for dx in range(kw):
            w = float(k[dy, dx])
            if w != 0.0:
                out = out + w * pad[dy:dy + H, dx:dx + W]
    return out


def fft_convolve_same(img, kernel):
    """FFT-based 'same' convolution (convolve.py:58): the linear
    convolution of ``img`` (H, W) with ``kernel`` (kh, kw), both
    zero-padded to (H + kh - 1, W + kw - 1), cropped at (kh // 2, kw // 2)
    to (H, W). ``kernel`` may be a tensor or an array; it takes ``img``'s
    dtype and device."""
    H, W = img.shape
    k = torch.as_tensor(np.asarray(kernel) if not torch.is_tensor(kernel)
                        else kernel, dtype=img.dtype, device=img.device)
    kh, kw = k.shape
    fh, fw = H + kh - 1, W + kw - 1
    full = torch.fft.irfft2(torch.fft.rfft2(img, (fh, fw))
                            * torch.fft.rfft2(k, (fh, fw)), (fh, fw))
    y0, x0 = kh // 2, kw // 2
    return full[y0:y0 + H, x0:x0 + W]


def gaussian_kernel(sigma, size, device=None):
    """Normalised 2-D Gaussian of odd ``size`` (convolve.py:70), f32, on
    ``device`` (the card when None, as the port's entry points)."""
    r = size // 2
    ax = torch.arange(-r, r + 1, dtype=torch.int32,
                      device='cuda' if device is None else device)
    r2 = ax[:, None] * ax[:, None] + ax[None, :] * ax[None, :]
    g = torch.exp(-r2.to(torch.float32) / (2.0 * sigma * sigma))
    return g / g.sum()


def dilate_max(x, reach, fill=-math.inf):
    """(2*reach+1)^2 sliding max by log-doubling shifted maxes, edges
    padded with ``fill`` (pipeline.py:102; the shift rounds k = 1, 2, 1 of
    measure.py:45-58 at reach 4). NaN propagates, as in jnp.maximum. A
    shift past a frame narrower than it is all ``fill``, as the reference's
    clamped slices give."""
    def shift2(a, k, dim):
        n = a.shape[dim]
        k = min(k, n)
        pad_shape = list(a.shape)
        pad_shape[dim] = k
        pad = torch.full(pad_shape, fill, dtype=a.dtype, device=a.device)
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
