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

__all__ = ['DEFAULT_FILTER', 'conv2_same', 'filter_taps',
           'fft_convolve_same', 'gaussian_kernel', 'dilate_max']

# SExtractor's default.conv pyramid filter, normalised to unit sum
DEFAULT_FILTER = np.array([[1.0, 2.0, 1.0],
                           [2.0, 4.0, 2.0],
                           [1.0, 2.0, 1.0]]) / 16.0


def filter_taps(kernel):
    """A filter given as an array or a tensor, as the f32 numpy array
    :func:`conv2_same` takes its taps from (a tensor is read to the
    host)."""
    if torch.is_tensor(kernel):
        kernel = kernel.detach().cpu().numpy()
    return np.asarray(kernel, dtype=np.float32)


def conv2_same(img, kernel, max_taps=49):
    """'Same'-size correlation with zero padding (convolve.py:18), the pad
    ``kh // 2, (kh - 1) // 2`` rows and ``kw // 2, (kw - 1) // 2`` columns:
    ``out[y, x] = sum k[dy, dx] * pad[y + dy, x + dx]``. A filter (array or
    tensor) of at most ``max_taps`` taps is added tap by tap in row-major
    order starting from zero, zero-weight taps skipped; a larger one is one
    ``F.conv2d`` with TF32 off, as the reference leaves it to XLA's
    convolution."""
    k = filter_taps(kernel)
    kh, kw = k.shape
    H, W = img.shape
    pad = F.pad(img, (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2))
    if kh * kw > max_taps:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            return F.conv2d(pad[None, None], torch.as_tensor(
                k, dtype=img.dtype, device=img.device)[None, None])[0, 0]
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
