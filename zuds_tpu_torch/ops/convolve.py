"""Convolution helpers (twin of ``zuds_tpu/ops/convolve.py``) and the
sliding maximum of the pipeline and the stamp selector."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['DEFAULT_FILTER', 'conv2_same', 'dilate_max']

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


def dilate_max(x, reach, fill=-math.inf):
    """(2*reach+1)^2 sliding max by log-doubling shifted maxes, edges
    padded with ``fill`` (pipeline.py:102; the shift rounds k = 1, 2, 1 of
    measure.py:45-58 at reach 4). NaN propagates, as in jnp.maximum."""
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
