"""Convolution helpers (twin of ``zuds_tpu/ops/convolve.py``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['DEFAULT_FILTER', 'conv2_same']

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
