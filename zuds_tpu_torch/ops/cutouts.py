"""Per-candidate cutouts of the filter's last two steps (twin of the
device code of ``zuds_tpu/filterobjects.py``): the braai triplets with
their hand kernel H12 and the negative-pixel veto's stencil with H14
(both ``kernels/cutouts.cu``), each beside its plain version. A wrapper
launches the kernel on a CUDA tensor and runs the plain version on a CPU
tensor."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import launch
from .photometry import cutouts

__all__ = ['clamped_corners', 'frame_median_exact', 'triplet_cut',
           'triplet_cut_plain', 'negpix_veto', 'negpix_veto_plain',
           'NEGPIX_BOX', 'NEGPIX_INNER']

NEGPIX_INNER = 11                  # the veto's box (the reference's CUTSIZE)
NEGPIX_BOX = NEGPIX_INNER + 2      # with the 3x3 maximum's reach


def clamped_corners(xs, ys, size, H, W):
    """int32 (N,) corners of the ``size`` x ``size`` windows about the f32
    positions ``xs``, ``ys``: ``round(x) - size // 2`` (half to even, as
    ``jnp.round``) clamped to ``[0, W - size]`` and ``[0, H - size]``."""
    x0 = torch.clamp(torch.round(xs).to(torch.int32) - size // 2, 0, W - size)
    y0 = torch.clamp(torch.round(ys).to(torch.int32) - size // 2, 0, H - size)
    return x0.to(torch.int32).contiguous(), y0.to(torch.int32).contiguous()


def frame_median_exact(x):
    """Exact median of all of ``x`` (0-d, on its device), the two middle
    values averaged for an even count as ``jnp.median`` does; a NaN sorts
    last. Library glue (one sort), as the reference's median is XLA's."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def triplet_cut_plain(new, ref, sub, x0, y0, size=63):
    """Plain version of H12: the (N, size, size, 3) NHWC stack of the
    windows of ``new``, ``ref`` and ``sub`` at the corners ``x0``, ``y0``,
    each divided by ``sqrt(max(sum c^2, 1e-20))``
    (filterobjects.py:64-90)."""
    planes = cutouts(torch.stack([new, ref, sub]), x0.long(), y0.long(), size)
    norm = torch.sqrt(torch.clamp((planes * planes).sum((2, 3)), min=1e-20))
    return (planes / norm[:, :, None, None]).permute(1, 2, 3, 0).contiguous()


def triplet_cut(new, ref, sub, x0, y0):
    """The triplets of :func:`triplet_cut_plain` at the 63 px cutout: H12
    on CUDA tensors, the plain version on CPU tensors."""
    if new.is_cuda:
        return launch.triplet_cut(new.contiguous(), ref.contiguous(),
                                  sub.contiguous(), x0, y0)
    return triplet_cut_plain(new, ref, sub, x0, y0)


def negpix_veto_plain(img, med, sig, x0, y0):
    """Plain version of H14: bool (N,), True where the NEGPIX_BOX window
    at ``x0``, ``y0`` standardised by ``(v - med) / max(sig, 1e-12)`` holds
    a pixel below -5 in its central NEGPIX_INNER box whose 3x3 'SAME'
    maximum (-inf padding) exceeds +5 (filterobjects.py:37-61)."""
    cut = cutouts(img[None], x0.long(), y0.long(), NEGPIX_BOX)[0]
    s = (cut - med) / torch.clamp(sig, min=1e-12)
    m = F.max_pool2d(F.pad(s[:, None], (1, 1, 1, 1), value=-float('inf')),
                     3, 1)[:, 0]
    inner = (slice(None), slice(1, 1 + NEGPIX_INNER),
             slice(1, 1 + NEGPIX_INNER))
    return ((s[inner] < -5.0) & (m[inner] > 5.0)).flatten(1).any(1)


def negpix_veto(img, med, sig, x0, y0):
    """The veto of :func:`negpix_veto_plain`: H14 on a CUDA tensor (``med``
    and ``sig`` stay on the card), the plain version on a CPU tensor."""
    if img.is_cuda:
        return launch.negpix_veto(img.contiguous(), med, sig, x0, y0)
    return negpix_veto_plain(img, med, sig, x0, y0)
