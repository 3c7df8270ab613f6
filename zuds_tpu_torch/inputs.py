"""The pipeline's per-frame state: kernel-basis tables and input tuples.

The subtract/detect path has no learned weights. What it carries is the
14-array input tuple of ``zuds_tpu/parallel/pipeline.py:133-140`` and the
A&L kernel-basis tables. Both are built here in host numpy, byte-for-byte
as the JAX package builds them, and moved onto a device by
:func:`to_torch`.
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import KERNEL_GAUSS_DEGREES, KERNEL_GAUSS_SIGMAS

__all__ = ['KernelBasis', 'synth_inputs', 'to_torch', 'INPUT_NAMES']

# order of the batched pipeline inputs (zuds_tpu/parallel/pipeline.py:133-140)
INPUT_NAMES = ('sci', 'sci_mask', 'ref', 'ref_mask', 'grid_u', 'grid_v',
               'stamp_x', 'stamp_y', 'stamp_valid', 'basis_gx', 'basis_gy',
               'basis_sums', 'b0', 'cov_bounds')
_MASK_SLOTS = (1, 3)
_BOOL_SLOTS = (8,)

# Lanczos-3 support (zuds_tpu/ops/resample.py:29)
SUPPORT = 3


class KernelBasis:
    """Separable Gaussian x polynomial kernel basis (twin of
    ``zuds_tpu/ops/subtract.py:58-100``): float64 construction, float32
    tables ``gx``/``gy`` (Nb, K), ``sums`` (Nb,) and ``b0_2d`` (K, K).
    """

    def __init__(self, ksize, seeing_sigma=2.0,
                 sigmas=KERNEL_GAUSS_SIGMAS, degrees=KERNEL_GAUSS_DEGREES):
        if ksize % 2 != 1:
            raise ValueError(f'ksize must be odd, got {ksize}')
        self.ksize = ksize
        r = ksize // 2
        u = np.arange(-r, r + 1, dtype=np.float64)
        gx_list, gy_list, meta = [], [], []
        for sig_f, deg in zip(sigmas, degrees):
            sig = max(sig_f * seeing_sigma, 0.5)
            g = np.exp(-u * u / (2 * sig * sig))
            for p in range(deg + 1):
                for q in range(deg + 1 - p):
                    gx_list.append(g * (u / sig) ** p)
                    gy_list.append(g * (u / sig) ** q)
                    meta.append((sig, p, q))
        gx = np.stack(gx_list)
        gy = np.stack(gy_list)
        b0 = np.outer(gy[0], gx[0])
        self.b0_2d = (b0 / b0.sum()).astype(np.float32)
        sums = np.einsum('nk,nl->n', gy, gx)
        self.gx = gx.astype(np.float32)
        self.gy = gy.astype(np.float32)
        self.sums = sums.astype(np.float32)
        self.nbasis = gx.shape[0]
        self.meta = meta


def synth_inputs(B, H, W, cfg, seed=0):
    """Synthetic batched pipeline inputs (stars pasted as stamps), the
    numpy-only twin of ``__graft_entry__._synth_inputs``: the same seed
    gives byte-identical arrays. Returns the 14-tuple in INPUT_NAMES order.
    """
    rng = np.random.default_rng(seed)
    k = 25
    r = k // 2
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]

    def frame(sigma, nstars, star_xy=None, fluxes=None):
        img = np.full((H, W), 150.0, dtype='f4')
        psf = np.exp(-(xx ** 2 + yy ** 2) / (2 * sigma ** 2)) \
            / (2 * np.pi * sigma ** 2)
        if star_xy is None:
            star_xy = np.stack([rng.integers(r + 5, W - r - 5, nstars),
                                rng.integers(r + 5, H - r - 5, nstars)], 1)
            fluxes = rng.uniform(5000, 50000, nstars)
        for (x, y), f in zip(star_xy, fluxes):
            img[y - r:y + r + 1, x - r:x + r + 1] += (f * psf).astype('f4')
        img += rng.normal(0, 5.0, (H, W)).astype('f4')
        return img, star_xy, fluxes

    scis, refs, sxs, sys_, svs = [], [], [], [], []
    nstars = max(cfg.smax + 64, (H * W) // 20000)
    for _ in range(B):
        ref, xy, fl = frame(1.4, nstars)
        sci, _, _ = frame(2.0, nstars, xy, fl)
        scis.append(sci)
        refs.append(ref)
        order = np.argsort(fl)[::-1][:cfg.smax]
        sx = np.zeros(cfg.smax, 'f4')
        sy = np.zeros(cfg.smax, 'f4')
        sv = np.zeros(cfg.smax, bool)
        sx[:len(order)] = xy[order, 0]
        sy[:len(order)] = xy[order, 1]
        sv[:len(order)] = True
        sxs.append(sx)
        sys_.append(sy)
        svs.append(sv)

    step = cfg.map_step
    ny = (H - 1) // step + 2
    nx = (W - 1) // step + 2
    gu = np.broadcast_to((np.arange(nx, dtype='f4') * step)[None, :],
                         (ny, nx))
    gv = np.broadcast_to((np.arange(ny, dtype='f4') * step)[:, None],
                         (ny, nx))
    basis = KernelBasis(cfg.ksize, seeing_sigma=2.0 / 2.355)

    def rep(a):
        return np.broadcast_to(a, (B,) + a.shape).copy()

    covb = np.asarray([SUPPORT - 1, W - SUPPORT,
                       SUPPORT - 1, H - SUPPORT], 'f4')
    return (
        np.stack(scis), np.zeros((B, H, W), 'i4'), np.stack(refs),
        np.zeros((B, H, W), 'i4'), rep(np.asarray(gu)), rep(np.asarray(gv)),
        np.stack(sxs), np.stack(sys_), np.stack(svs),
        rep(basis.gx), rep(basis.gy), rep(basis.sums), rep(basis.b0_2d),
        rep(covb),
    )


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a, dtype=dtype), device=device)


def to_torch(args, device=None):
    """Move pipeline state onto ``device`` as the port's tensors.

    ``args`` is either the 14-tuple of INPUT_NAMES (numpy or JAX arrays):
    masks become int32, ``stamp_valid`` bool, everything else float32; or
    one float array (e.g. fitted ``coeffs`` from a JAX ``fit_kernel`` run),
    which becomes float32.

    ``device=None`` means the CUDA card and raises where there is none; a
    caller that wants the CPU says ``'cpu'``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('to_torch: no CUDA card; pass device="cpu" '
                               'to run on the CPU')
        device = 'cuda'
    if isinstance(args, (tuple, list)):
        if len(args) != len(INPUT_NAMES):
            raise ValueError(f'expected {len(INPUT_NAMES)} inputs '
                             f'{INPUT_NAMES}, got {len(args)}')
        out = []
        for i, a in enumerate(args):
            dtype = (np.int32 if i in _MASK_SLOTS
                     else bool if i in _BOOL_SLOTS else np.float32)
            out.append(_tensor(a, dtype, device))
        return tuple(out)
    return _tensor(args, np.float32, device)


def plant_sources(args, n=3, flux=2e4, sigma=2.0, margin=40, seed=0):
    """Add ``n`` Gaussian point sources of total ``flux`` to the science
    frames of ``args`` (the synth_inputs tuple) at sub-pixel positions
    where the reference frame holds no star: the transients a
    subtraction must find. Returns (new args, positions (B, n, 2) as x, y).
    """
    rng = np.random.default_rng(seed)
    sci, ref = args[0].copy(), args[2]
    B, H, W = sci.shape
    r = 12
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    pos = np.zeros((B, n, 2))
    for b in range(B):
        placed = 0
        while placed < n:
            x = rng.uniform(margin, W - margin)
            y = rng.uniform(margin, H - margin)
            ix, iy = int(round(x)), int(round(y))
            box = ref[b, iy - 15:iy + 16, ix - 15:ix + 16]
            near = np.hypot(*(pos[b, :placed] - (x, y)).T)
            if np.abs(box - 150.0).max() > 30.0 or (near < 30).any():
                continue
            psf = np.exp(-((xx + ix - x) ** 2 + (yy + iy - y) ** 2)
                         / (2 * sigma ** 2)) / (2 * np.pi * sigma ** 2)
            sci[b, iy - r:iy + r + 1, ix - r:ix + r + 1] += \
                (flux * psf).astype('f4')
            pos[b, placed] = x, y
            placed += 1
    return (sci,) + tuple(args[1:]), pos
