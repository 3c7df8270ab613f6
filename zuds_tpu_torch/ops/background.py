"""Background / RMS mesh (twin of ``zuds_tpu/ops/background.py``).

The per-cell statistics run in hand kernel H2 (``kernels/background.cu``)
on a CUDA tensor and in :func:`background_cells_plain` on a CPU tensor;
the small tail (empty-cell fill, 3x3 mesh median, bilinear upsample) is
plain PyTorch on either device. The whole-frame bisection median runs in
hand kernel H8 (``kernels/median.cu``) on a CUDA tensor and in
:func:`frame_median_plain` on a CPU tensor.
"""
from __future__ import annotations

import torch

from ..kernels import launch
from .ordered import fma, sum_last

__all__ = ['masked_median', 'bisect_median', 'frame_median',
           'frame_median_plain', 'median_filter_mesh', 'interpolate_mesh',
           'background_cells_plain', 'background_mesh']


def masked_median(x, valid, dim=-1):
    """Exact median over ``dim`` counting only ``valid`` entries; an even
    count averages the two middle values (background.py:32)."""
    big = torch.tensor(float('inf'), dtype=x.dtype, device=x.device)
    xs = torch.sort(torch.where(valid, x, big), dim=dim).values
    cnt = valid.sum(dim=dim, keepdim=True)
    n = x.shape[dim]
    lo = torch.clamp(torch.div(cnt - 1, 2, rounding_mode='floor'), 0, n - 1)
    hi = torch.clamp(torch.div(cnt, 2, rounding_mode='floor'), 0, n - 1)
    med = 0.5 * (torch.gather(xs, dim, lo) + torch.gather(xs, dim, hi))
    return med.squeeze(dim)


def bisect_median(x, valid, iters=12):
    """Approximate masked median over the last axis by ``iters`` value-space
    bisection steps (background.py:48). Approximate by design: never a
    stand-in for ``torch.median``."""
    inf = torch.tensor(float('inf'), dtype=x.dtype, device=x.device)
    lo = torch.where(valid, x, inf).amin(-1)
    hi = torch.where(valid, x, -inf).amax(-1)
    half = valid.sum(-1).to(x.dtype) * 0.5
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt = (valid & (x <= mid[..., None])).sum(-1)
        go_up = cnt.to(x.dtype) < half
        lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
    return 0.5 * (lo + hi)


def frame_median_plain(x, ok=None, center=None, iters=12):
    """Plain version of H8: ``bisect_median`` of the whole 2-D (sub)frame
    ``x`` as one row, over the ``ok`` entries (None: all), of
    ``|x - center|`` when the 0-d ``center`` is given."""
    if center is not None:
        x = (x - center).abs()
    if ok is None:
        ok = torch.ones_like(x, dtype=torch.bool)
    return bisect_median(x.reshape(1, -1), ok.reshape(1, -1), iters)[0]


def frame_median(x, ok=None, center=None, iters=12):
    """0-d bisection median of one whole 2-D (sub)frame, as the reference
    takes it with ``bisect_median(x.ravel()[None], ok.ravel()[None])[0]``
    (measure.py:39-43, pipeline.py:198-209, :338-350): H8 on a CUDA tensor
    (strided views read in place), :func:`frame_median_plain` on a CPU
    tensor. The host does not wait for the card."""
    if x.is_cuda:
        return launch.frame_median(x, ok, center, iters)
    return frame_median_plain(x, ok, center, iters)


def median_filter_mesh(mesh, size=3):
    """size x size median filter with edge replication (background.py:72)."""
    if size <= 1:
        return mesh
    r = size // 2
    H, W = mesh.shape
    padded = torch.nn.functional.pad(mesh[None, None], (r, r, r, r),
                                     mode='replicate')[0, 0]
    stack = torch.stack([padded[dy:dy + H, dx:dx + W]
                         for dy in range(size) for dx in range(size)], -1)
    return masked_median(stack, torch.ones_like(stack, dtype=torch.bool))


def interpolate_mesh(mesh, shape, box=128):
    """Bilinear interpolation from cell centres to pixels
    (background.py:85)."""
    H, W = shape
    ncy, ncx = mesh.shape
    dev = mesh.device
    yy = (torch.arange(H, dtype=torch.float32, device=dev)
          - (box - 1) / 2.0) / box
    xx = (torch.arange(W, dtype=torch.float32, device=dev)
          - (box - 1) / 2.0) / box
    if ncy > 1:
        y0 = torch.clamp(torch.floor(yy).to(torch.int64), 0, ncy - 2)
        fy = torch.clamp(yy - y0, 0.0, 1.0)[:, None]
    else:
        y0 = torch.zeros(H, dtype=torch.int64, device=dev)
        fy = torch.zeros((H, 1), device=dev)
    if ncx > 1:
        x0 = torch.clamp(torch.floor(xx).to(torch.int64), 0, ncx - 2)
        fx = torch.clamp(xx - x0, 0.0, 1.0)[None, :]
    else:
        x0 = torch.zeros(W, dtype=torch.int64, device=dev)
        fx = torch.zeros((1, W), device=dev)
    y1 = torch.clamp(y0 + 1, max=ncy - 1)
    x1 = torch.clamp(x0 + 1, max=ncx - 1)
    top, bot = mesh[y0], mesh[y1]
    g00, g01 = top[:, x0], top[:, x1]
    g10, g11 = bot[:, x0], bot[:, x1]
    return (g00 * (1 - fy) * (1 - fx) + g01 * (1 - fy) * fx
            + g10 * fy * (1 - fx) + g11 * fy * fx)


def _moments(data, keep):
    """stats() of background.py:138-144: the one-pass f32 variance
    ``s2/n - mean^2`` (one rounding, as the reference evaluates it), its
    sums added in the reference's order (see :mod:`.ordered`), as H2
    adds them."""
    n = torch.clamp(keep.sum(-1), min=1)
    s = sum_last(torch.where(keep, data, 0.0))
    s2 = sum_last(torch.where(keep, data * data, 0.0))
    mean = s / n
    var = torch.clamp(fma(-mean, mean, s2 / n), min=0.0)
    return mean, torch.sqrt(var), n


def background_cells_plain(img, valid, box=128, iters=3):
    """Plain version of H2: per-cell (back, sigma, n), each (ncy, ncx)
    (background.py:121-196)."""
    H, W = img.shape
    pad_y, pad_x = (-H) % box, (-W) % box
    imgp = torch.nn.functional.pad(img, (0, pad_x, 0, pad_y))
    vp = torch.nn.functional.pad(valid, (0, pad_x, 0, pad_y))
    ncy, ncx = imgp.shape[0] // box, imgp.shape[1] // box

    def to_cells(a):
        return a.reshape(ncy, box, ncx, box).permute(0, 2, 1, 3).reshape(
            ncy, ncx, box * box)

    cells = to_cells(imgp)
    vcells = to_cells(vp) & torch.isfinite(cells)
    cells = torch.where(vcells, cells, 0.0)

    sstep = 5 if box * box >= 4096 else 1
    sub = cells[..., ::sstep]
    vsub = vcells[..., ::sstep]
    subempty = vsub.sum(-1) == 0

    keeps = vsub
    for _ in range(iters):
        med = bisect_median(sub, keeps)
        _, sigma, _ = _moments(sub, keeps)
        lo = (med - 3.0 * sigma)[..., None]
        hi = (med + 3.0 * sigma)[..., None]
        keeps = vsub & (sub >= lo) & (sub <= hi)
    med_s = bisect_median(sub, keeps)
    _, sigma_s, _ = _moments(sub, keeps)
    inf = torch.tensor(float('inf'), device=img.device)
    lo = torch.where(subempty, -inf, med_s - 3.0 * sigma_s)[..., None]
    hi = torch.where(subempty, inf, med_s + 3.0 * sigma_s)[..., None]
    keep = vcells & (cells >= lo) & (cells <= hi)
    mean, sigma, n = _moments(cells, keep)
    med = bisect_median(cells, keep)
    _, sigma0, _ = _moments(cells, vcells)
    uncrowded = subempty | ((sigma - sigma0).abs() < 0.2 * torch.where(
        sigma0 == 0, torch.ones_like(sigma0), sigma0))
    back = torch.where(uncrowded, mean, 2.5 * med - 1.5 * mean)
    return back, sigma, n.to(torch.int32)


def background_mesh(img, valid=None, box=128, filter_size=3, iters=3):
    """Background and noise maps of one frame (background.py:108).

    Returns dict with ``back`` and ``rms`` (H, W) and the filtered meshes
    ``back_mesh``/``rms_mesh`` (ncy, ncx)."""
    H, W = img.shape
    if valid is None:
        valid = torch.ones_like(img, dtype=torch.bool)
    if img.is_cuda:
        back, sigma, n = launch.background_cells(img, valid, box, iters)
    else:
        back, sigma, n = background_cells_plain(img, valid, box, iters)

    good_cell = n > box
    ok = good_cell.any()
    gback = masked_median(back.reshape(-1), good_cell.reshape(-1), dim=0)
    grms = masked_median(sigma.reshape(-1), good_cell.reshape(-1), dim=0)
    zero = torch.zeros((), device=img.device)
    back = torch.where(good_cell, back, torch.where(ok, gback, zero))
    sigma = torch.where(good_cell, sigma, torch.where(ok, grms, zero))

    back_mesh = median_filter_mesh(back, filter_size)
    rms_mesh = median_filter_mesh(sigma, filter_size)
    return {
        'back': interpolate_mesh(back_mesh, (H, W), box),
        'rms': interpolate_mesh(rms_mesh, (H, W), box),
        'back_mesh': back_mesh,
        'rms_mesh': rms_mesh,
    }
