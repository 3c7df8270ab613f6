"""Python wrappers of the CUDA C++ kernels (H1 warp, H2 background cells,
H3 model convolution, H4 matched filter (and H4g, its general filter), H5
deblend level labels, H6 compaction, H7 stamp candidates, H8 frame median,
H9 clipped combine, H10 gather warp, H11 subtraction epilogue, H12 triplet
cutter, H13 braai convolution layer, H14 negative-pixel veto, H15 ZOGY
spectral pass, H16 ZOGY score normalisation, H17 PSF star stamps, H18 PSF
clipped mean, H13t the braai layer's training forward, H19 its input
gradient, H20 its weight gradient, H21 the fused Adam step, H22 aperture
photometry and its two-plane sums, H23 the windowed and Kron refinement,
H24 the label seeds, H25 the base components, H26 the per-object
statistics, H27 CLEAN, H28 the separable warp).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises
if the launch reported an error, and adds one to its ``launches`` count.
Nothing here synchronises.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import build

__all__ = ['warp', 'warp_sep', 'background_cells', 'apply_model',
           'apply_model_variance',
           'detect_filter', 'detect_filter_taps', 'deblend_labels',
           'compact', 'stamp_candidates', 'frame_median', 'clipped_combine',
           'warp_gather', 'subtract_epilogue', 'triplet_cut', 'negpix_veto',
           'braai_conv3x3', 'zogy_spectral', 'zogy_normalize', 'psf_stamps',
           'psf_clip', 'braai_conv3x3_train', 'braai_conv3x3_dgrad',
           'braai_conv3x3_wgrad', 'braai_backward_resources', 'adam_step',
           'aperture_photometry',
           'aperture_sums', 'refine_detections', 'seed_sweeps',
           'ccl_fixpoint', 'object_stats', 'clean', 'BRAAI_LAYERS',
           'COMBINE_MAX_EPOCHS', 'WRAPPERS']


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    """PyTorch's current stream on the current device, as a pointer (an
    int: the wrappers' stream argument is a void pointer)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def _require(name, t, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    if t.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')


def _dense(t):
    """Whether ``t``'s elements fill ``t.numel()`` consecutive slots from
    its data pointer, in any order of its dimensions."""
    step = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda p: p[1]):
        if size == 1:
            continue
        if stride != step:
            return False
        step *= size
    return True


def warp(ref, mask, u, v, covb, window, ref2=None):
    """H1 (kernels/warp.cu): (refw f32, refm i32, cov f32), each (H, W).
    With a second float plane ``ref2`` (H, W), warped with the taps and
    weights of the first in the same launch: (refw, refw2, refm, cov)."""
    H, W = ref.shape
    _require('ref', ref, torch.float32)
    _require('ref_mask', mask, torch.int32, (H, W))
    _require('u', u, torch.float32, (H, W))
    _require('v', v, torch.float32, (H, W))
    _require('cov_bounds', covb, torch.float32, (4,))
    refw = torch.empty_like(ref)
    refm = torch.empty_like(mask)
    cov = torch.empty_like(ref)
    null = ctypes.c_void_p(None)
    refw2 = None
    if ref2 is not None:
        _require('ref2', ref2, torch.float32, (H, W))
        refw2 = torch.empty_like(ref2)
    err = build.library().zuds_warp(
        _ptr(ref), null if ref2 is None else _ptr(ref2), _ptr(mask), _ptr(u),
        _ptr(v), _ptr(covb), _ptr(refw),
        null if ref2 is None else _ptr(refw2), _ptr(refm), _ptr(cov), H, W,
        int(window), _stream())
    build.check(err, 'zuds_warp')
    warp.launches += 1
    if ref2 is None:
        return refw, refm, cov
    return refw, refw2, refm, cov


# H28's largest window: window + 3 halo rows each side of a block's 32
# rows, five planes of 32 columns (28 bytes a pixel), under 48 KB of shared
# memory (warp.cu)
WARP_SEP_MAX_WINDOW = 8


def warp_sep(ref, mask, u, v, covb, window, order=1):
    """H28 (kernels/warp.cu): the separable warp of ``ref`` with its
    ``order``-th cross-term correction (0 or 1), the mask warp and the
    coverage gate: (refw f32, refm i32, cov f32), each (H, W)."""
    H, W = ref.shape
    _require('ref', ref, torch.float32)
    _require('ref_mask', mask, torch.int32, (H, W))
    _require('u', u, torch.float32, (H, W))
    _require('v', v, torch.float32, (H, W))
    _require('cov_bounds', covb, torch.float32, (4,))
    if not 0 <= int(window) <= WARP_SEP_MAX_WINDOW or order not in (0, 1):
        raise ValueError(f'warp_sep: window {window} (at most '
                         f'{WARP_SEP_MAX_WINDOW}) or order {order} (0 or 1) '
                         'not taken')
    refw = torch.empty_like(ref)
    refm = torch.empty_like(mask)
    cov = torch.empty_like(ref)
    if H * W == 0:
        return refw, refm, cov
    err = build.library().zuds_warp_sep(
        _ptr(ref), _ptr(mask), _ptr(u), _ptr(v), _ptr(covb), _ptr(refw),
        _ptr(refm), _ptr(cov), H, W, int(window), int(order), _stream())
    build.check(err, 'zuds_warp_sep')
    warp_sep.launches += 1
    return refw, refm, cov


def background_cells(img, valid, box, iters):
    """H2 (kernels/background.cu): per-cell clipped background, sigma and
    kept-pixel count, each (ncy, ncx); cells past the frame edge are padded
    invalid."""
    H, W = img.shape
    _require('img', img, torch.float32)
    _require('valid', valid, torch.bool, (H, W))
    if box * box % 512 != 0 or box * box > 512 * 32:
        raise ValueError(f'background_cells: box={box} unsupported '
                         '(box^2 must be a multiple of 512, at most 16384)')
    ncy, ncx = -(-H // box), -(-W // box)
    back = torch.empty((ncy, ncx), dtype=torch.float32, device=img.device)
    sigma = torch.empty_like(back)
    n = torch.empty((ncy, ncx), dtype=torch.int32, device=img.device)
    err = build.library().zuds_background_cells(
        _ptr(img), _ptr(valid), _ptr(back), _ptr(sigma), _ptr(n), H, W,
        int(box), int(iters), _stream())
    build.check(err, 'zuds_background_cells')
    background_cells.launches += 1
    return back, sigma, n


def _apply_params(H, W, K, Nm, cx, cy, pexp, qexp, wx, wy):
    """H3's by-value parameters (``build.ApplyParams``)."""
    nreg = len(cx)
    # c_float fields round the centres and half-widths to f32 as the
    # reference does
    params = build.ApplyParams(H=H, W=W, K=K, Nm=Nm, nreg=nreg, wx=wx, wy=wy)
    params.cx[:nreg], params.cy[:nreg] = cx, cy
    params.pexp[:Nm], params.qexp[:Nm] = pexp, qexp
    return params


def _launch_apply(ref, kd, bg, cx, cy, pexp, qexp, wx, wy):
    """Check and launch ``zuds_apply`` (H3); the two wrappers below count
    their own launches."""
    H, W = ref.shape
    R2, Nm, K, _ = kd.shape
    nreg = len(cx)
    if len(cy) != nreg or len(pexp) != Nm or len(qexp) != Nm:
        raise ValueError('apply_model: cx, cy need nreg values and pexp, '
                         'qexp Nm values')
    if K % 2 != 1 or K > 31:
        raise ValueError(f'apply_model: K={K} unsupported (odd K <= 31)')
    if nreg > build.APPLY_MAX_REG or Nm > build.APPLY_MAX_TERMS:
        raise ValueError(f'apply_model: nreg={nreg}, Nm={Nm} unsupported '
                         f'(at most {build.APPLY_MAX_REG} each)')
    _require('ref', ref, torch.float32)
    _require('kd', kd, torch.float32, (nreg * nreg, Nm, K, K))
    _require('bg', bg, torch.float32, (R2,))
    params = _apply_params(H, W, K, Nm, cx, cy, pexp, qexp, wx, wy)
    model = torch.empty_like(ref)
    err = build.library().zuds_apply(_ptr(ref), _ptr(kd), _ptr(bg),
                                     _ptr(model), ctypes.byref(params),
                                     _stream())
    build.check(err, 'zuds_apply')
    return model


def apply_model(ref, kd, bg, cx, cy, pexp, qexp, wx, wy):
    """H3 (kernels/apply.cu): the spatially varying model convolution
    ``bg[r] + sum_m T_m(xn, yn) (kd[r, m] * ref)`` with zero padding, on the
    tensor cores in 3xTF32; at one term (Nm = 1, the pair's order-0 model)
    as a direct fp32 correlation.

    kd (R2, Nm, K, K) f32 and bg (R2,) f32 on the card; the rest are host
    values passed by value in the launch (no copy to the card): cx (nreg,)
    the region centre of each region column and cy (nreg,) of each region
    row, both as the reference rounds them to f32; pexp/qexp (Nm,) the
    term exponents; wx, wy the half-widths. Takes any odd K up to 31 (the
    kernels of a region must fit in shared memory), nreg and Nm up to 256.
    """
    model = _launch_apply(ref, kd, bg, cx, cy, pexp, qexp, wx, wy)
    apply_model.launches += 1
    return model


def apply_model_variance(var, k2, cx, cy, wx, wy):
    """H3 at one term (kernels/apply.cu): the variance frame ``var`` (H, W)
    correlated, zero padded, with the squared centre kernel ``k2[r]`` (R2,
    K, K) of its static region: the reference's ``propagate_ref_var``. The
    single term is the constant one and the background is 0, so the launch
    computes ``k2[r] * var`` over the same region rectangles as the model,
    as H3's direct fp32 correlation. ``cx``, ``cy``, ``wx``, ``wy`` as in
    :func:`apply_model`."""
    R2, K, _ = k2.shape
    out = _launch_apply(var, k2.reshape(R2, 1, K, K),
                        torch.zeros(R2, dtype=torch.float32,
                                    device=var.device),
                        cx, cy, (0,), (0,), wx, wy)
    apply_model_variance.launches += 1
    return out


def deblend_labels(e_src, e_dst, e_w, ccap, nlev, max_rounds, nedge):
    """H5 (kernels/deblend.cu): the deblend tree's (nlev, ccap) int32 level
    labels over the cross-cell edge list ``e_src``/``e_dst``/``e_w`` (int64,
    (ecap,), cells in [0, ccap)), at most ``max_rounds`` rounds per level.
    ``nedge`` (a 0-d int64 tensor on the card): the slots from it on are
    padding (e_w <= 0, as ``ops.deblend.cell_graph`` pads them) and are
    not read."""
    ecap = e_src.shape[0] if e_src.dim() == 1 else -1
    _require('e_src', e_src, torch.int64, (ecap,))
    _require('e_dst', e_dst, torch.int64, (ecap,))
    _require('e_w', e_w, torch.int64, (ecap,))
    _require('nedge', nedge, torch.int64, ())
    if not 0 < ccap <= DEBLEND_MAX_CELLS or nlev < 1 or ecap >= 2 ** 31:
        raise ValueError(f'deblend_labels: ccap={ccap}, nlev={nlev}, '
                         f'ecap={ecap} unsupported (1..{DEBLEND_MAX_CELLS} '
                         'cells, at least one level, under 2^31 slots)')
    bl = torch.empty((nlev, ccap), dtype=torch.int32, device=e_src.device)
    err = build.library().zuds_deblend_labels(
        _ptr(e_src), _ptr(e_dst), _ptr(e_w), _ptr(nedge), ecap,
        int(ccap), int(nlev), int(max_rounds), _ptr(bl), _stream())
    build.check(err, 'zuds_deblend_labels')
    deblend_labels.launches += 1
    return bl


# entries of H6's smallest tile (compact.cu: 256 threads x one uint4)
COMPACT_TILE = 4096


def compact(mask, size, fill_value):
    """H6 (kernels/compact.cu): (int64 (size,) flat indices of the first
    ``size`` True entries of the flat bool ``mask``, ascending, padded with
    ``fill_value``; int64 () count of True entries), both on the card. Two
    launches (count, write); ``mask`` may start at any byte."""
    _require('mask', mask, torch.bool)
    n = mask.numel()
    if mask.dim() != 1 or n >= 2 ** 31 or size < 0:
        raise ValueError(f'compact: expected a 1-D mask under 2^31 entries '
                         f'and size >= 0, got {tuple(mask.shape)}, {size}')
    # one allocation, the pointers passed as ints (the call's host cost is
    # several times the kernels' device time): the indices, the count, and
    # one int32 count a tile
    tiles = max(1, -(-n // COMPACT_TILE))
    buf = torch.empty(size + 1 + (tiles + 1) // 2, dtype=torch.int64,
                      device=mask.device)
    p = buf.data_ptr()
    err = build.library().zuds_compact(
        mask.data_ptr(), n, int(size), int(fill_value), p + 8 * (size + 1),
        p, p + 8 * size, _stream())
    build.check(err, 'zuds_compact')
    compact.launches += 1
    return buf[:size], buf[size]


def detect_filter(diff, rms, weight_ok, nsigma):
    """H4 (kernels/detect_filter.cu): (img f32, filt f32, det bool), each
    (H, W): the good-pixel mask of ``diff``/``rms`` (f32) and ``weight_ok``
    (bool), the masked image, its 3x3 pyramid filter and the ``nsigma``
    threshold. Views at any element offset are taken (a batch's frame);
    W % 4 == 0 and 16-byte aligned planes take the kernel's 4-column form."""
    H, W = diff.shape
    _require('diff', diff, torch.float32)
    _require('rms', rms, torch.float32, (H, W))
    _require('weight_ok', weight_ok, torch.bool, (H, W))
    if H * W >= 2 ** 31:
        raise ValueError('detect_filter: frame too large for int32 offsets')
    img = torch.empty((H, W), dtype=torch.float32, device=diff.device)
    filt = torch.empty_like(img)
    det = torch.empty((H, W), dtype=torch.bool, device=diff.device)
    if H * W == 0:
        return img, filt, det
    err = build.library().zuds_detect_filter(
        diff.data_ptr(), rms.data_ptr(), weight_ok.data_ptr(), H, W,
        float(nsigma), img.data_ptr(), filt.data_ptr(), det.data_ptr(),
        _stream())
    build.check(err, 'zuds_detect_filter')
    detect_filter.launches += 1
    return img, filt, det


def detect_filter_taps(diff, rms, weight_ok, nsigma, kernel):
    """H4g (kernels/detect_filter.cu): :func:`detect_filter` with the
    filter ``kernel`` (a (kh, kw) float array of at most 49 taps) in place
    of the pyramid, correlated with the zero-padded image (``kh // 2`` rows
    above, ``kw // 2`` columns left), its zero taps skipped: (img f32,
    filt f32, det bool), each (H, W)."""
    H, W = diff.shape
    _require('diff', diff, torch.float32)
    _require('rms', rms, torch.float32, (H, W))
    _require('weight_ok', weight_ok, torch.bool, (H, W))
    k = np.asarray(kernel, dtype=np.float32)
    if k.ndim != 2 or not 0 < k.size <= build.FILTER_MAX_TAPS:
        raise ValueError(f'detect_filter_taps: a filter of shape {k.shape} '
                         f'(at most {build.FILTER_MAX_TAPS} taps)')
    if H * W >= 2 ** 31:
        raise ValueError('detect_filter_taps: frame too large for int32 '
                         'offsets')
    taps = build.FilterTaps(kh=k.shape[0], kw=k.shape[1])
    live = np.argwhere(k != 0)
    taps.n = len(live)
    for i, (dy, dx) in enumerate(live):
        taps.dy[i], taps.dx[i], taps.w[i] = int(dy), int(dx), float(k[dy, dx])
    img = torch.empty((H, W), dtype=torch.float32, device=diff.device)
    filt = torch.empty_like(img)
    det = torch.empty((H, W), dtype=torch.bool, device=diff.device)
    if H * W == 0:
        return img, filt, det
    err = build.library().zuds_detect_filter_taps(
        diff.data_ptr(), rms.data_ptr(), weight_ok.data_ptr(), H, W,
        float(nsigma), ctypes.byref(taps), img.data_ptr(), filt.data_ptr(),
        det.data_ptr(), _stream())
    build.check(err, 'zuds_detect_filter_taps')
    detect_filter_taps.launches += 1
    return img, filt, det


def stamp_candidates(img, med, sigma, sat, margin):
    """H7 (kernels/stamps.cu): (filt f32, cand bool), each (H, W): the
    stamp-candidate test against the device scalars ``med`` and ``sigma``
    (f32, 0-d), and the 3x3 pyramid filter of ``img`` where ``cand`` is
    set (unwritten elsewhere)."""
    H, W = img.shape
    _require('img', img, torch.float32)
    _require('med', med, torch.float32, ())
    _require('sigma', sigma, torch.float32, ())
    if H * W >= 2 ** 31:
        raise ValueError('stamp_candidates: frame too large for int32 '
                         'offsets')
    filt = torch.empty_like(img)
    cand = torch.empty((H, W), dtype=torch.uint8, device=img.device)
    if H * W == 0:
        return filt, cand.view(torch.bool)
    err = build.library().zuds_stamp_candidates(
        _ptr(img), H, W, _ptr(med), _ptr(sigma), float(sat), int(margin),
        _ptr(filt), _ptr(cand), _stream())
    build.check(err, 'zuds_stamp_candidates')
    stamp_candidates.launches += 1
    return filt, cand.view(torch.bool)


# blocks of H8 (median.cu): its count passes keep 2^6 16-bit buckets for
# each of 256 threads (32 KB of shared memory), so six blocks fill an SM of
# the H100 (a thread then counts under 2^16 values a pass); a smaller view
# takes a block per MEDIAN_PER_BLOCK values, so that a block's loads are
# one round trip (a ::4 view of a quadrant: a row of 768 a block)
MEDIAN_BLOCKS = 6 * 132
MEDIAN_PER_BLOCK = 256 * 2


def frame_median(x, ok=None, center=None, iters=12):
    """H8 (kernels/median.cu): f32 0-d bisection median of the 2-D view
    ``x`` (any strides: a ``::4`` subsample is read in place) over the
    ``ok`` entries (bool, same shape, any strides; None: all), of
    ``|x - center|`` when the 0-d f32 ``center`` is given."""
    _require_view('x', x, torch.float32)
    rows, cols = x.shape
    if ok is not None:
        _require_view('ok', ok, torch.bool, x.shape)
    if center is not None:
        _require('center', center, torch.float32, ())
    if iters < 1 or rows * cols >= 2 ** 31:
        raise ValueError(f'frame_median: iters={iters}, {rows}x{cols} '
                         'unsupported (iters >= 1, under 2^31 entries)')
    nb = max(1, min(MEDIAN_BLOCKS, -(-rows * cols // MEDIAN_PER_BLOCK)))
    lib = build.library()
    scratch = torch.empty(lib.zuds_frame_median_scratch(nb, int(iters)),
                          dtype=torch.uint8, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    null = ctypes.c_void_p(None)
    err = lib.zuds_frame_median(
        _ptr(x), null if ok is None else _ptr(ok),
        null if center is None else _ptr(center), rows, cols, *x.stride(),
        *(ok.stride() if ok is not None else (0, 0)), nb, int(iters),
        _ptr(scratch), _ptr(out), _stream())
    build.check(err, 'zuds_frame_median')
    frame_median.launches += 1
    return out


# H9 (coadd.cu) holds at most this many epochs of a pixel on chip
COMBINE_MAX_EPOCHS = 64


def clipped_combine(imgs, weights, masks, coverage, scales, nsigma,
                    amp_frac, nodata_bit):
    """H9 (kernels/coadd.cu): the CLIPPED combine of the warped stack
    ``imgs``/``weights`` (N, H, W) f32, the AND of ``masks`` (int32) over
    ``coverage`` (bool), and bit ``nodata_bit`` where no epoch contributed.
    ``scales``: (N,) f32 FLXSCALE factors or None. Returns dict ``coadd``,
    ``weight`` (H, W) f32, ``nclip``, ``nexp``, ``mask`` (H, W) int32."""
    _require('imgs', imgs, torch.float32)
    if imgs.dim() != 3 or not 1 <= imgs.shape[0] <= COMBINE_MAX_EPOCHS:
        raise ValueError(f'clipped_combine: expected a stack of 1 to '
                         f'{COMBINE_MAX_EPOCHS} epochs (N, H, W), got '
                         f'{tuple(imgs.shape)}')
    N, H, W = imgs.shape
    _require('weights', weights, torch.float32, (N, H, W))
    _require('masks', masks, torch.int32, (N, H, W))
    _require('coverage', coverage, torch.bool, (N, H, W))
    if scales is not None:
        _require('scales', scales, torch.float32, (N,))
    dev = imgs.device
    coadd = torch.empty((H, W), dtype=torch.float32, device=dev)
    weight = torch.empty_like(coadd)
    nclip = torch.empty((H, W), dtype=torch.int32, device=dev)
    nexp = torch.empty_like(nclip)
    omask = torch.empty_like(nclip)
    err = build.library().zuds_clipped_combine(
        _ptr(imgs), _ptr(weights), _ptr(masks), _ptr(coverage),
        ctypes.c_void_p(None) if scales is None else _ptr(scales),
        _ptr(coadd), _ptr(weight), _ptr(nclip), _ptr(nexp), _ptr(omask), N,
        H * W, float(nsigma), float(amp_frac), int(nodata_bit), _stream())
    build.check(err, 'zuds_clipped_combine')
    clipped_combine.launches += 1
    return {'coadd': coadd, 'weight': weight, 'nclip': nclip, 'nexp': nexp,
            'mask': omask}


def warp_gather(img, mask, u, v, img2=None):
    """H10 (kernels/warp.cu): the Lanczos-3 gather warp of the source
    planes ``img``, ``img2`` (f32, (Hs, Ws); either may be None, ``img2``
    only with ``img``) and ``mask`` (int32, (Hs, Ws), or None) to the
    output grid of ``u``, ``v`` (f32, (Ho, Wo)), in one launch. Returns
    (out, out2, outm, cov): the warped planes and mask (None where the
    input was None) and the coverage (f32, 1 where the 6x6 support lies
    inside the source)."""
    _require('u', u, torch.float32)
    if u.dim() != 2:
        raise ValueError(f'warp_gather: expected 2-D u, got {tuple(u.shape)}')
    Ho, Wo = u.shape
    _require('v', v, torch.float32, (Ho, Wo))
    src = img if img is not None else mask
    if src is None or (img2 is not None and img is None):
        raise ValueError('warp_gather: needs img or mask, and img2 only '
                         'with img')
    if src.dim() != 2 or min(src.shape) < 6 or src.numel() >= 2 ** 31 \
            or Ho * Wo >= 2 ** 31:
        raise ValueError(f'warp_gather: source {tuple(src.shape)} '
                         'unsupported (2-D, at least 6x6, under 2^31 px)')
    Hs, Ws = src.shape
    null = ctypes.c_void_p(None)
    outs = []
    for name, t, dtype in (('img', img, torch.float32),
                           ('img2', img2, torch.float32),
                           ('mask', mask, torch.int32)):
        if t is None:
            outs.append(None)
            continue
        _require(name, t, dtype, (Hs, Ws))
        outs.append(torch.empty((Ho, Wo), dtype=dtype, device=u.device))
    cov = torch.empty((Ho, Wo), dtype=torch.float32, device=u.device)

    def p(t):
        return null if t is None else _ptr(t)

    err = build.library().zuds_warp_gather(
        p(img), p(img2), p(mask), _ptr(u), _ptr(v), p(outs[0]), p(outs[1]),
        p(outs[2]), _ptr(cov), Hs, Ws, Ho, Wo, _stream())
    build.check(err, 'zuds_warp_gather')
    warp_gather.launches += 1
    return outs[0], outs[1], outs[2], cov


def subtract_epilogue(sci, model, sci_rms, ref_var, bad, sentinel, big_rms,
                      submask=None, bit=0, contract=False):
    """H11 (kernels/subtract.cu): ``diff = sci - model`` and ``rms =
    sqrt(sci_rms^2 + ref_var)`` (f32, the shape of ``sci``), with
    ``sentinel`` and ``big_rms`` where ``bad`` (bool) is set; with
    ``submask`` (int32) also ``submask | 1 << bit`` where ``diff`` is the
    sentinel. ``contract``: the square and the add as one FMA. Returns
    (diff, rms) or (diff, rms, submask)."""
    _require('sci', sci, torch.float32)
    for name, t in (('model', model), ('sci_rms', sci_rms),
                    ('ref_var', ref_var)):
        _require(name, t, torch.float32, sci.shape)
    _require('bad', bad, torch.bool, sci.shape)
    diff = torch.empty_like(sci)
    rms = torch.empty_like(sci)
    null = ctypes.c_void_p(None)
    sub_out = None
    if submask is not None:
        _require('submask', submask, torch.int32, sci.shape)
        sub_out = torch.empty_like(submask)
    err = build.library().zuds_subtract_epilogue(
        _ptr(sci), _ptr(model), _ptr(sci_rms), _ptr(ref_var), _ptr(bad),
        null if submask is None else _ptr(submask), _ptr(diff), _ptr(rms),
        null if submask is None else _ptr(sub_out), sci.numel(),
        float(sentinel), float(big_rms), int(bit), int(bool(contract)),
        _stream())
    build.check(err, 'zuds_subtract_epilogue')
    subtract_epilogue.launches += 1
    if submask is None:
        return diff, rms
    return diff, rms, sub_out


def _require_corners(x0, y0, n):
    _require('x0', x0, torch.int32, (n,))
    _require('y0', y0, torch.int32, (n,))


def triplet_cut(new, ref, sub, x0, y0):
    """H12 (kernels/cutouts.cu): the (N, 63, 63, 3) f32 NHWC triplets of
    the 63x63 windows of ``new``, ``ref`` and ``sub`` (f32, one (H, W)
    grid) at the corners ``x0``, ``y0`` (int32 (N,), already clamped to
    the frame), each window divided by its L2 norm (at least 1e-10)."""
    _require('new', new, torch.float32)
    if new.dim() != 2 or min(new.shape) < 63 or new.numel() >= 2 ** 31:
        raise ValueError(f'triplet_cut: expected a 2-D frame of at least '
                         f'63x63 under 2^31 px, got {tuple(new.shape)}')
    _require('ref', ref, torch.float32, new.shape)
    _require('sub', sub, torch.float32, new.shape)
    n = x0.shape[0] if x0.dim() == 1 else -1
    _require_corners(x0, y0, n)
    out = torch.empty((n, 63, 63, 3), dtype=torch.float32, device=new.device)
    err = build.library().zuds_triplet_cut(
        _ptr(new), _ptr(ref), _ptr(sub), _ptr(x0), _ptr(y0), n,
        new.shape[1], _ptr(out), _stream())
    build.check(err, 'zuds_triplet_cut')
    triplet_cut.launches += 1
    return out


def negpix_veto(img, med, sig, x0, y0):
    """H14 (kernels/cutouts.cu): bool (N,), True where the 13x13 window of
    ``img`` (f32 (H, W)) at the corner ``x0``, ``y0`` (int32 (N,), already
    clamped), standardised by the device scalars ``med`` and ``sig`` (f32,
    0-d; ``sig`` floored at 1e-12), holds a pixel below -5 in its central
    11x11 whose 3x3 neighbourhood reaches above +5."""
    _require('img', img, torch.float32)
    if img.dim() != 2 or min(img.shape) < 13 or img.numel() >= 2 ** 31:
        raise ValueError(f'negpix_veto: expected a 2-D frame of at least '
                         f'13x13 under 2^31 px, got {tuple(img.shape)}')
    _require('med', med, torch.float32, ())
    _require('sig', sig, torch.float32, ())
    n = x0.shape[0] if x0.dim() == 1 else -1
    _require_corners(x0, y0, n)
    veto = torch.empty(n, dtype=torch.uint8, device=img.device)
    err = build.library().zuds_negpix_veto(
        _ptr(img), img.shape[1], _ptr(med), _ptr(sig), _ptr(x0), _ptr(y0), n,
        _ptr(veto), _stream())
    build.check(err, 'zuds_negpix_veto')
    negpix_veto.launches += 1
    return veto.view(torch.bool)


def _require_positions(xs, ys):
    n = xs.shape[0] if xs.dim() == 1 else -1
    _require('xs', xs, torch.float32, (n,))
    _require('ys', ys, torch.float32, (n,))
    return n


def _require_frame(name, img, cut):
    _require(name, img, torch.float32)
    if img.dim() != 2 or min(img.shape) < cut or img.numel() >= 2 ** 31:
        raise ValueError(f'{name}: expected a 2-D frame of at least '
                         f'{cut}x{cut} under 2^31 px, got {tuple(img.shape)}')


def aperture_photometry(img, rms, mask, xs, ys, r, cut, weights=False):
    """H22 (kernels/photometry.cu): the circular apertures of radius ``r``
    at the f32 positions ``xs``, ``ys`` (N,) on ``img`` (f32 (H, W)), each
    from the ``cut`` x ``cut`` window at its clamped rounded corner; ``rms``
    (f32) and ``mask`` (int32) of the frame's shape, or None for zeros.
    Returns a dict of (N,) ``flux``, ``fluxerr``, ``area`` (f32), ``flags``
    (int32: the OR of ``mask & 0x3FFFF`` under the aperture) and ``oob``
    (bool); with ``weights`` also ``w``, the (N, cut, cut) overlaps."""
    _require_frame('img', img, cut)
    if rms is not None:
        _require('rms', rms, torch.float32, img.shape)
    if mask is not None:
        _require('mask', mask, torch.int32, img.shape)
    n = _require_positions(xs, ys)
    dev = img.device
    flux = torch.empty(n, dtype=torch.float32, device=dev)
    out = {'flux': flux, 'fluxerr': torch.empty_like(flux),
           'area': torch.empty_like(flux),
           'flags': torch.empty(n, dtype=torch.int32, device=dev),
           'oob': torch.empty(n, dtype=torch.uint8, device=dev)}
    if weights:
        out['w'] = torch.empty((n, cut, cut), dtype=torch.float32, device=dev)
    if n:
        null = ctypes.c_void_p(None)
        err = build.library().zuds_aperture_photometry(
            _ptr(img), null if rms is None else _ptr(rms),
            null if mask is None else _ptr(mask), _ptr(xs), _ptr(ys), n,
            img.shape[0], img.shape[1], float(r), int(cut), _ptr(flux),
            _ptr(out['fluxerr']), _ptr(out['area']), _ptr(out['flags']),
            _ptr(out['oob']), _ptr(out['w']) if weights else null, _stream())
        build.check(err, 'zuds_aperture_photometry')
        aperture_photometry.launches += 1
    out['oob'] = out['oob'].view(torch.bool)
    return out


def aperture_sums(a, b, xs, ys, r, cut):
    """H22's second mode (kernels/photometry.cu): (sum a w, sum b w), each
    (N,) f32, over the circular apertures of radius ``r`` at ``xs``, ``ys``
    on the two f32 planes ``a`` and ``b`` of one (H, W) shape."""
    _require_frame('a', a, cut)
    _require('b', b, torch.float32, a.shape)
    n = _require_positions(xs, ys)
    sa = torch.empty(n, dtype=torch.float32, device=a.device)
    sb = torch.empty_like(sa)
    if n:
        err = build.library().zuds_aperture_sums(
            _ptr(a), _ptr(b), _ptr(xs), _ptr(ys), n, a.shape[0], a.shape[1],
            float(r), int(cut), _ptr(sa), _ptr(sb), _stream())
        build.check(err, 'zuds_aperture_sums')
        aperture_sums.launches += 1
    return sa, sb


# refine_detections' outputs, in the order of kernels/measure.cu (and of
# the pipeline's det_* columns)
REFINE_KEYS = ('xwin', 'ywin', 'kron_radius', 'flux_auto', 'fluxerr_auto',
               'awin', 'bwin', 'thetawin', 'errawin', 'errbwin',
               'errthetawin')
# measure.cu's largest window: its three cut^2 tiles (img, rms, r_ell) in
# 73 KB of shared memory
REFINE_MAX_CUT = 78


def refine_detections(img, rms, xs, ys, a, b, theta, fwhm, cut):
    """H23 (kernels/measure.cu): the windowed centroids, shapes and their
    errors, the Kron radius and the AUTO flux at the (N,) f32 detections
    ``xs``, ``ys``, ``a``, ``b``, ``theta``, ``fwhm`` on ``img`` and ``rms``
    (f32 (H, W)), from the ``cut`` x ``cut`` windows at their clamped
    rounded corners. Returns a dict of REFINE_KEYS -> (N,) f32."""
    _require_frame('img', img, cut)
    _require('rms', rms, torch.float32, img.shape)
    if cut > REFINE_MAX_CUT:
        raise ValueError(f'refine_detections: cut={cut} over '
                         f'{REFINE_MAX_CUT}')
    n = _require_positions(xs, ys)
    for name, t in (('a', a), ('b', b), ('theta', theta), ('fwhm', fwhm)):
        _require(name, t, torch.float32, (n,))
    out = torch.empty((len(REFINE_KEYS), n), dtype=torch.float32,
                      device=img.device)
    if n:
        err = build.library().zuds_refine_detections(
            _ptr(img), _ptr(rms), img.shape[0], img.shape[1], _ptr(xs),
            _ptr(ys), _ptr(a), _ptr(b), _ptr(theta), _ptr(fwhm), n, int(cut),
            _ptr(out), _stream())
        build.check(err, 'zuds_refine_detections')
        refine_detections.launches += 1
    return dict(zip(REFINE_KEYS, out))


# H24 (ccl.cu) holds a 12-pixel halo: at most 12 sweeps a launch
SEED_MAX_SWEEPS = 12


def seed_sweeps(det, pidx, count, sweeps=12):
    """H24 (kernels/ccl.cu): the (cap,) f32 label seeds of
    ``ops.detect.seed_labels_plain`` at the compact list ``pidx`` ((cap,)
    int64, the compaction of the bool mask ``det``, under 2^24 px) whose
    first ``count`` (an int64 scalar on the card, the mask's detected
    pixels; at most cap of them listed) entries are listed; +inf past
    them. ``sweeps`` (0..12) masked 3x3 min-pool sweeps of flat indices
    over the whole mask, in one launch.

    Input contract: ``pidx`` is ``ops.compact.compact_indices(det.reshape(
    -1), cap, fill)``'s (its listed entries the detected pixels in raster
    order); for another list the seeds land at other entries, with no
    error."""
    _require('det', det, torch.bool)
    if det.dim() != 2 or det.numel() >= 2 ** 24 \
            or not 0 <= sweeps <= SEED_MAX_SWEEPS:
        raise ValueError(f'seed_sweeps: a mask of shape {tuple(det.shape)} '
                         f'at {sweeps} sweeps unsupported (2-D, under 2^24 '
                         f'px, 0..{SEED_MAX_SWEEPS} sweeps)')
    cap = pidx.shape[0] if pidx.dim() == 1 else -1
    _require('pidx', pidx, torch.int64, (cap,))
    _require('count', count, torch.int64, ())
    H, W = det.shape
    out = torch.empty(cap, dtype=torch.float32, device=det.device)
    if cap:
        err = build.library().zuds_seed_sweeps(
            _ptr(det), H, W, int(sweeps), _ptr(pidx), _ptr(count), cap,
            _ptr(out), _stream())
        build.check(err, 'zuds_seed_sweeps')
        seed_sweeps.launches += 1
    return out


def ccl_fixpoint(nbr_pos, okb, lab0):
    """H25 (kernels/ccl.cu): the (n,) int64 fixed point of
    ``ops.detect.label_compact_plain`` for the (8, n) int64 neighbour
    positions ``nbr_pos``, their bool validity ``okb`` and the (n,) int64
    initial labels ``lab0``: per entry, the smallest position of its class
    (joined by the edges and the pointers i -> lab0[i]). A union-find, no
    host read; n = 0 takes no launch.

    Input contract: ``okb`` is ``ops.detect._adjacency``'s over a
    raster-ordered compact list in which every detected pixel before a
    listed one is also listed, as ``ops.detect._extract`` and
    ``ops.detect.label_components`` (its only producers) give it. The
    kernel unites only rows 0-3 (the backward half) under the scan mask of
    8-connected labelling; for any other neighbour graph (a list out of
    raster order, another adjacency) the labels are wrong, with no
    error."""
    n = lab0.shape[0] if lab0.dim() == 1 else -1
    _require('lab0', lab0, torch.int64, (n,))
    _require('nbr_pos', nbr_pos, torch.int64, (8, n))
    _require('okb', okb, torch.bool, (8, n))
    if n >= 2 ** 31:
        raise ValueError(f'ccl_fixpoint: {n} entries, at most 2^31 - 1')
    out = torch.empty(n, dtype=torch.int64, device=lab0.device)
    if n:
        parent = torch.empty(n, dtype=torch.int32, device=lab0.device)
        err = build.library().zuds_ccl_fixpoint(
            _ptr(nbr_pos), _ptr(okb), _ptr(lab0), n, _ptr(parent), _ptr(out),
            _stream())
        build.check(err, 'zuds_ccl_fixpoint')
        ccl_fixpoint.launches += 1
    return out


# H26's and H27's rows: nseg ints of shared memory in H26's counting sort
OBJECT_MAX_ROWS = 50000
# H26's row fields, in the order of kernels/objects.cu
OBJECT_FLOAT_KEYS = ('x', 'y', 'x2', 'y2', 'xy', 'a', 'b', 'theta',
                     'elongation', 'fwhm', 'flux', 'peak', 'npix', 'xmin',
                     'xmax', 'ymin', 'ymax', 'thresh')
OBJECT_INT_KEYS = ('imaflags', 'flags')


def object_stats(cid, pidx, vals, mask_c, wok_c, thr, deb_ovf, ndet_pix,
                 shape, nseg, minarea, max_det):
    """H26 (kernels/objects.cu): the (nseg,) rows of
    ``ops.detect.object_stats_plain`` of the compact list (object ``cid``
    in [0, nseg) and flat index ``pidx``, int64; ``vals``, ``thr`` f32;
    ``mask_c`` int32; ``wok_c``, ``deb_ovf`` bool; all (cap,), cap >= 1)
    on an (H, W) ``shape`` frame, ``ndet_pix`` an int64 0-d tensor. A dict
    of OBJECT_FLOAT_KEYS (f32), OBJECT_INT_KEYS (int32) and ``valid``
    (bool)."""
    n = cid.shape[0] if cid.dim() == 1 else -1
    _require('cid', cid, torch.int64, (n,))
    _require('pidx', pidx, torch.int64, (n,))
    _require('vals', vals, torch.float32, (n,))
    _require('mask', mask_c, torch.int32, (n,))
    _require('weight_ok', wok_c, torch.bool, (n,))
    _require('thr', thr, torch.float32, (n,))
    _require('deb_ovf', deb_ovf, torch.bool, (n,))
    _require('ndet_pix', ndet_pix, torch.int64, ())
    H, W = shape
    if not 1 <= n < 2 ** 31 or H * W >= 2 ** 31 \
            or not 1 <= nseg <= OBJECT_MAX_ROWS:
        raise ValueError(f'object_stats: {n} entries, {nseg} rows, a '
                         f'{H}x{W} frame unsupported (1 <= entries < 2^31, '
                         f'1..{OBJECT_MAX_ROWS} rows, under 2^31 px)')
    dev = cid.device
    lib = build.library()
    scratch = torch.empty(lib.zuds_object_stats_scratch(n, nseg),
                          dtype=torch.uint8, device=dev)
    outf = torch.empty((len(OBJECT_FLOAT_KEYS), nseg), dtype=torch.float32,
                       device=dev)
    outi = torch.empty((len(OBJECT_INT_KEYS), nseg), dtype=torch.int32,
                       device=dev)
    valid = torch.empty(nseg, dtype=torch.uint8, device=dev)
    err = lib.zuds_object_stats(
        _ptr(cid), _ptr(pidx), _ptr(vals), _ptr(mask_c), _ptr(wok_c),
        _ptr(thr), _ptr(deb_ovf), _ptr(ndet_pix), n, H, W, int(nseg),
        float(minarea), int(max_det), _ptr(scratch), _ptr(outf), _ptr(outi),
        _ptr(valid), _stream())
    build.check(err, 'zuds_object_stats')
    object_stats.launches += 1
    out = dict(zip(OBJECT_FLOAT_KEYS, outf))
    out.update(zip(OBJECT_INT_KEYS, outi))
    out['valid'] = valid.view(torch.bool)
    return out


def clean(xbar, ybar, a, b, theta, peak, thr, flux, npix, flags, valid,
          inv_scale):
    """H27 (kernels/objects.cu): (flux, npix, flags, valid) after the CLEAN
    pass of ``ops.detect._clean_plain`` over the (nseg,) rows (f32 but
    ``flags`` int32 and ``valid`` bool), then (contrib f32, tgt int32):
    each row's summed wings (0 on an invalid row) and the row it merges
    into (nseg - 1 if it stays). ``inv_scale`` is the f32 reciprocal of
    2 CLEAN_PARAM^2, as PyTorch's division by that Python number takes it
    on the card."""
    nseg = xbar.shape[0] if xbar.dim() == 1 else -1
    for name, t in (('x', xbar), ('y', ybar), ('a', a), ('b', b),
                    ('theta', theta), ('peak', peak), ('thresh', thr),
                    ('flux', flux), ('npix', npix)):
        _require(name, t, torch.float32, (nseg,))
    _require('flags', flags, torch.int32, (nseg,))
    _require('valid', valid, torch.bool, (nseg,))
    if not 1 <= nseg <= OBJECT_MAX_ROWS:
        raise ValueError(f'clean: {nseg} rows unsupported '
                         f'(1..{OBJECT_MAX_ROWS})')
    dev = xbar.device
    lib = build.library()
    scratch = torch.empty(lib.zuds_clean_scratch(nseg), dtype=torch.uint8,
                          device=dev)
    contrib = torch.empty_like(flux)
    tgt = torch.empty_like(flags)
    flux_out, npix_out = torch.empty_like(flux), torch.empty_like(npix)
    flags_out = torch.empty_like(flags)
    valid_out = torch.empty(nseg, dtype=torch.uint8, device=dev)
    err = lib.zuds_clean(
        _ptr(xbar), _ptr(ybar), _ptr(a), _ptr(b), _ptr(theta), _ptr(peak),
        _ptr(thr), _ptr(flux), _ptr(npix), _ptr(flags), _ptr(valid), nseg,
        float(inv_scale), _ptr(scratch), _ptr(contrib), _ptr(tgt),
        _ptr(flux_out), _ptr(npix_out), _ptr(flags_out), _ptr(valid_out),
        _stream())
    build.check(err, 'zuds_clean')
    clean.launches += 1
    return (flux_out, npix_out, flags_out, valid_out.view(torch.bool),
            contrib, tgt)


# (Cin, Cout, pool) of the four layers of BraaiD6 (kernels/braai.cu)
BRAAI_LAYERS = ((3, 32, False), (32, 32, True), (32, 64, False),
                (64, 64, True))


def _braai_layer(name, x, cout, pool):
    """(N, H, W, Cin) of a braai layer's NHWC f32 input ``x`` (or its
    shape), checked with ``cout`` and ``pool`` against
    :data:`BRAAI_LAYERS`."""
    shape = tuple(x.shape) if torch.is_tensor(x) else tuple(x)
    if torch.is_tensor(x):
        _require('x', x, torch.float32)
    if len(shape) != 4 or shape[1] < 3 or shape[2] < 3 \
            or math.prod(shape) >= 2 ** 31:
        raise ValueError(f'{name}: expected an (N, H, W, Cin) batch of at '
                         f'least 3x3 under 2^31 elements, got {shape}')
    cin = shape[-1]
    if (cin, cout, bool(pool)) not in BRAAI_LAYERS:
        raise ValueError(f'{name}: (Cin, Cout, pool) = ({cin}, {cout}, '
                         f'{bool(pool)}) is not a layer of BraaiD6')
    return shape


def _braai_out_shape(N, H, W, cout, pool):
    hc, wc = H - 2, W - 2
    return (N, hc // 2, wc // 2, cout) if pool else (N, hc, wc, cout)


def _aligned(name, *ts):
    for t in ts:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f'{name}: every tensor must be 16-byte aligned')


def _braai_saved(name, gy, saved, mask, pool, shape):
    """Check what H19 and H20 read of a layer: its output gradient ``gy``
    of ``shape``; for a pooled layer ``saved`` the u8 routing bytes and
    ``mask`` a bool dropout mask (or None), for an unpooled one ``saved``
    the layer's output and no mask. Returns (route, mask, y)."""
    _require('gy', gy, torch.float32, shape)
    if pool:
        _require('route', saved, torch.uint8, shape)
        if mask is not None:
            _require('mask', mask, torch.bool, shape)
        return saved, mask, None
    if mask is not None:
        raise ValueError(f'{name}: an unpooled layer takes no dropout mask')
    _require('y', saved, torch.float32, shape)
    return None, None, saved


def _ptr_or_null(t):
    return ctypes.c_void_p(None) if t is None else _ptr(t)


def _braai_wsplit(cin, cout, device):
    """H13's scratch for the weights split hi/lo (layers 2-4), or None
    (layer 1 runs on fp32 FMAs)."""
    if cin == 3:
        return None
    return torch.empty(18 * cin * cout, dtype=torch.float32, device=device)


def braai_conv3x3(x, w, b, pool):
    """H13 (kernels/braai.cu): ``relu(conv3x3_valid(x, w) + b)``, then with
    ``pool`` the 2x2/2 max pool (odd last row and column dropped), for an
    NHWC f32 batch ``x`` (N, H, W, Cin), an HWIO kernel ``w`` (3, 3, Cin,
    Cout) and ``b`` (Cout,), at the four layers' shapes
    (:data:`BRAAI_LAYERS`). Returns (N, Ho, Wo, Cout) f32. Layers 2-4 are
    two launches (the weights split hi/lo into a scratch buffer, then the
    3xTF32 implicit GEMM); an unpooled input too wide for its staged rows
    in shared memory (past ~200 columns) is refused at launch
    (RuntimeError)."""
    cout = w.shape[-1] if w.dim() == 4 else -1
    N, H, W, cin = _braai_layer('braai_conv3x3', x, cout, pool)
    _require('w', w, torch.float32, (3, 3, cin, cout))
    _require('b', b, torch.float32, (cout,))
    _aligned('braai_conv3x3', x)
    out = torch.empty(_braai_out_shape(N, H, W, cout, pool),
                      dtype=torch.float32, device=x.device)
    wsplit = _braai_wsplit(cin, cout, x.device)
    err = build.library().zuds_braai_conv3x3(
        _ptr(x), _ptr(w), _ptr(b), _ptr_or_null(wsplit), _ptr(out), N, H, W,
        cin, cout, int(bool(pool)), _stream())
    build.check(err, 'zuds_braai_conv3x3')
    braai_conv3x3.launches += 1
    return out


def braai_conv3x3_train(x, w, b, pool, mask=None, keep=1.0):
    """H13t (kernels/braai.cu, H13's training mode): H13's output of the
    layer and, for a pooled layer, the u8 routing bytes of its gradient
    (0-3, the first maximum in the 2x2 window in row-major order, or 255
    where that maximum is <= 0) with the bool dropout ``mask`` (the
    output's shape, or None) applied as ``mask ? v / keep : 0``. Returns
    (out, route), route None for an unpooled layer (which takes no mask).
    """
    cout = w.shape[-1] if w.dim() == 4 else -1
    N, H, W, cin = _braai_layer('braai_conv3x3_train', x, cout, pool)
    _require('w', w, torch.float32, (3, 3, cin, cout))
    _require('b', b, torch.float32, (cout,))
    shape = _braai_out_shape(N, H, W, cout, pool)
    if mask is not None:
        if not pool:
            raise ValueError('braai_conv3x3_train: an unpooled layer takes '
                             'no dropout mask')
        _require('mask', mask, torch.bool, shape)
    _aligned('braai_conv3x3_train', x, mask)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    route = (torch.empty(shape, dtype=torch.uint8, device=x.device)
             if pool else None)
    wsplit = _braai_wsplit(cin, cout, x.device)
    err = build.library().zuds_braai_conv3x3_train(
        _ptr(x), _ptr(w), _ptr(b), _ptr_or_null(wsplit), _ptr(out),
        _ptr_or_null(route), _ptr_or_null(mask), float(keep), N, H, W, cin,
        cout, int(bool(pool)), _stream())
    build.check(err, 'zuds_braai_conv3x3_train')
    braai_conv3x3_train.launches += 1
    return out, route


def braai_conv3x3_dgrad(gy, w, saved, mask, keep, pool, in_shape):
    """H19 (kernels/braai.cu): the gradient (``in_shape``, NHWC f32) of a
    braai layer's input from the gradient ``gy`` of its output and what
    H13t saved (``saved``, ``mask``: see H20), for layers 2-4 (the
    triplets need none). Two launches: the weights split hi/lo into a
    scratch buffer, then the 3xTF32 implicit GEMM. An input too wide for
    its shared memory (past ~560 columns) is refused at launch
    (RuntimeError)."""
    _require('gy', gy, torch.float32)
    cout = w.shape[-1] if w.dim() == 4 else -1
    N, H, W, cin = _braai_layer('braai_conv3x3_dgrad', in_shape, cout, pool)
    _require('w', w, torch.float32, (3, 3, cin, cout))
    if cin == 3:
        raise ValueError('braai_conv3x3_dgrad: the first layer\'s input (the '
                         'triplets) has no gradient kernel')
    shape = _braai_out_shape(N, H, W, cout, pool)
    route, mask, y = _braai_saved('braai_conv3x3_dgrad', gy, saved, mask,
                                  pool, shape)
    _aligned('braai_conv3x3_dgrad', gy, route, mask, y)
    gx = torch.empty((N, H, W, cin), dtype=torch.float32, device=gy.device)
    wsplit = torch.empty(18 * cin * cout, dtype=torch.float32,
                         device=gy.device)
    p = _ptr_or_null
    err = build.library().zuds_braai_conv3x3_dgrad(
        _ptr(gy), p(route), p(mask), p(y), float(keep), _ptr(w),
        _ptr(wsplit), _ptr(gx), N, H, W, cin, cout, int(bool(pool)),
        _stream())
    build.check(err, 'zuds_braai_conv3x3_dgrad')
    braai_conv3x3_dgrad.launches += 1
    return gx


def braai_conv3x3_wgrad(x, gy, saved, mask, keep, pool):
    """H20 (kernels/braai.cu): (gw (3, 3, Cin, Cout), gb (Cout,)) of a braai
    layer from its input ``x`` (NHWC f32), the gradient ``gy`` of its
    output and what H13t saved: for a pooled layer ``saved`` its routing
    bytes and ``mask`` its bool dropout mask (or None) with ``keep``; for
    an unpooled one ``saved`` its output (the ReLU mask) and no mask.
    Fixed-order partials per chunk of 1-4 images, then a second pass in
    chunk order: two calls give the same bits. An input too wide for its
    shared memory (past 63-188 columns by layer; the d6 net's are 27-63)
    is refused at launch (RuntimeError)."""
    cout = gy.shape[-1] if gy.dim() == 4 else -1
    N, H, W, cin = _braai_layer('braai_conv3x3_wgrad', x, cout, pool)
    shape = _braai_out_shape(N, H, W, cout, pool)
    route, mask, y = _braai_saved('braai_conv3x3_wgrad', gy, saved, mask,
                                  pool, shape)
    _aligned('braai_conv3x3_wgrad', x, gy, route, mask, y)
    count = 9 * cin * cout + cout
    partial = torch.empty(max(N, 1) * count, dtype=torch.float32,
                          device=x.device)
    out = torch.empty(count, dtype=torch.float32, device=x.device)
    p = _ptr_or_null
    err = build.library().zuds_braai_conv3x3_wgrad(
        _ptr(x), _ptr(gy), p(route), p(mask), p(y), float(keep),
        _ptr(partial), _ptr(out), N, H, W, cin, cout, int(bool(pool)),
        _stream())
    build.check(err, 'zuds_braai_conv3x3_wgrad')
    braai_conv3x3_wgrad.launches += 1
    return out[:-cout].view(3, 3, cin, cout), out[-cout:]


def braai_backward_resources(kind, cin, cout, pool, width):
    """What the card gives H19 (``kind`` 'dgrad') or H20 ('wgrad') at the
    braai layer (``cin``, ``cout``, ``pool``) whose input is ``width``
    wide: {'registers', 'spill_bytes', 'smem_bytes', 'blocks_per_sm'}."""
    if kind not in ('dgrad', 'wgrad'):
        raise ValueError(f'braai_backward_resources: kind {kind!r} is not '
                         "'dgrad' or 'wgrad'")
    out = (ctypes.c_int * 4)()
    err = build.library().zuds_braai_backward_resources(
        int(kind == 'wgrad'), cin, cout, int(bool(pool)), width, out)
    build.check(err, 'zuds_braai_backward_resources')
    return dict(zip(('registers', 'spill_bytes', 'smem_bytes',
                     'blocks_per_sm'), out))


def adam_step(p, g, mu, nu, bc1, bc2, lr, b1, b2, eps):
    """H21 (kernels/adam.cu): optax's Adam update and its application over
    the flat f32 buffers ``p``, ``g``, ``mu``, ``nu`` (one shape), in place
    on ``p``, ``mu`` and ``nu``, with the bias corrections ``bc1``, ``bc2``
    (f32 device scalars, ``1 - b^count`` of the incremented count). The
    hyperparameters are rounded to f32 here, as JAX rounds its weakly typed
    Python floats."""
    _require('p', p, torch.float32)
    for name, t in (('g', g), ('mu', mu), ('nu', nu)):
        _require(name, t, torch.float32, p.shape)
    _require('bc1', bc1, torch.float32, ())
    _require('bc2', bc2, torch.float32, ())
    err = build.library().zuds_adam_step(
        _ptr(p), _ptr(g), _ptr(mu), _ptr(nu), _ptr(bc1), _ptr(bc2),
        p.numel(), float(b1), 1.0 - b1, float(b2), 1.0 - b2, float(eps),
        -float(lr), _stream())
    build.check(err, 'zuds_adam_step')
    adam_step.launches += 1
    return p, mu, nu


def zogy_spectral(N, R, Pn, Pr, c_r, c_n, f_ref, f_new, f_rn, f_d):
    """H15 (kernels/zogy.cu): from the half spectra ``N``, ``R`` and the
    OTFs ``Pn``, ``Pr`` (complex64, one shape) and the f32 scalars of
    ``ops.zogy.zogy_scalars`` (host numbers, passed by value), the maximum
    of ``denom`` into a device scalar and then (D_hat, P_d_hat, S_hat),
    complex64 of that shape. Nothing is read back to the host.

    The pass is elementwise, so the four inputs may have any dense layout
    they share (cuFFT's ``rfft2`` gives a transposed one); the outputs take
    it too."""
    for name, t in (('N', N), ('R', R), ('Pn', Pn), ('Pr', Pr)):
        if not t.is_cuda:
            raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
        if t.dtype != torch.complex64:
            raise TypeError(f'{name}: expected torch.complex64, got {t.dtype}')
        if t.shape != N.shape:
            raise ValueError(f'{name}: expected shape {tuple(N.shape)}, '
                             f'got {tuple(t.shape)}')
        if not _dense(t) or t.stride() != N.stride():
            raise ValueError(f'{name}: expected a dense layout shared by the '
                             f'four spectra, got strides {t.stride()} '
                             f'against N\'s {N.stride()}')
    n = N.numel()
    dmax = torch.empty((), dtype=torch.int32, device=N.device)
    D, Pd, S = (torch.empty_like(N) for _ in range(3))
    err = build.library().zuds_zogy_spectral(
        _ptr(N), _ptr(R), _ptr(Pn), _ptr(Pr), n, float(c_r), float(c_n),
        float(f_ref), float(f_new), float(f_rn), float(f_d), _ptr(dmax),
        _ptr(D), _ptr(Pd), _ptr(S), _stream())
    build.check(err, 'zuds_zogy_spectral')
    zogy_spectral.launches += 1
    return D, Pd, S


# the most blocks of H16's grid (zogy.cu launches as many as fit on the
# card at once, fewer than this on the H100); its scratch holds a double a
# block
NORMALIZE_MAX_BLOCKS = 8 * 132


def zogy_normalize(p_d, s, f_d):
    """H16 (kernels/zogy.cu): ``s / (f_d sqrt(max(sum p_d^2, 1e-20)))``
    (f32, the shape of ``s``) in one launch; the sum stays on the card.
    Any length and storage offset (16-byte loads where the three pointers
    are 16-byte aligned)."""
    _require('p_d', p_d, torch.float32)
    _require('s', s, torch.float32, p_d.shape)
    partials = torch.empty(NORMALIZE_MAX_BLOCKS, dtype=torch.float64,
                           device=s.device)
    out = torch.empty_like(s)
    err = build.library().zuds_zogy_normalize(
        _ptr(p_d), _ptr(s), p_d.numel(), float(f_d), NORMALIZE_MAX_BLOCKS,
        _ptr(partials), _ptr(out), _stream())
    build.check(err, 'zuds_zogy_normalize')
    zogy_normalize.launches += 1
    return out


# H17 (zogy.cu) holds a stamp of up to 32 x 32 in shared memory
PSF_MAX_STAMP = 32


def psf_stamps(img, xs, ys, valid, size):
    """H17 (kernels/zogy.cu): the (S, size, size) f32 stamps of
    ``ops.zogy.psf_stamps_plain`` at the f32 positions ``xs``, ``ys`` (S,)
    of ``img`` (f32 (H, W)), and ``good0`` (bool (S,)) from ``valid``
    (bool (S,)); ``size`` up to :data:`PSF_MAX_STAMP`."""
    _require('img', img, torch.float32)
    if img.dim() != 2 or not 1 <= size <= min(PSF_MAX_STAMP, *img.shape) \
            or img.numel() >= 2 ** 31:
        raise ValueError(f'psf_stamps: a {size} px stamp of a frame of '
                         f'shape {tuple(img.shape)} unsupported (2-D, under '
                         f'2^31 px, 1 <= size <= {PSF_MAX_STAMP})')
    n = xs.shape[0] if xs.dim() == 1 else -1
    _require('xs', xs, torch.float32, (n,))
    _require('ys', ys, torch.float32, (n,))
    _require('valid', valid, torch.bool, (n,))
    stamps = torch.empty((n, size, size), dtype=torch.float32,
                         device=img.device)
    good0 = torch.empty(n, dtype=torch.uint8, device=img.device)
    err = build.library().zuds_psf_stamps(
        _ptr(img), img.shape[0], img.shape[1], _ptr(xs), _ptr(ys),
        _ptr(valid), n, int(size), _ptr(stamps), _ptr(good0), _stream())
    build.check(err, 'zuds_psf_stamps')
    psf_stamps.launches += 1
    return stamps, good0.view(torch.bool)


def psf_clip(stamps, good0, iters):
    """H18 (kernels/zogy.cu): the clipped mean of
    ``ops.zogy.psf_clip_plain`` over the (S, k, k) f32 ``stamps`` (k^2 up
    to 1024) with the bool (S,) ``good0``, in one cluster of blocks that
    split the pixels: (psf (k, k) f32, good (S,) bool after the last
    pass)."""
    _require('stamps', stamps, torch.float32)
    if stamps.dim() != 3 or not 1 <= stamps.shape[1] * stamps.shape[2] \
            <= 1024 or stamps.shape[0] < 1 or iters < 0:
        raise ValueError(f'psf_clip: stamps of shape {tuple(stamps.shape)}, '
                         f'iters={iters} unsupported (S >= 1 stamps of at '
                         'most 1024 px, iters >= 0)')
    S, k1, k2 = stamps.shape
    _require('good0', good0, torch.bool, (S,))
    psf = torch.empty((k1, k2), dtype=torch.float32, device=stamps.device)
    good = torch.empty(S, dtype=torch.uint8, device=stamps.device)
    err = build.library().zuds_psf_clip(
        _ptr(stamps), _ptr(good0), S, k1 * k2, int(iters), _ptr(psf),
        _ptr(good), _stream())
    build.check(err, 'zuds_psf_clip')
    psf_clip.launches += 1
    return psf, good.view(torch.bool)


def _require_view(name, t, dtype, shape=None):
    """Like _require for a 2-D view that need not be contiguous."""
    if not t.is_cuda:
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    if t.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
    if t.dim() != 2 or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f'{name}: expected a 2-D view'
                         + (f' of shape {tuple(shape)}' if shape else '')
                         + f', got {tuple(t.shape)}')


# H5 packs a cell into 16 bits of an edge and holds a level's labels in
# shared memory (deblend.cu kMaxCells): the reference's cell cap
DEBLEND_MAX_CELLS = 8192

warp.launches = 0
warp_sep.launches = 0
background_cells.launches = 0
apply_model.launches = 0
apply_model_variance.launches = 0
detect_filter.launches = 0
detect_filter_taps.launches = 0
deblend_labels.launches = 0
compact.launches = 0
stamp_candidates.launches = 0
frame_median.launches = 0
clipped_combine.launches = 0
warp_gather.launches = 0
subtract_epilogue.launches = 0
triplet_cut.launches = 0
negpix_veto.launches = 0
braai_conv3x3.launches = 0
zogy_spectral.launches = 0
zogy_normalize.launches = 0
psf_stamps.launches = 0
psf_clip.launches = 0
braai_conv3x3_train.launches = 0
braai_conv3x3_dgrad.launches = 0
braai_conv3x3_wgrad.launches = 0
adam_step.launches = 0
aperture_photometry.launches = 0
aperture_sums.launches = 0
refine_detections.launches = 0
seed_sweeps.launches = 0
ccl_fixpoint.launches = 0
object_stats.launches = 0
clean.launches = 0
WRAPPERS = {'warp': warp, 'warp_sep': warp_sep,
            'background_cells': background_cells,
            'apply_model': apply_model,
            'apply_model_variance': apply_model_variance,
            'detect_filter': detect_filter,
            'detect_filter_taps': detect_filter_taps,
            'deblend_labels': deblend_labels,
            'compact': compact, 'stamp_candidates': stamp_candidates,
            'frame_median': frame_median,
            'clipped_combine': clipped_combine,
            'warp_gather': warp_gather,
            'subtract_epilogue': subtract_epilogue,
            'triplet_cut': triplet_cut, 'negpix_veto': negpix_veto,
            'braai_conv3x3': braai_conv3x3, 'zogy_spectral': zogy_spectral,
            'zogy_normalize': zogy_normalize, 'psf_stamps': psf_stamps,
            'psf_clip': psf_clip, 'braai_conv3x3_train': braai_conv3x3_train,
            'braai_conv3x3_dgrad': braai_conv3x3_dgrad,
            'braai_conv3x3_wgrad': braai_conv3x3_wgrad,
            'adam_step': adam_step,
            'aperture_photometry': aperture_photometry,
            'aperture_sums': aperture_sums,
            'refine_detections': refine_detections,
            'seed_sweeps': seed_sweeps, 'ccl_fixpoint': ccl_fixpoint,
            'object_stats': object_stats, 'clean': clean}
