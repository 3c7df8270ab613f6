"""The port's hand kernels (H1-H23) against their plain PyTorch versions,
on a CUDA card, at small and ragged shapes (partial tiles, partial cells),
H5/H6 at the flagship's capacities, H8 up to a flagship frame, the
two-plane H1 on the coadd's 3200x3200 canvas, H9 from 1 to 64 epochs, the
gather warp H10 on rotated mappings into sources of another shape, H3 at
one term against the variance propagation, the epilogue H11, the triplet
cutter H12, each braai layer H13, the negative-pixel veto H14, and the
ZOGY kernels: the spectral pass H15, the score normalisation H16, the PSF
star stamps H17 and their clipped mean H18, braai training's H13t and
H19-H21, the aperture photometry H22 in both modes and the windowed and
Kron refinement H23, and the detect stage's label seeds H24, base
components H25, per-object statistics H26 and CLEAN H27.

These need the card: they skip on a CPU-only machine. The card machine has
no JAX, and tests/conftest.py imports it, so run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: warp pixels rtol 3e-5, atol 5e-3 counts, mask and coverage
bit-equal (H1 also at window 8, with wild and NaN displacements, at
integer and half-integer shifts, with non-finite reference pixels; H10 at
integer and half-integer phases into sources of other shapes; each two
calls bit-equal and, on a 1024^2 star field, no further from the plain
version run in float64 than the f32 plain version; from inputs inside NaN
guard bands into poisoned outputs, 20 launches each bit-equal to the
wrapper's); background cells rtol 1e-4 and bit-equal, counts equal (also
on the flagship quadrant and the coadd canvas); model convolution
rtol 1e-4, atol 1e-3; matched filter img, filt and det bit-equal (-0,
subnormal values, W % 4 != 0, a batch's frame, a view at an odd offset,
3080x3072); deblend level labels and compaction bit-equal (H5 also with
``nedge``, its slots past the count padded, and two calls bit-equal; H6
also on mask views at byte offsets 1, 3 and 15, at size 0 and at size = n
on a full frame, and against ``torch.nonzero_static``); stamp candidates
(cand, and
filt at the candidates; also on a crowded frame, a blank one, NaN near
peaks) and the frame median bit-equal (also with +-inf values and values
on the mids); the two-plane
warp as the one-plane warp on both planes; the clipped combine's counts and
mask equal, its coadd and weight rtol 2e-6 (the plain version forms the
same sums in the same order; the card's own ``1/sqrt`` in the plain version
may round a sigma one ulp away, which only moves a pixel that lies within
an ulp of its clip threshold: such pixels are counted and bounded at 1e-5
of the frame), and at 1-64 epochs on stacks with NaN and +-inf at weight
> 0 all five outputs bit-equal. The gather warp as the windowed one
(pixels rtol 3e-5, atol 5e-3, mask and coverage equal); the variance
launch of H3 rtol 1e-4, atol 1e-3 of the variance's scale, and H3 at one
term the same (the order-0 model rtol 1e-4, atol 1e-3 up to K = 15, and
no further from float64 than the tensor-core GEMM at every K), into
NaN-filled outputs, two calls bit-identical; the epilogue bit-equal in
both of its
rounding modes. The triplets rtol 1e-6 (another order of the L2 sum); each
braai layer rtol 1e-5, atol 1e-6 against ``F.conv2d`` with TF32 off (NaN
and +-inf inputs where the plain version puts them, two calls of H13 and
H13t bit-equal, and at a batch of 256 no further from float64 than cuDNN),
the scores 1e-6 absolute; the veto bit-equal. H15 rtol 1e-6 (the plain
version rounds every step as the kernel does; the double-formed FMA of
its complex abs may round twice), NaN where the plain version has it; H16
rtol 1e-6 (both sum the squares in double, in other orders; also at
lengths that are no multiple of 4, under one slab and at a storage offset
off 16 bytes; one kernel and no memset a call, capturable in a CUDA
graph); the PSF stamps and the clipped PSF 1e-7 absolute (H17's DFT
passes and the plain version's cuFFT both transform in double and round
once; H17 also at sizes 1, 24 and 32 with 1 and 300 stamps),
``good0`` and ``good`` equal;
``zogy_subtract`` on the card against the CPU as the CPU against the JAX
package (``tests/test_torch_zogy.py``). The training kernels: H13t per
layer against its plain version (values rtol 1e-5, atol 1e-6; without a
mask bit-equal to H13; the routing bytes equal wherever the window's
largest pre-activation is further than 1e-5 of the layer's largest from 0
and, positive, from the second, and such near ties under 1% of the
windows),
H19 and H20 per layer on the plain version's saved bytes, within 1e-5
of the plain gradient's largest magnitude (3xTF32 in another summation
order, at a batch of 7, and at batches of 1, 3 and 5 with and without a
dropout mask; ``chip_smoke.py`` holds H20 at 1e-4 at the main path's
batch of 256), two H19 and two H20 calls bit-equal, two blocks of each
resident per SM; H21 bit-equal to ``adam_update_plain``; one
``train_step`` on the card against ``train_step_plain`` with the same
masks (loss 1e-5 relative, parameters by the Adam-aware rule of
``tests/test_torch_braai_train.py``). H22's overlaps, flags and oob
bit-equal, its sums within the bound of two summation orders
(``kernels.checks.sum_gap_bound``); H23 within
``kernels.checks.refine_check``'s tolerances, two calls bit-identical;
both take N = 0 without a launch. H24 and H25 bit-equal to their plain
versions (H25 also where the frame's last pixel is detected, two calls
bit-equal); H26 bit-equal but ``theta`` (within ``checks.THETA_ATOL``); H27
as ``checks.clean_check`` (which rows are cleaned and where they merge,
valid, flags and npix bit-equal, flux within the merge order's bound);
``detect_sources`` through H24-H27 as ``checks.detect_check`` against the
same call with their plain versions, at the three deblend modes; no host
copy or wait inside the ``ccl``, ``stats`` and ``clean`` ranges.
"""
import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _rand(shape, dev, seed, scale=1.0, offset=0.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return offset + scale * torch.randn(shape, generator=g, device=dev)


def _allclose(a, b, rtol, atol):
    err = (a - b).abs()
    assert bool((err <= atol + rtol * b.abs()).all()), float(err.max())


@pytest.mark.parametrize('H,W,window', [(200, 136, 2), (97, 131, 3)])
def test_warp_kernel(dev, H, W, window):
    from zuds_tpu_torch.ops import resample
    from zuds_tpu_torch.kernels import launch
    ref = _rand((H, W), dev, 1, 20.0, 150.0)
    g = torch.Generator(device=dev).manual_seed(2)
    bits = torch.randint(0, 1 << 18, (H, W), generator=g, device=dev,
                         dtype=torch.int32)
    mask = torch.where(torch.rand((H, W), generator=g, device=dev) < 0.03,
                       bits, 0).to(torch.int32)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    u = (xx + 1.8 * torch.sin(yy / 23.0 + xx / 31.0)).contiguous()
    v = (yy + 1.6 * torch.cos(xx / 19.0)).contiguous()
    covb = torch.tensor([2.0, W - 3.0, 4.5, H - 7.0], device=dev)
    n0 = launch.warp.launches
    k = resample.warp_reference(ref, mask, u, v, covb, window)
    assert launch.warp.launches == n0 + 1
    p = resample.warp_reference_plain(ref, mask, u, v, covb, window)
    _allclose(k[0], p[0], 3e-5, 5e-3)
    assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])


@pytest.mark.parametrize('H,W,box', [(200, 136, 64), (264, 256, 128),
                                      (3080, 3072, 128)])
def test_background_kernel(dev, H, W, box):
    """Partial cells and the flagship quadrant: back and sigma within 1e-4
    and bit-equal, n equal, one launch."""
    from zuds_tpu_torch.ops import background
    from zuds_tpu_torch.kernels import launch
    img = _rand((H, W), dev, 3, 5.0, 150.0)
    img[10:30, 10:40] += 500.0
    g = torch.Generator(device=dev).manual_seed(4)
    valid = torch.rand((H, W), generator=g, device=dev) > 0.05
    n0 = launch.background_cells.launches
    k = launch.background_cells(img, valid, box, 3)
    assert launch.background_cells.launches == n0 + 1
    p = background.background_cells_plain(img, valid, box, 3)
    _allclose(k[0], p[0], 1e-4, 0.0)
    _allclose(k[1], p[1], 1e-4, 0.0)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(k[2], p[2])


@pytest.mark.parametrize('H,W,K,order,nreg', [
    (200, 184, 9, 4, 3), (160, 96, 15, 2, 2),
    (120, 136, 17, 4, 3),     # K > 15
    (96, 104, 21, 5, 2),      # Nm = 21: two 16-term tiles
    (64, 88, 31, 2, 3),       # regions under 32 px; the largest ksize
    (33, 70, 9, 0, 1),        # one region, one term, a partial tile
    (150, 130, 11, 3, 5),     # 5x5 regions of 26-30 px
])
def test_apply_kernel(dev, H, W, K, order, nreg):
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.ops import subtract
    from zuds_tpu_torch.kernels import launch
    b = inputs.KernelBasis(K, 2.0 / 2.355)
    basis = [torch.as_tensor(a, device=dev)
             for a in (b.gx, b.gy, b.sums, b.b0_2d)]
    nm = len(subtract.spatial_terms(order))
    rng = np.random.default_rng(5)
    coeffs = rng.normal(0, 0.01, (nreg * nreg, b.nbasis * nm + 1))
    coeffs[:, 0] += 1.0
    coeffs[:, -1] = rng.normal(0, 3, nreg * nreg)
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=dev)
    ref = _rand((H, W), dev, 6, 30.0, 150.0)
    n0 = launch.apply_model.launches
    k = subtract.apply_kernel_fast(ref, coeffs, *basis, order=order,
                                   nreg=nreg)
    assert launch.apply_model.launches == n0 + 1
    p = subtract.apply_kernel(ref, coeffs, *basis, order=order, nreg=nreg)
    _allclose(k, p, 1e-4, 1e-3)


def test_apply_fast_copies_nothing_from_host(dev):
    """apply_kernel_fast passes the region geometry by value: the traced
    call holds H3's launch and no host-to-device copy."""
    from torch.profiler import ProfilerActivity, profile
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.ops import subtract
    b = inputs.KernelBasis(15, 2.0 / 2.355)
    basis = [torch.as_tensor(a, device=dev)
             for a in (b.gx, b.gy, b.sums, b.b0_2d)]
    coeffs = _rand((9, b.nbasis * 15 + 1), dev, 10, 0.01)
    ref = _rand((128, 128), dev, 11, 30.0, 150.0)

    def run():
        return subtract.apply_kernel_fast(ref, coeffs, *basis, order=4,
                                          nreg=3)
    run()                                   # build and load the library
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert any('apply_mma_kernel' in n for n in names), names
    assert not any('HtoD' in n for n in names), names


def _bits(t):
    """The bytes of ``t``: equal bytes are equal values, -0 and NaN too."""
    return t.contiguous().view(torch.uint8)


def _h4_frames(B, H, W, dev, seed):
    """B frames of diff, rms, weight with the cases H4 must round as the
    plain version: NaN, +-inf, -0 on good pixels, rms <= 0, weight holes
    and a band of subnormal values (their products with the taps are
    inexact)."""
    diff = _rand((B, H, W), dev, seed, 8.0)
    rms = _rand((B, H, W), dev, seed + 1, 0.5, 5.0).abs()
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    wok = torch.rand((B, H, W), generator=g, device=dev) > 0.02
    sub = torch.rand((B, H, W), generator=g, device=dev)
    for b in range(B):
        d, r = diff[b], rms[b]
        d[5 % H, 5 % W] = float('nan')
        d[6 % H, 9 % W] = float('inf')
        d[(H - 2) % H, (W - 3) % W] = float('-inf')
        d[H // 2, :] = -0.0
        r[3 % H, 3 % W] = 0.0
        r[(H - 1) % H, 2 % W] = -1.0
        band = slice(H // 3, H // 3 + 3)
        d[band] = (sub[b, band] - 0.5) * 2e-38       # subnormal and near
        d[band, ::3] = 1.4e-45 * torch.sign(sub[b, band, ::3] - 0.5)
    wok[:, H // 2, 1::2] = True                      # the -0 row stays good
    rms[:, H // 2] = 1.0
    return diff, rms, wok


@pytest.mark.parametrize('H,W,form', [
    (200, 136, 'frame'), (33, 70, 'frame'), (97, 131, 'frame'),
    (3080, 3072, 'frame'), (64, 128, 'batch'), (57, 131, 'batch'),
    (64, 128, 'offset'), (1, 1, 'frame'), (5, 3, 'frame')])
def test_detect_filter_kernel(dev, H, W, form):
    """H4 bit-equal to its plain version on all three planes: the 4-column
    form (W % 4 == 0, aligned), the 1-column form (W % 4 != 0; a frame of a
    batch at W % 4 != 0; a view at a one-element offset), ragged strips."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import detect
    diff, rms, wok = _h4_frames(3 if form == 'batch' else 1, H, W, dev, 7)
    b = 1 if form == 'batch' else 0
    diff, rms, wok = diff[b], rms[b], wok[b]
    if form == 'offset':
        flat = torch.empty(H * W + 1, device=dev)
        flat[1:] = diff.reshape(-1)
        diff = flat[1:].view(H, W)
        assert diff.data_ptr() % 16 != 0
    n0 = launch.detect_filter.launches
    k = detect.matched_filter(diff, rms, wok, 1.5)
    assert launch.detect_filter.launches == n0 + 1
    p = detect.matched_filter_plain(diff, rms, wok, 1.5)
    for plane, a, b in zip(('img', 'filt', 'det'), k, p):
        assert torch.equal(_bits(a), _bits(b)), plane
    if H > 8:
        assert bool(((p[0] == 0) & p[0].signbit()).any())     # -0 kept
        assert 0 < int(p[2].sum()) < H * W


def _graph(dev, seed, ccap, ecap, L, nchain, chain_len):
    """Random edges, and chains whose cells run down from near ccap with
    the smallest cell at one end: label 0 crawls one cell per round, so
    the round cap decides the labels."""
    g = torch.Generator(device='cpu').manual_seed(seed)
    src = torch.randint(0, ccap, (ecap,), generator=g)
    dst = torch.randint(0, ccap, (ecap,), generator=g)
    w = torch.randint(0, L + 1, (ecap,), generator=g)
    k = 0
    for c in range(nchain):
        cells = [c] + [ccap - 1 - c * chain_len - i for i in range(chain_len)]
        for a, b in zip(cells[:-1], cells[1:]):
            src[k:k + 2] = torch.tensor([a, b])
            dst[k:k + 2] = torch.tensor([b, a])
            w[k:k + 2] = L
            k += 2
    return [t.to(torch.int32).to(dev) for t in (src, dst, w)]


@pytest.mark.parametrize('ccap,ecap,rounds', [
    (8192, 65536, 6), (8192, 65536, 1), (8192, 65536, 40), (300, 1000, 6),
    (8192, 100, 6)])
@pytest.mark.parametrize('over', [0, 1000])
def test_deblend_labels_kernel(dev, ccap, ecap, rounds, over):
    """H5 on random graphs (the 65,536-slot ones past a block's shared
    memory), given ``nedge = ecap`` and a count past the slots (read as
    ecap); two calls bit-equal."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import deblend
    L = 31
    src, dst, w = _graph(dev, ccap + ecap, ccap, ecap, L,
                         min(20, ecap // 200), 25)
    nedge = torch.tensor(ecap + over, device=dev)
    n0 = launch.deblend_labels.launches
    k = deblend.level_labels(src, dst, w, ccap, L, rounds, nedge)
    assert launch.deblend_labels.launches == n0 + 1
    p = deblend.level_labels_plain(src, dst, w, ccap, L, rounds)
    assert k.dtype == torch.int32 and torch.equal(k, p)
    assert torch.equal(deblend.level_labels(src, dst, w, ccap, L, rounds,
                                            nedge), k)


@pytest.mark.parametrize('nedge', [0, 1, 777, 30000, 65535])
def test_deblend_labels_kernel_reads_the_live_count(dev, nedge):
    """H5 given ``nedge`` < ecap, the slots past it padded as
    ``cell_graph`` pads them (e_w = 0, cell ccap - 1), and every live slot
    at level 0 (past a block's shared memory at 30000 and up)."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import deblend
    ccap, ecap, L = 8192, 65536, 31
    src, dst, w = (t.long() for t in _graph(dev, nedge, ccap, ecap, L, 20,
                                            25))
    w = torch.where(w > 0, w, 1)
    src[nedge:], dst[nedge:], w[nedge:] = ccap - 1, ccap - 1, 0
    cnt = torch.tensor(nedge, device=dev)
    k = launch.deblend_labels(src, dst, w, ccap, L, 6, cnt)
    p = deblend.level_labels_plain(src, dst, w, ccap, L, 6)
    assert torch.equal(k, p)
    assert torch.equal(launch.deblend_labels(src, dst, w, ccap, L, 6, cnt),
                       k)


@pytest.mark.parametrize('n,size,p', [
    (7, 4, 0.5), (2048, 2048, 0.3), (2049, 100, 0.3),
    (3080 * 3072, 1 << 16, 0.003), (3080 * 3072, 1 << 16, 0.05),
    (100000, 5000, 0.0), (100000, 5000, 1.0), (1000, 2000, 1.0)])
def test_compact_kernel(dev, n, size, p):
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import compact
    g = torch.Generator(device=dev).manual_seed(n + size)
    mask = torch.rand(n, generator=g, device=dev) < p
    n0 = launch.compact.launches
    idx, cnt = compact.compact_indices(mask, size, n - 1)
    assert launch.compact.launches == n0 + 1
    want = torch.nonzero(mask).reshape(-1)[:size]
    assert int(cnt) == int(mask.sum())
    assert torch.equal(idx[:len(want)], want)
    assert bool((idx[len(want):] == n - 1).all())
    pidx, pcnt = compact.compact_indices_plain(mask, size, n - 1)
    assert torch.equal(idx, pidx) and torch.equal(cnt, pcnt)


@pytest.mark.parametrize('offset', (1, 3, 15))
@pytest.mark.parametrize('n', (5, 4099, 65536 + 7, 524288 + 13,
                               3080 * 3072 - 5))
def test_compact_kernel_at_byte_offsets(dev, n, offset):
    """H6 on a view that starts ``offset`` bytes past a 16-byte boundary,
    of a length that is not a multiple of 16 once the head is off: the head
    and tail read as bytes, bit-equal to the plain version and to
    ``torch.nonzero_static``."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import compact
    g = torch.Generator(device=dev).manual_seed(n + offset)
    base = torch.rand(n + offset, generator=g, device=dev) < 0.3
    base[:offset + 16] = True        # the head and the first vector set
    base[-17:] = True                # the tail and the last vector set
    mask = base[offset:]
    assert mask.data_ptr() % 16 == offset
    for size in (min(n, 4096), n):
        n0 = launch.compact.launches
        idx, cnt = launch.compact(mask, size, n - 1)
        assert launch.compact.launches == n0 + 1
        pidx, pcnt = compact.compact_indices_plain(mask, size, n - 1)
        assert torch.equal(idx, pidx) and torch.equal(cnt, pcnt)
        lib = torch.nonzero_static(mask, size=size, fill_value=n - 1)
        assert torch.equal(idx, lib.reshape(-1))


def test_compact_kernel_at_size_zero_and_full_frame(dev):
    """H6 at size 0 (the count only) and at size = n on the full-frame
    mask ``label_components`` compacts (3080 x 3072, 9.46 M indices),
    dense and sparse."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import compact
    n = 3080 * 3072
    g = torch.Generator(device=dev).manual_seed(21)
    for p in (0.02, 0.6):
        mask = torch.rand(n, generator=g, device=dev) < p
        idx, cnt = launch.compact(mask, 0, -1)
        assert idx.shape == (0,) and int(cnt) == int(mask.sum())
        idx, cnt = launch.compact(mask, n, n)
        pidx, pcnt = compact.compact_indices_plain(mask, n, n)
        assert torch.equal(idx, pidx) and torch.equal(cnt, pcnt)


def test_h5_h6_refuse_wrong_dtypes(dev):
    from zuds_tpu_torch.kernels import launch
    e = torch.zeros(16, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        launch.deblend_labels(*(e.to(torch.int32),) * 3, 8, 31, 6, e[0])
    with pytest.raises(TypeError):
        launch.deblend_labels(e, e, e, 8, 31, 6, e[0].int())
    with pytest.raises(TypeError):
        launch.compact(torch.zeros(16, dtype=torch.uint8, device=dev), 4, 0)
    with pytest.raises(ValueError):
        launch.deblend_labels(e, e, e, 1 << 20, 31, 6, e[0])
    with pytest.raises(ValueError):
        launch.deblend_labels(e, e, e, 8193, 31, 6, e[0])


def _stamp_field(H, W, dev, seed):
    """Stars on noise with the cases H7 must get right: a flat plateau
    (tied maxima), a saturated star, stars on the frame edge and inside the
    margin."""
    g = torch.Generator(device=dev).manual_seed(seed)
    img = 150.0 + 5.0 * torch.randn((H, W), generator=g, device=dev)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    pos = torch.rand((60, 2), generator=g, device=dev) * torch.tensor(
        [W - 1.0, H - 1.0], device=dev)
    pos[:4] = torch.tensor([[0.0, 5.0], [W - 1.0, H / 2], [3.0, H - 2.0],
                            [W / 2, 1.0]], device=dev)
    for (x, y) in pos.tolist():
        img += 4000.0 * torch.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 4.0)
    img[H // 3:H // 3 + 3, W // 3:W // 3 + 3] = 2000.0       # plateau
    img[2 * H // 3, 2 * W // 3] = 7e4                         # saturated
    return img.contiguous()


@pytest.mark.parametrize('H,W,margin', [(200, 136, 21), (97, 131, 5),
                                        (3080, 3072, 21)])
def test_stamp_candidates_kernel(dev, H, W, margin):
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import background, measure
    img = _stamp_field(H, W, dev, 11)
    med = background.frame_median_plain(img)
    sigma = 1.4826 * background.frame_median_plain(img, center=med)
    img[H // 2, 10] = float('nan')      # after the medians, which it poisons
    n0 = launch.stamp_candidates.launches
    kf, kc = launch.stamp_candidates(img, med, sigma, 6e4, margin)
    assert launch.stamp_candidates.launches == n0 + 1
    pf, pc = measure.stamp_candidates_plain(img, med, sigma, 6e4, margin)
    assert torch.equal(kc, pc) and int(pc.sum()) > 10
    # H7 writes filt at the candidates only, the one place it is read
    assert torch.equal(kf[kc], pf[pc])


def _crowded_field(H, W, dev, seed, density):
    """Noise 5 about 150 and ``density`` H W point sources of flux
    10^2.5-10^4.5 blurred by a Gaussian of sigma 1.5 px: at 0.01 some 14%
    of the pixels pass H7's threshold and nearly every warp has a lane
    that does."""
    g = torch.Generator(device=dev).manual_seed(seed)
    img = 150.0 + 5.0 * torch.randn((H, W), generator=g, device=dev)
    n = int(density * H * W)
    pos = torch.randint(0, H * W, (n,), generator=g, device=dev)
    flux = 10 ** (2.5 + 2.0 * torch.rand((n,), generator=g, device=dev))
    pts = torch.zeros(H * W, device=dev).index_add_(0, pos, flux)
    ax = torch.arange(-6, 7, dtype=torch.float32, device=dev)
    k = torch.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / 4.5)
    blur = torch.nn.functional.conv2d(pts.reshape(1, 1, H, W),
                                      (k / k.sum())[None, None], padding=6)
    return (img + blur[0, 0]).contiguous()


@pytest.mark.parametrize('field,H,W', [
    ('crowded', 512, 520), ('crowded', 3080, 3072), ('blank', 3080, 3072),
    ('nan_near_peak', 200, 136), ('offset', 256, 256), ('bytes', 97, 100)])
def test_stamp_candidates_kernel_fields(dev, field, H, W):
    """H7 on a crowded frame (most warps with a passing lane), a blank one
    (no candidate), NaN within 4 px of peaks, a view at a one-element
    offset (one-float copies) and W % 16 != 0 (byte stores): cand, and filt
    at the candidates, bit-equal to the plain version."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import background, measure
    if field == 'crowded':
        img = _crowded_field(H, W, dev, 5, 0.01)
    elif field == 'blank':
        g = torch.Generator(device=dev).manual_seed(6)
        img = 150.0 + 5.0 * torch.randn((H, W), generator=g, device=dev)
    else:
        img = _stamp_field(H, W, dev, 12)
    med = background.frame_median_plain(img)
    sigma = 1.4826 * background.frame_median_plain(img, center=med)
    if field == 'nan_near_peak':
        pf, pc = measure.stamp_candidates_plain(img, med, sigma, 6e4, 5)
        ys, xs = torch.nonzero(pc, as_tuple=True)
        for i, (y, x) in enumerate(zip(ys.tolist()[::2], xs.tolist()[::2])):
            dy, dx = (i % 9) - 4, ((i * 5) % 9) - 4
            img[min(max(y + dy, 0), H - 1), min(max(x + dx, 0), W - 1)] = \
                float('nan')
    elif field == 'offset':
        flat = torch.empty(H * W + 1, device=dev)
        flat[1:] = img.reshape(-1)
        img = flat[1:].view(H, W)
    n0 = launch.stamp_candidates.launches
    kf, kc = launch.stamp_candidates(img, med, sigma, 6e4, 5)
    assert launch.stamp_candidates.launches == n0 + 1
    pf, pc = measure.stamp_candidates_plain(img, med, sigma, 6e4, 5)
    assert torch.equal(kc, pc)
    assert torch.equal(_bits(kf[kc]), _bits(pf[pc]))
    ncand = int(pc.sum())
    if field == 'blank':
        assert ncand == 0
    else:
        assert ncand > 10
    if field == 'crowded':
        from zuds_tpu_torch.ops.convolve import DEFAULT_FILTER, conv2_same
        thr = med + 10 * sigma
        assert float((conv2_same(img, DEFAULT_FILTER) > thr).float()
                     .mean()) > 0.05


@pytest.mark.parametrize('n', [1, 2, 7, 1023, 1025, 70001, 9461760])
def test_frame_median_kernel_sizes(dev, n):
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import background
    x = _rand((1, n), dev, n % 97, 5.0, 150.0)
    g = torch.Generator(device=dev).manual_seed(n)
    ok = torch.rand((1, n), generator=g, device=dev) > 0.2
    n0 = launch.frame_median.launches
    for o in (None, ok):
        k = launch.frame_median(x, o)
        p = background.frame_median_plain(x, o)
        assert torch.equal(k.isnan(), p.isnan()), (n, o is None)
        assert torch.equal(torch.nan_to_num(k), torch.nan_to_num(p))
    assert launch.frame_median.launches == n0 + 2


@pytest.mark.parametrize('iters', [1, 5, 7, 13])
def test_frame_median_kernel_iters(dev, iters):
    """Round counts that end on a pass of under six rounds (its bucket
    search differs from the six-round pass's), on a frame, a ::4 view with
    a mask and the |x - median| form."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import background
    frame = _rand((1200, 1100), dev, 31, 5.0, 150.0)
    frame[::97, ::89] += 3e4
    g = torch.Generator(device=dev).manual_seed(32)
    ok = torch.rand(frame.shape, generator=g, device=dev) > 0.1
    med = launch.frame_median(frame)
    n0 = launch.frame_median.launches
    cases = [(frame, None, None), (frame[::4, ::4], ok[::4, ::4], None),
             (frame, ok, med)]
    for i, (x, o, c) in enumerate(cases):
        k = launch.frame_median(x, o, c, iters)
        p = background.frame_median_plain(x, o, c, iters)
        assert torch.equal(k.isnan(), p.isnan()), i
        assert torch.equal(torch.nan_to_num(k), torch.nan_to_num(p)), i
    assert launch.frame_median.launches == n0 + len(cases)


def test_frame_median_kernel_views_and_edges(dev):
    """::4 views read in place, the center option, a mask with holes, all
    masked (NaN), one valid element, ties at mid and NaN values."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import background
    H, W = 3080, 3072
    frame = _rand((H, W), dev, 5, 5.0, 150.0)
    g = torch.Generator(device=dev).manual_seed(6)
    holes = torch.rand((H, W), generator=g, device=dev) > 0.3
    holes[1000:1400, :] = False
    sub, okv = frame[::4, ::4], holes[::4, ::4]
    assert not sub.is_contiguous()
    med = launch.frame_median(sub, okv)
    cases = [(sub, okv, None), (sub, None, med), (frame, holes, None),
             (frame, torch.zeros_like(holes), None)]
    one = torch.zeros_like(holes)
    one[7, 9] = True
    cases.append((frame, one, None))
    ties = torch.round(frame / 4.0) * 4.0       # many equal values
    cases += [(ties, None, None), (ties[::4, ::4], okv, None)]
    nanf = frame.clone()
    nanf[5, 5] = float('nan')
    cases += [(nanf, None, None), (nanf, holes, None)]
    # +-inf: one of each, then many -inf (every mid -inf)
    for vals in ((float('inf'),), (float('-inf'),),
                 (float('inf'), float('-inf'))):
        inff = frame.clone()
        for i, v in enumerate(vals):
            inff[11 + 4 * i, 13] = v
        cases += [(inff, None, None), (inff, holes, None)]
    manyinf = frame.clone()
    manyinf[:1600] = float('-inf')
    cases.append((manyinf, None, None))
    # values on the mids: integers in [0, 4096] with both ends present, so
    # every descent's 12 mids are integers that the data holds
    onmid = torch.randint(0, 4097, (H, W), generator=g, device=dev).float()
    onmid[0, 0], onmid[0, 1] = 0.0, 4096.0
    cases += [(onmid, None, None), (onmid, holes, None),
              (onmid[::4, ::4], okv, None)]
    n0 = launch.frame_median.launches
    for i, (x, o, c) in enumerate(cases):
        k = launch.frame_median(x, o, c)
        p = background.frame_median_plain(x, o, c)
        assert torch.equal(k.isnan(), p.isnan()), i
        assert torch.equal(torch.nan_to_num(k), torch.nan_to_num(p)), i
    assert bool(launch.frame_median(frame, torch.zeros_like(holes)).isnan())
    assert launch.frame_median.launches == n0 + len(cases) + 1


def test_compact_kernel_stamp_capacity(dev):
    """H6 at the stamp selector's capacity (4096, fill 0) with more
    candidates than slots."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import compact
    g = torch.Generator(device=dev).manual_seed(9)
    m = torch.rand(3080 * 3072, generator=g, device=dev) < 0.001
    assert int(m.sum()) > 4096
    k = launch.compact(m, 4096, 0)
    p = compact.compact_indices_plain(m, 4096, 0)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def test_select_stamps_card_equals_cpu(dev):
    from zuds_tpu_torch.ops import measure
    img = _stamp_field(600, 520, dev, 13)
    k = measure.select_stamps_device(img, smax=64, nreg=3, sat_level=6e4,
                                     margin=21)
    p = measure.select_stamps_device(img.cpu(), smax=64, nreg=3,
                                     sat_level=6e4, margin=21)
    for a, b in zip(k, p):
        assert torch.equal(a.cpu(), b)


def test_h7_h8_refuse_wrong_inputs(dev):
    from zuds_tpu_torch.kernels import launch
    img = torch.zeros((16, 16), device=dev)
    s = torch.zeros((), device=dev)
    with pytest.raises(TypeError):
        launch.stamp_candidates(img.double(), s, s, 1.0, 2)
    with pytest.raises(ValueError):
        launch.stamp_candidates(img, s[None], s, 1.0, 2)
    with pytest.raises(ValueError):
        launch.frame_median(img.reshape(-1), None)
    with pytest.raises(ValueError):
        launch.frame_median(img, None, iters=0)


def _warp_inputs(dev, H, W, seed):
    ref = _rand((H, W), dev, seed, 20.0, 150.0)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    bits = torch.randint(0, 1 << 16, (H, W), generator=g, device=dev,
                         dtype=torch.int32)
    mask = torch.where(torch.rand((H, W), generator=g, device=dev) < 0.03,
                       bits, 0).to(torch.int32)
    wgt = torch.rand((H, W), generator=g, device=dev) * 0.04 + 0.01
    wgt = torch.where(mask > 0, 0.0, wgt).contiguous()
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    u = (xx + 1.4 * torch.sin(yy / 230.0 + xx / 310.0) + 0.3).contiguous()
    v = (yy + 1.3 * torch.cos(xx / 190.0) - 0.2).contiguous()
    covb = torch.tensor([2.0, W - 30.0, 4.5, H - 70.0], device=dev)
    return ref, wgt, mask, u, v, covb


@pytest.mark.parametrize('H,W,window', [(3200, 3200, 2), (200, 136, 2),
                                        (97, 131, 3)])
def test_warp_kernel_two_planes(dev, H, W, window):
    """The second plane shares the taps of the first: both planes as the
    plain composition, and the one-plane launch bit-equal to the first
    plane, the mask and the coverage of the two-plane launch."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import resample
    ref, wgt, mask, u, v, covb = _warp_inputs(dev, H, W, 11)
    n0 = launch.warp.launches
    iw, ww, mw, cov = resample.warp_epoch(ref, wgt, mask, u, v, covb, window)
    assert launch.warp.launches == n0 + 1
    assert cov.dtype == torch.bool and mw.dtype == torch.int32
    piw, pww, pmw, pcov = resample.warp_epoch_plain(ref, wgt, mask, u, v,
                                                    covb, window)
    _allclose(iw, piw, 3e-5, 5e-3)
    _allclose(ww, pww, 3e-5, 1e-6)
    assert torch.equal(mw, pmw) and torch.equal(cov, pcov)
    assert bool((ww >= 0).all()) and not bool(cov.all()) and bool(cov.any())
    one = launch.warp(ref, mask, u, v, covb, window)
    two = launch.warp(ref, mask, u, v, covb, window, ref2=wgt)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[2]) \
        and torch.equal(one[2], two[3])
    # the second plane is the first plane's arithmetic on other pixels
    swapped = launch.warp(wgt, mask, u, v, covb, window, ref2=ref)
    assert torch.equal(swapped[0], two[1]) and torch.equal(swapped[1], two[0])
    with pytest.raises(ValueError):
        launch.warp(ref, mask, u, v, covb, window, ref2=wgt[:, :-1])
    with pytest.raises(TypeError):
        launch.warp(ref, mask, u, v, covb, window, ref2=wgt.double())


def _combine_stack(dev, n, H, W, seed):
    """A warped stack with zero-weight regions, pixels no epoch covers,
    outliers, exact ties between epochs and a pixel on its clip threshold."""
    g = torch.Generator(device=dev).manual_seed(seed)
    imgs = 100.0 + 5.0 * torch.randn((n, H, W), generator=g, device=dev)
    w = torch.rand((n, H, W), generator=g, device=dev) * 0.04 + 0.02
    w = torch.where(torch.rand((n, H, W), generator=g, device=dev) < 0.15,
                    0.0, w)
    w[:, :3, :] = 0.0                    # no epoch has data
    w[0, 3:9, :] = 0.0                   # the other parity of the count
    imgs = torch.where(torch.rand((n, H, W), generator=g, device=dev) < 0.01,
                       imgs + 300.0, imgs)
    imgs[:, 12:16, :] = imgs[0, 12:16, :].clone()   # every epoch ties
    if n > 1:
        imgs[1, 16:20, :] = imgs[0, 16:20, :].clone()   # two tie
    masks = torch.randint(0, 1 << 16, (n, H, W), generator=g, device=dev,
                          dtype=torch.int32)
    masks = torch.where(torch.rand((n, H, W), generator=g, device=dev) < 0.5,
                        masks, 0x7FFF).to(torch.int32)
    cov = torch.rand((n, H, W), generator=g, device=dev) < 0.8
    cov[:, :, :2] = False                # no epoch covers
    scales = torch.rand(n, generator=g, device=dev) * 0.3 + 0.2
    return imgs.contiguous(), w.contiguous(), masks, cov, scales


@pytest.mark.parametrize('scaled', [False, True])
@pytest.mark.parametrize('n', [1, 2, 7, 8, 9, 16, 17, 33, 64])
def test_clipped_combine_kernel(dev, n, scaled):
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import coadd
    H, W = 61, 131
    imgs, w, masks, cov, scales = _combine_stack(dev, n, H, W, 100 + n)
    sc = scales if scaled else None
    n0 = launch.clipped_combine.launches
    k = coadd.clipped_combine(imgs, w, masks, cov, sc)
    assert launch.clipped_combine.launches == n0 + 1
    p = coadd.clipped_combine_plain(imgs, w, masks, cov, sc)
    assert set(k) == set(p) == {'coadd', 'weight', 'nclip', 'nexp', 'mask'}
    for key in p:
        assert k[key].dtype == p[key].dtype and k[key].shape == p[key].shape
    assert torch.equal(k['nexp'], p['nexp'])
    assert torch.equal(k['mask'], p['mask'])
    tie = k['nclip'] != p['nclip']
    assert int(tie.sum()) <= 1e-5 * H * W + 1, int(tie.sum())
    _allclose(k['weight'][~tie], p['weight'][~tie], 2e-6, 0.0)
    _allclose(k['coadd'][~tie], p['coadd'][~tie], 2e-6, 0.0)
    # the stack exercises what it should
    assert bool((k['nexp'] == 0).any())
    # no epoch covers the first two columns: no bit but the no-data bit,
    # which stands exactly where no weight was summed
    assert bool((k['mask'][:, :2] & 0xFFFF == 0).all())
    assert torch.equal((k['mask'] >> 16 & 1) == 1, k['weight'] == 0)
    assert bool((k['coadd'][k['nexp'] == 0] == 0).all())
    if n > 2:
        assert bool((k['nclip'] > 0).any())
    if not scaled:      # epochs with the same value are all kept
        assert bool((k['nclip'][12:16] == 0).all())


@pytest.mark.parametrize('shape', [(61, 131), (64, 132)])
@pytest.mark.parametrize('scaled', [False, True])
@pytest.mark.parametrize('n', [1, 8, 16, 17, 32, 33, 50, 64])
def test_clipped_combine_kernel_bit_equal(dev, n, scaled, shape):
    """H9 at every bucket and both sides of each edge, on stacks with NaN
    and +-inf at weight > 0 (some at the median), epochs without weight
    and a pixel whose every epoch is -0: all five outputs bit-equal to the
    plain version (NaN where it has NaN), through the element-wise loads
    (61 x 131 pixels, not a multiple of the pixels a thread takes) and
    the vector loads (64 x 132)."""
    from zuds_tpu_torch.ops import coadd
    H, W = shape
    imgs, w, masks, cov, scales = _combine_stack(dev, n, H, W, 300 + n)
    half = n // 2 + 1
    imgs[:half, 20, :8] = float('nan')          # at the median
    imgs[:half, 20, 8:16] = float('inf')
    imgs[n - 1, 21, :8] = float('nan')          # one epoch
    imgs[n - 1, 21, 8:16] = -float('inf')
    w[:, 20:22, :16] = 0.03
    w[n // 2:, 20:22, 4:16:2] = 0.0
    imgs[:, 22, :4] = -0.0
    w[:, 22, :4] = 0.0625
    sc = scales if scaled else None
    k = coadd.clipped_combine(imgs, w, masks, cov, sc)
    p = coadd.clipped_combine_plain(imgs, w, masks, cov, sc)
    for key in p:
        a, b = k[key], p[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if a.is_floating_point():
            assert torch.equal(a.isnan(), b.isnan()), key
            a, b = a.nan_to_num(0.0), b.nan_to_num(0.0)
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (key, int((a != b).sum()))


def test_clipped_combine_kernel_on_the_threshold(dev):
    """Third epochs exactly on the clip threshold are kept and one ulp past
    it clipped, with weights of 1/16 (sigma exactly 4)."""
    from zuds_tpu_torch.ops import coadd
    rng = np.random.default_rng(5)
    f4 = np.float32
    med = rng.uniform(8.0, 60.0, 4000).astype('f4')
    tol = (f4(4.0) * f4(4.0) + f4(0.3) * np.abs(med)).astype('f4')
    on = (med + tol).astype('f4')
    past = np.nextafter(on, f4(np.inf))
    exact = ((on - med).astype('f4') == tol) \
        & ((past - med).astype('f4') > tol)
    med, on, past = med[exact], on[exact], past[exact]
    n = len(med)
    imgs = torch.as_tensor(np.stack(
        [np.concatenate([med - 1, med - 1]), np.concatenate([med, med]),
         np.concatenate([on, past])])[:, None, :]).to(dev).contiguous()
    w = torch.full_like(imgs, 1.0 / 16.0)
    m = torch.zeros(imgs.shape, dtype=torch.int32, device=dev)
    k = coadd.clipped_combine(imgs, w, m, m == 0)
    p = coadd.clipped_combine_plain(imgs, w, m, m == 0)
    assert bool((k['nclip'][0, :n] == 0).all())
    assert bool((k['nclip'][0, n:] == 1).all())
    for key in p:
        assert torch.equal(k[key], p[key]), key


def test_h9_refuses_wrong_inputs(dev):
    from zuds_tpu_torch.kernels import launch
    imgs, w, masks, cov, scales = _combine_stack(dev, 65, 8, 8, 1)
    with pytest.raises(ValueError, match='1 to 64 epochs'):
        launch.clipped_combine(imgs, w, masks, cov, scales, 4.0, 0.3, 16)
    a = (imgs[:4], w[:4], masks[:4], cov[:4], scales[:4])
    launch.clipped_combine(*a, 4.0, 0.3, 16)
    for i, bad in ((0, imgs[:4].double()), (1, w[:3]), (2, masks[:4].long()),
                   (3, cov[:4].to(torch.uint8)), (4, scales[:3]),
                   (0, imgs[:4, :, ::2]), (0, imgs[:4].cpu())):
        args = list(a)
        args[i] = bad
        with pytest.raises((ValueError, TypeError)):
            launch.clipped_combine(*args, 4.0, 0.3, 16)


def test_background_and_median_on_the_coadd_canvas(dev):
    """H2 and H8 at 3200x3200, a shape that is not the quadrant's."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import background
    H = W = 3200
    img = _rand((H, W), dev, 21, 5.0, 150.0)
    g = torch.Generator(device=dev).manual_seed(22)
    valid = torch.rand((H, W), generator=g, device=dev) > 0.05
    valid[3080:, :] = False
    valid[:, 3072:] = False
    k = launch.background_cells(img, valid, 128, 3)
    p = background.background_cells_plain(img, valid, 128, 3)
    _allclose(k[0], p[0], 1e-4, 0.0)
    _allclose(k[1], p[1], 1e-4, 0.0)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.equal(k[2], p[2])
    sub, ok = img[::4, ::4], valid[::4, ::4]
    assert torch.equal(launch.frame_median(sub, ok),
                       background.frame_median_plain(sub, ok))


def _gather_inputs(dev, Hs, Ws, Ho, Wo, seed, rot_deg=7.0):
    img, wgt, mask, _, _, _ = _warp_inputs(dev, Hs, Ws, seed)
    yy = torch.arange(Ho, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(Wo, device=dev, dtype=torch.float32)[None, :]
    c, s_ = np.cos(np.deg2rad(rot_deg)), np.sin(np.deg2rad(rot_deg))
    u = (c * xx - 1.02 * s_ * yy + 0.07 * Ws + 0.3).contiguous()
    v = (s_ * xx + c * yy - 0.05 * Hs + 0.01 * xx - 0.7).contiguous()
    return img, wgt, mask, u, v


@pytest.mark.parametrize('Hs,Ws,Ho,Wo', [(200, 180, 160, 224),
                                         (97, 131, 140, 90),
                                         (3080, 3072, 3080, 3072)])
def test_warp_gather_kernel(dev, Hs, Ws, Ho, Wo):
    """H10 against the plain gather: every combination of planes and mask
    from one launch each, the planes' arithmetic shared."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import resample
    img, wgt, mask, u, v = _gather_inputs(dev, Hs, Ws, Ho, Wo, 21)
    n0 = launch.warp_gather.launches
    a, b, m, cov = resample.warp_gather(img, mask, u, v, img2=wgt)
    assert launch.warp_gather.launches == n0 + 1
    (pa, pb), pm, pcov = resample._gather_plain([img, wgt], mask, u, v)
    _allclose(a, pa, 3e-5, 5e-3)
    _allclose(b, pb, 3e-5, 1e-6)
    assert torch.equal(m, pm) and torch.equal(cov, pcov)
    assert a.shape == (Ho, Wo) and 0.2 < float(cov.mean()) < 0.98
    assert bool((a[cov == 0] == 0).all()) and bool((m[cov == 0] == 0).all())
    assert int((m != 0).sum()) > 100
    # the three entry points, one launch each, share the arithmetic
    n0 = launch.warp_gather.launches
    oi, oc = resample.warp_image(img, u, v)
    om = resample.warp_mask(mask, u, v)
    fi, fm, fc = resample.warp_image_mask(img, mask, u, v)
    assert launch.warp_gather.launches == n0 + 3
    assert torch.equal(oi, a) and torch.equal(fi, a) and torch.equal(oc, cov)
    assert torch.equal(om, m) and torch.equal(fm, m) and torch.equal(fc, cov)
    swapped = launch.warp_gather(wgt, None, u, v, img2=img)
    assert torch.equal(swapped[0], b) and torch.equal(swapped[1], a)
    assert swapped[2] is None


def test_warp_gather_kernel_edges(dev):
    """Mappings that leave the source, a non-finite tap outside the
    coverage (gated to 0 as the reference's select gates it) and a wild
    coordinate."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import resample
    img, _, mask, u, v = _gather_inputs(dev, 64, 80, 48, 48, 5, rot_deg=30.0)
    img = img.clone()
    img[2:8, 2:8] = float('nan')
    u[0, :4] = -20.0
    v[0, :4] = -20.0
    u[1, 0], v[1, 1] = 3e9, -3e9
    k = launch.warp_gather(img, mask, u, v)
    (pa,), pm, pcov = resample._gather_plain([img], mask, u, v)
    assert torch.equal(k[3], pcov) and torch.equal(k[2], pm)
    assert bool((k[0][0, :4] == 0).all()) and float(k[3][1, 0]) == 0.0
    fin = torch.isfinite(pa)
    assert torch.equal(torch.isfinite(k[0]), fin)
    _allclose(k[0][fin], pa[fin], 3e-5, 5e-3)
    with pytest.raises(ValueError):
        launch.warp_gather(None, None, u, v)
    with pytest.raises(ValueError):
        launch.warp_gather(None, mask, u, v, img2=img)
    with pytest.raises(ValueError):
        launch.warp_gather(img[:5], None, u, v)
    with pytest.raises(TypeError):
        launch.warp_gather(img, mask.to(torch.int64), u, v)
    with pytest.raises(ValueError):
        launch.warp_gather(img, mask[:, :-1].contiguous(), u, v)


@pytest.mark.parametrize('src,plan', [((256, 256), (1, -1, 2)),
                                      ((200, 180), (-37, -28, 4))])
def test_warp_planned_card_equals_cpu_composition(dev, src, plan):
    """warp_planned on the card (H1 on the rolled canvas) against the plain
    composition on the same tensors: pixels within the warp contract, mask
    and the original-frame coverage equal."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import resample
    img, wgt, mask, _, _, _ = _warp_inputs(dev, *src, 31)
    yy = torch.arange(256, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(256, device=dev, dtype=torch.float32)[None, :]
    u = (xx + plan[0] + 0.4 + 1.2 * torch.sin(yy / 90.0)).contiguous()
    v = (yy + plan[1] - 0.3 + 0.9 * torch.cos(xx / 70.0)).contiguous()
    n0 = launch.warp.launches
    k = resample.warp_planned(img, mask, u, v, plan, (256, 256), img2=wgt)
    assert launch.warp.launches == n0 + 1
    p = resample.warp_planned(img.cpu(), mask.cpu(), u.cpu(), v.cpu(), plan,
                              (256, 256), img2=wgt.cpu())
    _allclose(k[0].cpu(), p[0], 3e-5, 5e-3)
    _allclose(k[1].cpu(), p[1], 3e-5, 1e-6)
    assert torch.equal(k[2].cpu(), p[2]) and torch.equal(k[3].cpu(), p[3])
    assert 0 < float(k[3].mean()) < 1


def _h1_support_nonfinite(ref, u, v, window):
    """Where H1's own 6x6 support (first tap floor(d) - 2, wrapped rows and
    columns) holds a non-finite reference pixel."""
    H, W = ref.shape
    reach = window + 3
    yy = torch.arange(H, device=ref.device)[:, None]
    xx = torch.arange(W, device=ref.device)[None, :]
    bad = ~torch.isfinite(ref)

    def first(d):
        f = torch.fmin(torch.fmax(torch.floor(d), torch.tensor(
            -reach - 4.0, device=d.device)), torch.tensor(reach + 4.0,
                                                          device=d.device))
        return f.to(torch.int64) - 2
    dx0, dy0 = first(u - xx), first(v - yy)
    out = torch.zeros((H, W), dtype=torch.bool, device=ref.device)
    for ky in range(6):
        for kx in range(6):
            out |= bad[(yy + dy0 + ky) % H, (xx + dx0 + kx) % W]
    return out


@pytest.mark.parametrize('window,amp', [(8, (9.6, -10.4)), (2, (1.9, 1.7))])
def test_warp_kernel_wide_window_and_wild_displacement(dev, window, amp):
    """H1 at the widest window plan_warp gives (8: reach 11) and at the
    slice's, with wild displacements (past the clamp, NaN) in the mapping:
    pixels within the warp contract, mask and coverage bit-equal, two
    calls bit-equal, both planes."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import resample
    H, W = 240, 264
    ref, wgt, mask, _, _, _ = _warp_inputs(dev, H, W, 41)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    u = (xx + amp[0] * torch.sin(xx / 37.0 + 0.4)
         * torch.cos(yy / 29.0)).contiguous()
    v = (yy + amp[1] * torch.cos(xx / 31.0 - yy / 43.0)).contiguous()
    u[5, 7], v[9, 11], u[30, 40] = 1e6, -3e9, float('nan')
    u[60, 60], v[60, 60] = xx[0, 60] + 40.0, yy[60, 0] - 17.0
    covb = torch.tensor([3.0, W - 5.0, 2.5, H - 4.0], device=dev)
    k = launch.warp(ref, mask, u, v, covb, window, ref2=wgt)
    p = resample.warp_epoch_plain(ref, wgt, mask, u, v, covb, window)
    _allclose(k[0], p[0], 3e-5, 5e-3)
    _allclose(torch.clamp(k[1], min=0.0), p[1], 3e-5, 1e-6)
    assert torch.equal(k[2], p[2]) and torch.equal(k[3] > 0, p[3])
    assert float(k[0][60, 60]) == 0.0 or bool(k[3][60, 60] > 0)
    again = launch.warp(ref, mask, u, v, covb, window, ref2=wgt)
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    one = launch.warp(ref, mask, u, v, covb, window)
    assert torch.equal(one[0], k[0]) and torch.equal(one[1], k[2])


def test_warp_kernels_at_integer_and_half_phases(dev):
    """u and v at exact integers (a tap at t = 0, the others on the zeros
    of lanczos3) and at half-integers: H1 and H10 within the warp contract
    of their plain versions, masks and coverage bit-equal; at integer
    shifts both give the shifted source to rounding."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import resample
    H, W = 200, 216
    ref, _, mask, _, _, _ = _warp_inputs(dev, H, W, 43)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    covb = torch.tensor([2.0, W - 3.0, 2.0, H - 3.0], device=dev)
    for frac in (0.0, 0.5):
        u = (xx + torch.round(1.7 * torch.sin(yy / 21.0)) + frac).contiguous()
        v = (yy - torch.round(1.4 * torch.cos(xx / 17.0)) - frac) \
            .expand(H, W).contiguous()
        u = u.expand(H, W).contiguous()
        k = launch.warp(ref, mask, u, v, covb, 2)
        p = resample.warp_reference_plain(ref, mask, u, v, covb, 2)
        _allclose(k[0], p[0], 3e-5, 5e-3)
        assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
        g = launch.warp_gather(ref, mask, u, v)
        (pg,), pm, pc = resample._gather_plain([ref], mask, u, v)
        _allclose(g[0], pg, 3e-5, 5e-3)
        assert torch.equal(g[2], pm) and torch.equal(g[3], pc)
        if frac == 0.0:
            iu, iv = u.long().clamp(0, W - 1), v.long().clamp(0, H - 1)
            shifted = torch.where(pc > 0, ref[iv, iu], 0.0)
            _allclose(g[0], shifted, 1e-6, 1e-4)
            _allclose(k[0][k[2] > 0], ref[iv, iu][k[2] > 0], 1e-6, 1e-4)


@pytest.mark.parametrize('Hs,Ws,Ho,Wo', [(180, 150, 130, 250),
                                         (64, 300, 96, 96)])
def test_warp_gather_kernel_phases_and_other_source_shapes(dev, Hs, Ws, Ho,
                                                           Wo):
    """H10 into a source unlike the output in shape, at integer and
    half-integer phases and between: as the plain gather, two calls
    bit-equal."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import resample
    img, wgt, mask, _, _, _ = _warp_inputs(dev, Hs, Ws, 47)
    yy = torch.arange(Ho, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(Wo, device=dev, dtype=torch.float32)[None, :]
    for step in (1.0, 0.5, 0.37):
        u = (2.0 + (xx * step) % (Ws - 8) + 0.0 * yy).contiguous()
        v = (2.5 + (yy * step * 0.5) % (Hs - 8) + 0.0 * xx).contiguous()
        k = launch.warp_gather(img, mask, u, v, img2=wgt)
        (pa, pb), pm, pc = resample._gather_plain([img, wgt], mask, u, v)
        _allclose(k[0], pa, 3e-5, 5e-3)
        _allclose(k[1], pb, 3e-5, 1e-6)
        assert torch.equal(k[2], pm) and torch.equal(k[3], pc)
        assert bool(pc.all())
        again = launch.warp_gather(img, mask, u, v, img2=wgt)
        assert all(torch.equal(a, b) for a, b in zip(k, again))


def test_warp_kernels_non_finite_pixels(dev):
    """A NaN and an Inf reference pixel. H10's non-finite outputs are
    exactly the plain gather's (both read the 6x6 support). H1 reads its
    6x6 support, as before; the plain version's rolls read the whole
    (2 reach + 1)^2 window, so H1's non-finite outputs are exactly those
    whose support holds one, inside the coverage, all of them non-finite
    in the plain version too; the finite pixels within the warp
    contract."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import resample
    H, W = 160, 176
    ref, _, mask, u, v, covb = _warp_inputs(dev, H, W, 53)
    ref = ref.clone()
    ref[70, 80] = float('nan')
    ref[40, 120] = float('inf')
    ref[100, 30] = float('-inf')
    covb = torch.tensor([2.0, W - 3.0, 2.0, H - 3.0], device=dev)
    k = launch.warp(ref, mask, u, v, covb, 2)
    p = resample.warp_reference_plain(ref, mask, u, v, covb, 2)
    c = k[2] > 0
    want = _h1_support_nonfinite(ref, u, v, 2) & c
    got = ~torch.isfinite(k[0])
    assert torch.equal(got, want) and int(got.sum()) >= 3 * 30
    assert bool((~torch.isfinite(p[0])[got]).all())
    fin = torch.isfinite(p[0]) & ~got
    _allclose(k[0][fin], p[0][fin], 3e-5, 5e-3)
    assert bool((k[0][~c] == 0).all())
    g = launch.warp_gather(ref, mask, u, v)
    (pg,), _, _ = resample._gather_plain([ref], mask, u, v)
    assert torch.equal(torch.isfinite(g[0]), torch.isfinite(pg))
    fin = torch.isfinite(pg)
    _allclose(g[0][fin], pg[fin], 3e-5, 5e-3)


def test_warp_kernels_no_further_from_float64_than_plain(dev):
    """On a star field at 1024^2 (cores to 1e5 counts): H1 (one and two
    planes, the slice's smooth field) and H10 (a 0.5 degree rotation, one
    and two planes) no further from their plain versions run in float64
    than the f32 plain versions are."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import resample
    from zuds_tpu_torch.bench_warp import star_field
    H = W = 1024
    ref = torch.as_tensor(star_field(H, W, 61, nstar=150), device=dev)
    wgt = (0.01 + 0.04 * torch.rand((H, W), device=dev,
                                    generator=torch.Generator(
                                        device=dev).manual_seed(62)))
    mask = torch.zeros((H, W), dtype=torch.int32, device=dev)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    u = (xx + 1.9 * torch.sin(xx / 41.0 + 0.3)
         * torch.cos(yy / 53.0 - 0.3)).contiguous()
    v = (yy + 1.7 * torch.sin(xx / 41.0 + 1.1)
         * torch.cos(yy / 53.0 - 1.1)).contiguous()
    covb = torch.tensor([8.0, W - 9.0, 8.0, H - 9.0], device=dev)
    d = lambda t: t.double()  # noqa: E731
    k = launch.warp(ref, mask, u, v, covb, 2, ref2=wgt)
    p = resample.warp_epoch_plain(ref, wgt, mask, u, v, covb, 2)
    p64 = resample.warp_epoch_plain(d(ref), d(wgt), mask, d(u), d(v),
                                    d(covb), 2)
    c = p[3]
    for kk, pp, qq in ((k[0], p[0], p64[0]),
                       (torch.clamp(k[1], min=0.0), p[1], p64[1])):
        ek = float((d(kk) - qq).abs()[c].max())
        ep = float((d(pp) - qq).abs()[c].max())
        assert ek <= ep, (ek, ep)
    ang = np.deg2rad(0.5)
    ur = (np.cos(ang) * xx - np.sin(ang) * yy + 3.3).contiguous()
    vr = (np.sin(ang) * xx + np.cos(ang) * yy - 4.6).contiguous()
    g = launch.warp_gather(ref, None, ur, vr, img2=wgt)
    (pa, pb), _, pc = resample._gather_plain([ref, wgt], None, ur, vr)
    (qa, qb), _, _ = resample._gather_plain([d(ref), d(wgt)], None, d(ur),
                                            d(vr))
    c = pc > 0
    for kk, pp, qq in ((g[0], pa, qa), (g[1], pb, qb)):
        ek = float((d(kk) - qq).abs()[c].max())
        ep = float((d(pp) - qq).abs()[c].max())
        assert ek <= ep, (ek, ep)


@pytest.mark.parametrize('H,W,K,nreg', [(200, 136, 9, 1), (264, 256, 15, 3),
                                        (97, 131, 31, 2)])
def test_apply_model_variance_kernel(dev, H, W, K, nreg):
    """H3 at one term with squared centre kernels against the plain
    variance propagation, held on the variance's scale."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import subtract
    basis = subtract.KernelBasis(K, seeing_sigma=K / 10.0)
    tables = [torch.as_tensor(t, device=dev)
              for t in (basis.gx, basis.gy, basis.sums, basis.b0_2d)]
    order = 2
    nm = len(subtract.spatial_terms(order))
    rng = np.random.default_rng(K)
    c = rng.normal(0, 0.01, (nreg * nreg, basis.nbasis * nm + 1))
    c[:, 0] += 1.0
    coeffs = torch.as_tensor(c, dtype=torch.float32, device=dev)
    ref_rms = 3.0 + _rand((H, W), dev, 7, 0.3).abs() \
        + torch.sin(torch.arange(W, device=dev) / 40.0)[None, :]
    n0 = launch.apply_model_variance.launches
    m0 = launch.apply_model.launches
    k = subtract.propagate_ref_var(ref_rms, coeffs, *tables, order=order,
                                   nreg=nreg)
    assert launch.apply_model_variance.launches == n0 + 1
    assert launch.apply_model.launches == m0
    kerns = subtract.center_kernels(coeffs, *tables, order=order, nreg=nreg)
    p = subtract.propagate_ref_var_plain(ref_rms, kerns)
    scale = float(p.abs().max())
    _allclose(k, p, 1e-4, 1e-3 * scale)
    assert float((k - p).abs().max()) < 1e-4 * scale
    assert bool((k > 0).all())


def _one_term_inputs(dev, H, W, K, nreg, seed):
    """Seeded order-0 coefficients and a star field for H3 at one term."""
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.ops import subtract
    b = inputs.KernelBasis(K, K / 10.0)
    tables = [torch.as_tensor(a, device=dev)
              for a in (b.gx, b.gy, b.sums, b.b0_2d)]
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 0.01, (nreg * nreg, b.nbasis + 1))
    c[:, 0] += 1.0
    c[:, -1] = rng.normal(0, 3, nreg * nreg)
    coeffs = torch.as_tensor(c, dtype=torch.float32, device=dev)
    ref = _rand((H, W), dev, seed, 30.0, 150.0)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    for x0, y0 in rng.uniform(0, 1, (8, 2)) * [W, H]:
        ref += 3000 * torch.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / 4.0)
    return subtract, tables, coeffs, ref


@pytest.mark.parametrize('kind', ['model', 'variance'])
@pytest.mark.parametrize('H,W,K,nreg', [
    (200, 136, 9, 1), (211, 147, 9, 3),     # ragged: not a tile multiple
    (264, 250, 15, 3), (97, 131, 31, 1), (130, 190, 31, 3),
    (65, 33, 15, 3),    # regions narrower than K: border rows and windows
                        # across regions
])
def test_apply_one_term_kernel(dev, kind, H, W, K, nreg):
    """H3 at one term (the direct fp32 correlation): the variance
    propagation against its plain version, rtol 1e-4 and atol 1e-3 of the
    variance's scale; the order-0 model no further from the float64 plain
    model than the GEMM of two or more terms fed a zero second term (the
    one-term launch before the direct kernel), and within rtol 1e-4, atol
    1e-3 of the f32 plain model up to K = 15 (at K = 31 on these stars
    neither f32 form lies within 1e-3 of the other); the library launch
    into an output filled with NaN bit-equal to the wrapper's, and two
    calls bit-identical."""
    from zuds_tpu_torch.kernels import build, launch
    subtract, tables, coeffs, ref = _one_term_inputs(dev, H, W, K, nreg,
                                                     K + nreg)
    cx, cy, pexp, qexp, wx, wy = subtract.model_geometry(H, W, order=0,
                                                         nreg=nreg)
    if kind == 'model':
        n0 = launch.apply_model.launches
        k = subtract.apply_kernel_fast(ref, coeffs, *tables, order=0,
                                       nreg=nreg)
        assert launch.apply_model.launches == n0 + 1
        p = subtract.apply_kernel(ref, coeffs, *tables, order=0, nreg=nreg)
        if K <= 15:
            _allclose(k, p, 1e-4, 1e-3)
        src = ref
        kd = subtract.model_kernels(coeffs, *tables, order=0, nreg=nreg)
        bg = coeffs[:, -1].contiguous()
        p64 = subtract.apply_kernel(ref.double(), coeffs.double(),
                                    *(t.double() for t in tables), order=0,
                                    nreg=nreg)
        gemm = launch.apply_model(
            src, torch.cat([kd, torch.zeros_like(kd)], 1).contiguous(), bg,
            cx, cy, (0, 1), (0, 0), wx, wy)
        assert float((k.double() - p64).abs().max()) <= float(
            (gemm.double() - p64).abs().max())
    else:
        rms = 3.0 + ref.abs().sqrt() / 10.0
        n0 = launch.apply_model_variance.launches
        k = subtract.propagate_ref_var(rms, coeffs, *tables, order=0,
                                       nreg=nreg)
        assert launch.apply_model_variance.launches == n0 + 1
        kerns = subtract.center_kernels(coeffs, *tables, order=0, nreg=nreg)
        p = subtract.propagate_ref_var_plain(rms, kerns)
        scale = float(p.abs().max())
        _allclose(k, p, 1e-4, 1e-3 * scale)
        src = (rms ** 2).contiguous()
        kd = (kerns ** 2).reshape(nreg * nreg, 1, K, K).contiguous()
        bg = torch.zeros(nreg * nreg, device=dev)
    params = launch._apply_params(H, W, K, 1, cx, cy, pexp, qexp, wx, wy)
    for _ in range(2):
        out = torch.full_like(src, float('nan'))
        err = build.library().zuds_apply(
            launch._ptr(src), launch._ptr(kd), launch._ptr(bg),
            launch._ptr(out), ctypes.byref(params), launch._stream())
        build.check(err, 'zuds_apply')
        assert torch.equal(out, k)
    assert bool(torch.isfinite(k).all())


@pytest.mark.parametrize('order,kernel', [(0, 'apply_direct_kernel'),
                                          (1, 'apply_mma_kernel'),
                                          (4, 'apply_mma_kernel')])
def test_apply_routes_by_terms(dev, order, kernel):
    """One term (order 0) runs the direct kernel and nothing else; three
    and fifteen terms (orders 1 and 4) run the tensor-core GEMM only."""
    from torch.profiler import ProfilerActivity, profile
    subtract, tables, coeffs, ref = _one_term_inputs(dev, 128, 136, 15, 3,
                                                     21)
    nm = len(subtract.spatial_terms(order))
    coeffs = torch.cat([coeffs[:, :-1].repeat_interleave(nm, 1) / nm,
                        coeffs[:, -1:]], 1).contiguous()

    def run():
        return subtract.apply_kernel_fast(ref, coeffs, *tables, order=order,
                                          nreg=3)
    k = run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if 'apply_' in e.name]
    assert names and all(kernel in n for n in names), names
    p = subtract.apply_kernel(ref, coeffs, *tables, order=order, nreg=3)
    _allclose(k, p, 1e-4, 1e-3)
    assert torch.equal(run(), k)


@pytest.mark.parametrize('contract', [False, True])
@pytest.mark.parametrize('shape', [(200, 136), (3080, 3072), (1, 7)])
def test_subtract_epilogue_kernel(dev, shape, contract):
    """H11 bit-equal to its plain version, with and without a submask, in
    both rounding modes, and the two modes differ."""
    from zuds_tpu_torch.constants import BIG_RMS, SUB_NODATA_SENTINEL
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import subtract
    sci = _rand(shape, dev, 1, 20.0, 150.0)
    model = sci + _rand(shape, dev, 2, 5.0)
    sci_rms = 5.0 + _rand(shape, dev, 3, 0.3)
    ref_var = (3.0 + _rand(shape, dev, 4, 0.3)) ** 2
    g = torch.Generator(device=dev).manual_seed(5)
    bad = torch.rand(shape, generator=g, device=dev) < 0.05
    submask = torch.where(bad, 1 << 3, 0).to(torch.int32)
    model = torch.where(torch.rand(shape, generator=g, device=dev) < 0.01,
                        sci - SUB_NODATA_SENTINEL, model)
    n0 = launch.subtract_epilogue.launches
    k = subtract.subtract_epilogue(sci, model, sci_rms, ref_var, bad, submask,
                                   contract=contract)
    k2 = subtract.subtract_epilogue(sci, model, sci_rms, ref_var, bad,
                                    contract=contract)
    assert launch.subtract_epilogue.launches == n0 + 2
    p = subtract.subtract_epilogue_plain(sci, model, sci_rms, ref_var, bad,
                                         submask, contract=contract)
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(k2[0], k[0]) and torch.equal(k2[1], k[1])
    assert torch.equal(k[2] >> 17 & 1 == 1, k[0] == SUB_NODATA_SENTINEL)
    assert torch.equal(k[1] == BIG_RMS, bad)
    if sci.numel() > 1000:
        other = launch.subtract_epilogue(
            sci, model, sci_rms, ref_var, bad, SUB_NODATA_SENTINEL, BIG_RMS,
            contract=not contract)
        assert not torch.equal(other[1], k[1])
        assert torch.equal(other[0], k[0])


def test_h10_h11_refuse_wrong_inputs(dev):
    from zuds_tpu_torch.kernels import launch
    img = torch.zeros((16, 16), device=dev)
    bad = torch.zeros((16, 16), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match='CUDA'):
        launch.subtract_epilogue(img.cpu(), img, img, img, bad, 1e-30, 1.0)
    with pytest.raises(TypeError):
        launch.subtract_epilogue(img, img, img, img, bad.to(torch.uint8),
                                 1e-30, 1.0)
    with pytest.raises(ValueError):
        launch.subtract_epilogue(img, img[:8], img, img, bad, 1e-30, 1.0)
    with pytest.raises(TypeError):
        launch.subtract_epilogue(img, img, img, img, bad, 1e-30, 1.0,
                                 submask=bad)
    with pytest.raises(ValueError, match='CUDA'):
        launch.warp_gather(img.cpu(), None, img, img)
    with pytest.raises(ValueError):
        launch.apply_model_variance(img, torch.zeros((1, 4, 4), device=dev),
                                    [8.0], [8.0], 8.0, 8.0)


def test_per_pair_card_equals_cpu(dev, tmp_path):
    """from_images on a 256^2 pair rotated by 0.5 degrees, on the card and
    on the CPU: masks equal, header cards equal, the aligned reference
    within the warp contract."""
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.coadd import ReferenceImage
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.subtraction import SingleEpochSubtraction
    subs = {}
    for where in ('cuda', 'cpu'):
        d = tmp_path / where
        d.mkdir()
        work, _ = inputs.write_night_pairs(
            str(d), 1, 256, 256, ref_rot_deg=(0.5,), nstars=30,
            header_json=Path(__file__).resolve().parent / 'data'
            / 'ztf_real_header.json')
        sci_path, ref_path = work[0].split()
        sci = ScienceImage.from_file(sci_path)
        ref = ReferenceImage.from_file(ref_path)
        sub = SingleEpochSubtraction.from_images(sci, ref, device=where)
        subs[where] = (sub, ref.aligned_to(sci, device=where))
    (a, ra), (b, rb) = subs['cuda'], subs['cpu']
    assert np.array_equal(a.mask_image.data, b.mask_image.data)
    assert np.array_equal(ra.coverage, rb.coverage)
    assert np.abs(ra.data - rb.data).max() < 5e-3 + 3e-5 * np.abs(rb.data).max()
    for key in ('SUBKO', 'SUBNRX', 'SUBMETH', 'SEEING'):
        assert a.header[key] == b.header[key]


def test_pipeline_ref_rms_mesh_card_equals_cpu(dev):
    """The slice at ref_rms_mesh=True on the card (H3 at one term and H11
    in its noise stage) and on the CPU: submask equal, the noise map within
    1e-4, the planted sources at the same place."""
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.parallel import (PipelineConfig,
                                         SubtractDetectPipeline)
    cfg = PipelineConfig(height=256, width=256, ksize=9, stamp=25, smax=32,
                         order=2, nreg=2, max_det=128, box=64, deblend=False,
                         ref_rms_mesh=True)
    args, planted = inputs.plant_sources(
        inputs.synth_inputs(2, 256, 256, cfg, seed=0), n=3, flux=2e4, seed=1)
    pipe = SubtractDetectPipeline(cfg)
    n0 = (launch.apply_model_variance.launches,
          launch.subtract_epilogue.launches)
    card = pipe(*inputs.to_torch(args, dev))
    assert launch.apply_model_variance.launches == n0[0] + 2
    assert launch.subtract_epilogue.launches == n0[1] + 2
    cpu = pipe(*inputs.to_torch(args, 'cpu'))
    assert torch.equal(card['submask'].cpu(), cpu['submask'])
    ok = cpu['submask'] == 0
    _allclose(card['rms'].cpu()[ok], cpu['rms'][ok], 1e-4, 0.0)
    assert torch.equal(card['rms'].cpu()[~ok], cpu['rms'][~ok])
    for b in range(2):
        v = card['det_valid'][b].cpu()
        x, y = card['det_x'][b].cpu()[v], card['det_y'][b].cpu()[v]
        for px, py in planted[b]:
            assert float(((x - px) ** 2 + (y - py) ** 2).min()) <= 1.0


def _positions(H, W, n, seed):
    """n positions over an H x W frame, a sixth of them past an edge."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-3, W + 2, n)
    ys = rng.uniform(-3, H + 2, n)
    xs[::6], ys[1::6] = 0.3, H - 0.6
    return xs, ys


@pytest.mark.parametrize('H,W,n', [(200, 180, 48), (63, 70, 5),
                                   (3080, 3072, 256), (3080, 3071, 1),
                                   (65, 3071, 5), (3080, 3071, 2048)])
def test_triplet_cut_kernel(dev, H, W, n):
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import cutouts
    frames = [_rand((H, W), dev, 20 + k, 5.0, 150.0 * (k < 2))
              for k in range(3)]
    xs, ys = _positions(H, W, n, 21)
    x0, y0 = cutouts.clamped_corners(
        torch.as_tensor(xs, dtype=torch.float32, device=dev),
        torch.as_tensor(ys, dtype=torch.float32, device=dev), 63, H, W)
    n0 = launch.triplet_cut.launches
    k = cutouts.triplet_cut(*frames, x0, y0)
    assert launch.triplet_cut.launches == n0 + 1
    p = cutouts.triplet_cut_plain(*frames, x0, y0)
    assert k.shape == p.shape == (n, 63, 63, 3)
    _allclose(k, p, 1e-6, 0.0)
    assert torch.equal(k, cutouts.triplet_cut(*frames, x0, y0))
    # an all-zero window divides by the floor, not by zero
    z = torch.zeros((H, W), device=dev)
    assert torch.equal(cutouts.triplet_cut(z, z, z, x0, y0),
                       torch.zeros_like(k))


def test_negpix_veto_kernel(dev):
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import cutouts
    H, W = 300, 280
    img = _rand((H, W), dev, 30, 5.0, 100.0)
    xs, ys = _positions(H, W, 96, 31)
    for i, (x, y) in enumerate(zip(xs, ys)):
        cx = int(np.clip(round(x), 7, W - 8))
        cy = int(np.clip(round(y), 7, H - 8))
        if i % 3 == 0:
            img[cy, cx], img[cy + 1, cx - 1] = 40.0, 170.0
        elif i % 3 == 1:
            img[cy, cx] = 40.0
    img[5, 5] = float('nan')
    med = cutouts.frame_median_exact(img)
    sig = 1.48 * cutouts.frame_median_exact((img - med).abs())
    x0, y0 = cutouts.clamped_corners(
        torch.as_tensor(xs, dtype=torch.float32, device=dev),
        torch.as_tensor(ys, dtype=torch.float32, device=dev), 13, H, W)
    n0 = launch.negpix_veto.launches
    k = cutouts.negpix_veto(img, med, sig, x0, y0)
    assert launch.negpix_veto.launches == n0 + 1
    p = cutouts.negpix_veto_plain(img, med, sig, x0, y0)
    assert k.dtype == torch.bool and torch.equal(k, p)
    assert 0 < int(k.sum()) < len(xs)


def _negpix_frame(dev, H, W, x0, y0, seed):
    """A noise frame about 100 with a -/+ pair (40 and 170 against a
    sigma of ~5) at every third window's centre, a lone low pixel at every
    third one more, a pair with a NaN beside its low pixel (no veto: the
    maximum is NaN), and the frame's median and 1.48 MAD."""
    from zuds_tpu_torch.ops import cutouts
    img = _rand((H, W), dev, seed, 5.0, 100.0)
    cx, cy = x0.long() + 6, y0.long() + 6
    img[cy[::3], cx[::3]] = 40.0
    img[cy[::3] + 1, cx[::3] - 1] = 170.0
    img[cy[1::3], cx[1::3]] = 40.0
    if len(cx) > 2:                     # a NaN among the neighbours
        img[cy[2] - 1, cx[2]] = float('nan')
        img[cy[2], cx[2]] = 40.0
        img[cy[2] + 1, cx[2] + 1] = 170.0
    med = cutouts.frame_median_exact(img)
    sig = 1.48 * cutouts.frame_median_exact((img - med).abs())
    return img, med, sig


def _negpix_rows(kind, H, W, n, seed):
    """int32 corners (clamped) of n rows: ``distinct`` all different,
    ``repeated`` the slice's fill (rows past n // 3 at the last row's
    corner) with a repeat in the middle and a fill row among the first,
    ``one`` every row at one corner."""
    rng = np.random.default_rng(seed)
    flat = rng.choice((H - 12) * (W - 12), n, replace=False)
    y0, x0 = (flat // (W - 12)).astype('i4'), (flat % (W - 12)).astype('i4')
    if kind == 'repeated':
        x0[n // 3:], y0[n // 3:] = x0[-1], y0[-1]
        x0[5:9], y0[5:9] = x0[4], y0[4]
        x0[min(10, n - 1)], y0[min(10, n - 1)] = x0[-1], y0[-1]
    elif kind == 'one':
        x0[:], y0[:] = x0[0], y0[0]
    return x0, y0


@pytest.mark.parametrize('kind,H,W,n', [
    ('distinct', 3080, 3072, 4096), ('repeated', 3080, 3072, 4096),
    ('repeated', 300, 280, 100), ('one', 300, 280, 4096),
    ('one', 300, 280, 1), ('distinct', 63, 70, 5), ('repeated', 200, 180, 5000)])
def test_negpix_veto_kernel_rows(dev, kind, H, W, n):
    """H14 on repeated corners (the slice's fill, a repeat in the middle,
    every row one corner), on all-distinct corners and at N = 1: bit-equal
    to the plain version, and 20 launches into poisoned verdicts each
    bit-equal to the wrapper's."""
    from zuds_tpu_torch.kernels import build, launch
    from zuds_tpu_torch.ops import cutouts
    x0, y0 = (torch.as_tensor(v, device=dev)
              for v in _negpix_rows(kind, H, W, n, 33))
    img, med, sig = _negpix_frame(dev, H, W, x0, y0, 34)
    for last_hit in (False, True):
        if last_hit:                    # the last row's window vetoed
            img[int(y0[-1]) + 3, int(x0[-1]) + 3] = 40.0
            img[int(y0[-1]) + 2, int(x0[-1]) + 4] = 170.0
        k = launch.negpix_veto(img, med, sig, x0, y0)
        p = cutouts.negpix_veto_plain(img, med, sig, x0, y0)
        assert torch.equal(k, p)
        assert bool(k[-1]) or not last_hit
        for _ in range(20):
            out = torch.full((n,), 0x5a, dtype=torch.uint8, device=dev)
            err = build.library().zuds_negpix_veto(
                launch._ptr(img), W, launch._ptr(med), launch._ptr(sig),
                launch._ptr(x0), launch._ptr(y0), n, launch._ptr(out),
                launch._stream())
            build.check(err, 'zuds_negpix_veto')
            assert torch.equal(out.view(torch.bool), k)
    if n > 10:
        assert 0 < int(k.sum()) < n or kind == 'one'


@pytest.mark.parametrize('i', range(4))
def test_braai_conv3x3_kernel(dev, i):
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import braai
    cin, cout, pool = launch.BRAAI_LAYERS[i]
    side = (63, 61, 29, 27)[i]
    x = _rand((7, side, side, cin), dev, 40 + i, 0.05).abs()
    w = _rand((3, 3, cin, cout), dev, 50 + i, (1.0 / (9 * cin)) ** 0.5)
    b = _rand((cout,), dev, 60 + i, 0.01)
    n0 = launch.braai_conv3x3.launches
    k = braai.conv3x3(x, w, b, pool)
    assert launch.braai_conv3x3.launches == n0 + 1
    p = braai.conv3x3_plain(x, w, b, pool)
    assert k.shape == p.shape
    _allclose(k, p, 1e-5, 1e-6)
    # a NaN input pixel: NaN on exactly the outputs whose 3x3 window (and
    # 2x2 pool) holds it, as the reference's sums, ReLU and max carry it
    # (cuDNN's transforms may spread it further, so not held to cuDNN)
    x[3, 4, 5, 0] = float('nan')
    k = braai.conv3x3(x, w, b, pool)
    want = F.max_pool2d(x.isnan().any(-1).float()[:, None], 3, 1)
    if pool:
        want = F.max_pool2d(want, 2, 2)
    want = want[:, 0] > 0
    assert torch.equal(k.isnan().any(-1), want)
    assert torch.equal(k.isnan().all(-1), want)
    assert torch.equal(k[~want], braai.conv3x3(
        torch.nan_to_num(x, nan=0.0), w, b, pool)[~want])


@pytest.mark.parametrize('i', range(4))
def test_braai_conv3x3_kernel_inf_and_repeat(dev, i):
    """H13 with a +inf and a -inf input value (one channel each, far
    apart): +-inf and NaN exactly where the plain version puts them (the
    3xTF32 split keeps a non-finite value whole in its lo part, and the
    flush drops a non-finite compensation); two calls of H13 and of H13t
    give the same bits."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import braai
    cin, cout, pool = launch.BRAAI_LAYERS[i]
    side = (63, 61, 29, 27)[i]
    x = _rand((5, side, side, cin), dev, 70 + i, 0.05).abs()
    w = _rand((3, 3, cin, cout), dev, 75 + i, (1.0 / (9 * cin)) ** 0.5)
    b = _rand((cout,), dev, 78 + i, 0.01)
    x[1, 3, 4, 0] = float('inf')
    x[2, side - 5, side - 4, cin - 1] = float('-inf')
    k = launch.braai_conv3x3(x, w, b, pool)
    p = braai.conv3x3_plain(x, w, b, pool)
    assert torch.equal(k.isnan(), p.isnan())
    assert torch.equal(k.isposinf(), p.isposinf())
    fin = torch.isfinite(p)
    assert bool((~fin).any()) and bool(torch.isfinite(k[fin]).all())
    _allclose(k[fin], p[fin], 1e-5, 1e-6)
    assert torch.equal(k, launch.braai_conv3x3(x, w, b, pool))
    mask = None
    if pool:
        g = torch.Generator(device=dev).manual_seed(79 + i)
        mask = torch.rand(k.shape, generator=g, device=dev) < 0.75
    t1 = launch.braai_conv3x3_train(x, w, b, pool, mask, 0.75)
    t2 = launch.braai_conv3x3_train(x, w, b, pool, mask, 0.75)
    assert torch.equal(t1[0], t2[0])
    assert (t1[1] is None and t2[1] is None) or torch.equal(t1[1], t2[1])


@pytest.mark.parametrize('seed', range(4))
@pytest.mark.parametrize('i', range(4))
def test_braai_conv3x3_no_further_from_float64_than_cudnn(dev, i, seed):
    """Each H13 layer at the scoring path's batch of 256, on the spread
    seed-0 weights and ``labelled_triplets(256, seed)``, against a float64
    convolution: its largest error is at most cuDNN's (TF32 off) plus half
    an ulp of the layer's largest output. Not at every batch: at 16
    (seed 5) cuDNN came out nearer float64 at layers 3 and 4 on an H100,
    by more than that (7.4e-7 against 5.2e-7, 1.01e-6 against 6.5e-7);
    ``chip_smoke.py`` prints that case each run."""
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import braai
    assert not torch.backends.cudnn.allow_tf32
    model, params = braai.init_braai(0, device='cpu')
    model.load_params(inputs.spread_braai(params))
    model = model.to(dev)
    t, _ = inputs.labelled_triplets(256, seed=seed)
    x = torch.as_tensor(t, device=dev)
    with torch.no_grad():
        for j in range(i):
            layer = getattr(model, f'Conv_{j}')
            x = braai.conv3x3_plain(x, layer['kernel'], layer['bias'],
                                    launch.BRAAI_LAYERS[j][2])
    pool = launch.BRAAI_LAYERS[i][2]
    layer = getattr(model, f'Conv_{i}')
    w, b = layer['kernel'], layer['bias']
    k = launch.braai_conv3x3(x, w, b, pool)
    lib = braai.conv3x3_plain(x, w, b, pool)
    ref = braai.conv3x3_plain(x.double(), w.double(), b.double(), pool)
    ek = float((k.double() - ref).abs().max())
    el = float((lib.double() - ref).abs().max())
    half = float(np.spacing(np.float32(float(ref.abs().max())))) / 2
    assert ek <= el + half, (ek, el, half)


@pytest.mark.parametrize('i', (1, 3))
def test_braai_train_routing_off_only_at_near_ties(dev, i):
    """H13t's routing bytes at a batch of 32 against the plain version's:
    equal off the near ties, which stay under 1% of the windows."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import braai
    cin, cout, pool = launch.BRAAI_LAYERS[i]
    side = (63, 61, 29, 27)[i]
    x = _rand((32, side, side, cin), dev, 190 + i, 0.05).abs()
    w = _rand((3, 3, cin, cout), dev, 195 + i, (1.0 / (9 * cin)) ** 0.5)
    b = _rand((cout,), dev, 198 + i, 0.01)
    k, kr = launch.braai_conv3x3_train(x, w, b, pool)
    p, pr = braai.conv3x3_train_plain(x, w, b, pool)
    _allclose(k, p, 1e-5, 1e-6)
    r = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b)
    tie = _near_ties(r, F.max_pool2d(r, 2, 2), 1e-5 * float(r.abs().max()))
    assert torch.equal(kr[~tie], pr[~tie])
    assert float(tie.float().mean()) < 0.01


def test_braai_scores_card_equals_plain(dev):
    """The whole net, H13 four times and the dense head, against the
    plain layers on the card and against the CPU, at the spread weights."""
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import braai
    model, params = braai.init_braai(0, device='cpu')
    model.load_params(inputs.spread_braai(params))
    rng = np.random.default_rng(0)
    t = rng.normal(size=(33, 63, 63, 3)).astype('f4')
    t /= np.sqrt((t * t).sum((1, 2), keepdims=True))
    cpu = braai.rb_scores(model, t)
    model = model.to(dev)
    n0 = launch.braai_conv3x3.launches
    k = braai.rb_scores(model, t)
    assert launch.braai_conv3x3.launches == n0 + 4 and k.is_cuda
    with torch.no_grad():
        p = model.forward_plain(torch.as_tensor(t, device=dev))
    _allclose(k, p, 0.0, 1e-6)
    _allclose(k.cpu(), cpu, 0.0, 1e-6)


def test_h12_h13_h14_refuse_wrong_inputs(dev):
    from zuds_tpu_torch.kernels import launch
    img = torch.zeros((64, 64), device=dev)
    c = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        launch.triplet_cut(img[:40], img[:40], img[:40], c, c)
    with pytest.raises(TypeError):
        launch.triplet_cut(img, img, img, c.long(), c)
    s = torch.zeros((), device=dev)
    with pytest.raises(ValueError):
        launch.negpix_veto(img, s[None], s, c, c)
    x = torch.zeros((2, 61, 61, 32), device=dev)
    with pytest.raises(ValueError, match='not a layer'):
        launch.braai_conv3x3(x, torch.zeros((3, 3, 32, 32), device=dev),
                             torch.zeros(32, device=dev), False)
    misaligned = torch.zeros(2 * 61 * 61 * 32 + 1, device=dev)[1:]
    with pytest.raises(ValueError, match='aligned'):
        launch.braai_conv3x3(misaligned.reshape(2, 61, 61, 32),
                             torch.zeros((3, 3, 32, 32), device=dev),
                             torch.zeros(32, device=dev), True)


def test_filter_ml_card_equals_cpu(dev, tmp_path, monkeypatch):
    """filter_sexcat(ml=True, ml_frames=...) on the card (H12 once, H13 four
    times) and on the CPU: GOODCUT equal, RB within 1e-6."""
    from types import SimpleNamespace
    from zuds_tpu_torch import filterobjects, inputs
    from zuds_tpu_torch.catalog import CATALOG_DTYPE
    from zuds_tpu_torch.fits import Header
    from zuds_tpu_torch.models import braai
    from zuds_tpu_torch.wcs import TPVWCS
    model, params = braai.init_braai(0)
    braai.save_braai(inputs.spread_braai(params),
                     str(tmp_path / 'braai_d6_m9.npz'))
    helper = filterobjects.load_model_helper
    monkeypatch.setattr(filterobjects, 'load_model_helper',
                        lambda *a, **k: helper(str(tmp_path), **k))
    H, W = 300, 280
    wcs = TPVWCS.simple((150.1, 35.2), (W / 2 + 0.5, H / 2 + 0.5),
                        1.01 / 3600.0)
    xs, ys = _positions(H, W, 40, 70)
    frames = [SimpleNamespace(data=_rand((H, W), dev, 71 + k, 5.0)
                              .cpu().numpy(), wcs=wcs) for k in range(3)]
    cats = []
    for where in ('cuda', 'cpu'):
        data = np.zeros(len(xs), dtype=CATALOG_DTYPE)
        data['X_IMAGE'], data['Y_IMAGE'] = xs + 1, ys + 1
        data['X_WORLD'], data['Y_WORLD'] = wcs.pix2sky_0(xs, ys)
        data['A_IMAGE'] = data['B_IMAGE'] = 1.0
        data['FWHM_IMAGE'], data['FLUX_APER'] = 2.2, 1000.0
        data['FLUXERR_APER'] = 10.0
        hdr = Header()
        hdr.set('RMSMED', 2.0)
        cat = SimpleNamespace(data=data, header=hdr, ismapped=False,
                              image=SimpleNamespace(header={'SEEING': 2.0},
                                                    fid=2))
        n0 = launch_counts()
        filterobjects.filter_sexcat(cat, ml_frames=frames, device=where)
        if where == 'cuda':
            assert launch_counts() == (n0[0] + 1, n0[1] + 4)
        cats.append(cat.data)
    a, b = cats
    assert np.array_equal(a['GOODCUT'], b['GOODCUT'])
    assert (a['RB'] != -99).all()
    np.testing.assert_allclose(a['RB'], b['RB'], rtol=0, atol=1e-6)


# ---- ZOGY: H15-H18 ------------------------------------------------------------

def _gauss(dev, sigma, size=25):
    r = torch.arange(size, device=dev, dtype=torch.float32) - size // 2
    g = torch.exp(-(r[:, None] ** 2 + r[None, :] ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _spectra(dev, H, W, seed):
    from zuds_tpu_torch.ops import zogy
    new = _rand((H, W), dev, seed, 3.0)
    ref = _rand((H, W), dev, seed + 1, 3.0)
    # in rfft2's own layout, as ops.zogy hands them to H15 (cuFFT's may be
    # transposed)
    return (torch.fft.rfft2(new), torch.fft.rfft2(ref),
            zogy._psf_to_otf(_gauss(dev, 2.0), (H, W)),
            zogy._psf_to_otf(_gauss(dev, 1.5), (H, W)))


def _close_c(a, b, rtol):
    a, b = torch.view_as_real(a), torch.view_as_real(b)
    assert torch.equal(a.isnan(), b.isnan())
    ok = ~b.isnan()
    _allclose(a[ok], b[ok], rtol, 0.0)


@pytest.mark.parametrize('H,W', [(250, 197), (256, 256), (3080, 3072)])
def test_zogy_spectral_kernel(dev, H, W):
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import zogy
    N, R, Pn, Pr = _spectra(dev, H, W, 90)
    assert N.shape == (H, W // 2 + 1)
    sc = zogy.zogy_scalars(3.1, 2.7, 1.1, 0.9)
    # a band of modes where both OTFs are tiny: the clamp at 1e-12 max
    Pn[H // 3:H // 3 + 9] *= 1e-8
    Pr[H // 3:H // 3 + 9] *= 1e-8
    apr, apn = Pr.abs() ** 2, Pn.abs() ** 2
    den = sc['c_r'] * apr + sc['c_n'] * apn
    assert bool((den < 1e-12 * den.max()).any())
    n0 = launch.zogy_spectral.launches
    k = zogy.spectral_pass(N, R, Pn, Pr, **sc)
    assert launch.zogy_spectral.launches == n0 + 1
    p = zogy.spectral_pass_plain(N, R, Pn, Pr, **sc)
    for a, b in zip(k, p):
        assert a.shape == N.shape and a.dtype == torch.complex64
        assert a.stride() == N.stride()
        _close_c(a, b, 1e-6)
    # the same modes from row-major copies: H15 is elementwise, so the
    # layout changes nothing
    rows = launch.zogy_spectral(*(t.contiguous() for t in (N, R, Pn, Pr)),
                                **sc)
    for a, b in zip(rows, k):
        assert a.is_contiguous() and torch.equal(a, b)
    # a NaN in N: D_hat and S_hat NaN at that mode only; one in P_r:
    # max(denom) is NaN, so every mode is
    N[5, 7] = complex(float('nan'), 0.0)
    k = zogy.spectral_pass(N, R, Pn, Pr, **sc)
    p = zogy.spectral_pass_plain(N, R, Pn, Pr, **sc)
    for a, b in zip(k, p):
        _close_c(a, b, 1e-6)
    assert int(k[0].isnan().sum()) == 1 and not k[1].isnan().any()
    Pr[3, 4] = complex(float('nan'), 0.0)
    k = zogy.spectral_pass(N, R, Pn, Pr, **sc)
    assert all(bool(a.isnan().all()) for a in k)


@pytest.mark.parametrize('H,W', [(250, 197), (3080, 3072)])
def test_zogy_normalize_kernel(dev, H, W):
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import zogy
    p_d = _rand((H, W), dev, 81, 1e-3)
    s = _rand((H, W), dev, 82, 5.0)
    n0 = launch.zogy_normalize.launches
    k = zogy.score_normalize(p_d, s, 0.7)
    assert launch.zogy_normalize.launches == n0 + 1
    _allclose(k, zogy.score_normalize_plain(p_d, s, 0.7), 1e-6, 0.0)
    assert torch.equal(k, zogy.score_normalize(p_d, s, 0.7))
    z = torch.zeros_like(p_d)
    assert torch.equal(zogy.score_normalize(z, s, 0.7),
                       zogy.score_normalize_plain(z, s, 0.7))
    p_d[1, 2] = float('nan')
    assert bool(zogy.score_normalize(p_d, s, 0.7).isnan().all())


@pytest.mark.parametrize('offset', [0, 1])
@pytest.mark.parametrize('n', [1, 3, 1001, 250 * 197])
def test_zogy_normalize_lengths_and_offsets(dev, n, offset):
    """H16 at lengths that are no multiple of 4 (the floats past the
    16-byte chunks), under one block's slab, and at a storage offset 4
    bytes past a 16-byte boundary (the single-float path): within 1e-6
    relative of the plain version, two calls bit-equal, zeros clamped at
    1e-20 as in the plain version, a NaN in the last float spread."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import zogy
    p_d = _rand(n + offset, dev, 83, 1e-3)[offset:]
    s = _rand(n + offset, dev, 84, 5.0)[offset:]
    assert (p_d.data_ptr() % 16 == 0) == (offset == 0)
    k = launch.zogy_normalize(p_d, s, 0.7)
    _allclose(k, zogy.score_normalize_plain(p_d, s, 0.7), 1e-6, 0.0)
    assert torch.equal(k, launch.zogy_normalize(p_d, s, 0.7))
    z = torch.zeros(n + offset, device=dev)[offset:]
    assert torch.equal(launch.zogy_normalize(z, s, 0.7),
                       zogy.score_normalize_plain(z, s, 0.7))
    p_d[n - 1] = float('nan')
    assert bool(launch.zogy_normalize(p_d, s, 0.7).isnan().all())


def test_zogy_normalize_is_one_launch_without_a_memset(dev):
    """One H16 call is one kernel launch and no memset (the runtime calls
    the profiler records), and it can be captured in a CUDA graph (its
    replay gives the direct call's bits)."""
    from torch.profiler import ProfilerActivity, profile
    from zuds_tpu_torch.kernels import launch
    p_d = _rand((250, 197), dev, 85, 1e-3)
    s = _rand((250, 197), dev, 86, 5.0)
    want = launch.zogy_normalize(p_d, s, 0.7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        launch.zogy_normalize(p_d, s, 0.7)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert not any('memset' in n.lower() for n in names), names
    assert sum(n.startswith('cudaLaunch') for n in names) == 1, names
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch.zogy_normalize(p_d, s, 0.7)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch.zogy_normalize(p_d, s, 0.7)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _psf_field(dev, H, W, n, seed):
    """Stars of 3e4 (sigma 1.8, noise 1) at n seeded positions, three at a
    border (their corners clamp) and one in the corner (0, 0), where the
    four padding rows (valid False) cut."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(15, W - 15, n)
    ys = rng.uniform(15, H - 15, n)
    xs[:4], ys[:4] = (2.3, W - 1.7, 60.4, 11.8), (40.2, 90.6, 1.2, 12.3)
    yy, xx = np.mgrid[0:H, 0:W]
    img = rng.normal(0, 1.0, (H, W))
    for x, y in zip(xs, ys):
        img += 3e4 * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 6.48) \
            / (2 * np.pi * 3.24)
    xs = np.concatenate([xs, np.zeros(4)]).astype('f4')
    ys = np.concatenate([ys, np.zeros(4)]).astype('f4')
    valid = np.arange(n + 4) < n
    return [torch.as_tensor(a, device=dev) for a in (img.astype('f4'), xs,
                                                     ys, valid)]


@pytest.mark.parametrize('H,W,n,size', [(250, 197, 40, 25), (256, 256, 64, 25),
                                        (120, 131, 9, 15)])
def test_psf_stamps_kernel(dev, H, W, n, size):
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import zogy
    img, xs, ys, valid = _psf_field(dev, H, W, n, 91)
    n0 = launch.psf_stamps.launches
    k, kg = zogy.psf_stamps(img, xs, ys, valid, size)
    assert launch.psf_stamps.launches == n0 + 1
    p, pg = zogy.psf_stamps_plain(img, xs, ys, valid, size)
    assert k.shape == p.shape == (n + 4, size, size)
    assert kg.dtype == torch.bool and torch.equal(kg, pg)
    assert bool(pg[:n].all()) and not pg[n:].any()
    _allclose(k, p, 0.0, 1e-7)
    img[3, 3] = float('nan')
    k, kg = zogy.psf_stamps(img, xs, ys, valid, size)
    p, pg = zogy.psf_stamps_plain(img, xs, ys, valid, size)
    assert torch.equal(k.isnan(), p.isnan()) and torch.equal(kg, pg)
    assert bool(k[n:].isnan().all())


@pytest.mark.parametrize('S', [1, 300])
@pytest.mark.parametrize('size', [1, 24, 32])
def test_psf_stamps_sizes(dev, size, S):
    """H17 at size 1, at even sizes (fftfreq puts -1/2 at n / 2: the
    ramped spectrum is not Hermitian there) and at one and at 300 stamps
    (the first a star whose corner clamps; past it stars at
    test_psf_stamps_kernel's density, 64 on 256^2, and four padding
    rows): good0 equal, stamps within 1e-7 of the plain version, two
    calls bit-equal. Far denser fields put stamps whose sum cancels (or
    is <= 0, left in counts) past 1e-7 for any f32 order of the sum
    against the plain version's."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import zogy
    side = 256 if S < 64 else 560
    img, xs, ys, valid = _psf_field(dev, side, side, max(S - 4, 4), 93)
    xs, ys, valid = xs[:S], ys[:S], valid[:S]
    n0 = launch.psf_stamps.launches
    k, kg = zogy.psf_stamps(img, xs, ys, valid, size)
    assert launch.psf_stamps.launches == n0 + 1
    p, pg = zogy.psf_stamps_plain(img, xs, ys, valid, size)
    assert k.shape == p.shape == (S, size, size)
    assert torch.equal(kg, pg) and bool(pg.any()) == (size > 1)
    _allclose(k, p, 0.0, 1e-7)
    r, rg = launch.psf_stamps(img, xs, ys, valid, size)
    assert torch.equal(r, k) and torch.equal(rg, kg)


@pytest.mark.parametrize('iters', [0, 2, 3])
def test_psf_clip_kernel(dev, iters):
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import zogy
    base = _gauss(dev, 1.8)
    stamps = base + _rand((64, 25, 25), dev, 92, 2e-4)
    stamps[5, 14, 15] += 0.05                 # an outlier the clip drops
    good0 = torch.ones(64, dtype=torch.bool, device=dev)
    good0[60:] = False
    stamps[61] = float('nan')                 # a padding row: NaN spreads
    n0 = launch.psf_clip.launches
    clean = stamps.clone()
    clean[61] = 0.0
    k = zogy.psf_clip(clean, good0, iters)
    assert launch.psf_clip.launches == n0 + 1
    p = zogy.psf_clip_plain(clean, good0, iters)
    assert torch.equal(k[1], p[1]) and k[1].dtype == torch.bool
    assert bool(p[1][5]) == (iters == 0) and not p[1][60:].any()
    _allclose(k[0], p[0], 0.0, 1e-7)
    assert abs(float(k[0].sum()) - 1.0) < 1e-5
    k = zogy.psf_clip(stamps, good0, iters)
    assert bool(k[0].isnan().all())
    assert bool(zogy.psf_clip_plain(stamps, good0, iters)[0].isnan().all())


def _psf_stack(dev, S, seed):
    """S stamps of a Gaussian PSF with noise, an outlier in stamp 0,
    good0 False on the last fifth."""
    st = _gauss(dev, 1.8) + _rand((S, 25, 25), dev, seed, 2e-4)
    st[0, 14, 15] += 0.05
    good0 = torch.arange(S, device=dev) < S - S // 5
    return st, good0


@pytest.mark.parametrize('S', [1, 64, 65, 300, 600])
@pytest.mark.parametrize('iters', [0, 1, 2, 3])
@pytest.mark.parametrize('case', ['clean', 'nan_stamp', 'inf_pixel'])
def test_psf_clip_kernel_stamps(dev, S, iters, case):
    """H18 at 1, 64, 65, 300 and 600 stamps (300 past the shared memory of
    a one-block layout; 600 past the cluster's too, read from global
    memory each pass), 0-3 passes, with a NaN stamp (dropped or good) and
    an inf pixel: ``good`` bit-equal to the plain version's, the PSF
    within 1e-7 and NaN where it is; 20 launches into poisoned outputs
    each bit-equal to the wrapper's."""
    from zuds_tpu_torch.kernels import build, launch
    from zuds_tpu_torch.ops import zogy
    st, good0 = _psf_stack(dev, S, 95 + S)
    if case == 'nan_stamp':
        st[S - 1] = float('nan')
    elif case == 'inf_pixel':
        st[S // 2, 3, 4] = float('inf')
    k, kg = launch.psf_clip(st, good0, iters)
    p, pg = zogy.psf_clip_plain(st, good0, iters)
    assert kg.dtype == torch.bool and torch.equal(kg, pg)
    assert torch.equal(k.isnan(), p.isnan())
    fin = ~p.isnan()
    _allclose(k[fin], p[fin], 0.0, 1e-7)
    if case == 'clean' and S > 1:
        assert bool(kg[0]) == (iters == 0) and int(kg.sum()) > S // 2
    for _ in range(20):
        psf = torch.full((25, 25), float('nan'), device=dev)
        good = torch.full((S,), 0x5a, dtype=torch.uint8, device=dev)
        err = build.library().zuds_psf_clip(
            launch._ptr(st), launch._ptr(good0), S, 625, iters,
            launch._ptr(psf), launch._ptr(good), launch._stream())
        build.check(err, 'zuds_psf_clip')
        assert torch.equal(good.view(torch.bool), kg)
        assert torch.equal(psf.isnan(), k.isnan())
        assert torch.equal(psf[~k.isnan()], k[~k.isnan()])


def _zogy_star_scene():
    """tests/test_zogy.py's stars-cancel scene at 256^2."""
    rng = np.random.default_rng(8675309)
    H = W = 256
    xs = rng.uniform(20, W - 20, 30)
    ys = rng.uniform(20, H - 20, 30)
    fl = rng.uniform(5000, 30000, 30)
    yy, xx = np.mgrid[0:H, 0:W]

    def render(sig):
        img = np.zeros((H, W))
        for x, y, f in zip(xs, ys, fl):
            img += f * np.exp(-((xx - x) ** 2 + (yy - y) ** 2)
                              / (2 * sig ** 2)) / (2 * np.pi * sig ** 2)
        return img + rng.normal(0, 1.0, (H, W))
    ref = render(1.5)
    new = render(2.2) + 15000 * np.exp(
        -((xx - 130) ** 2 + (yy - 140) ** 2) / (2 * 2.2 ** 2)) / (
        2 * np.pi * 2.2 ** 2)
    return new.astype('f4'), ref.astype('f4'), xs, ys


def test_zogy_card_equals_cpu(dev):
    """zogy_subtract and estimate_psf_from_stars on the card (cuFFT, H15-
    H18) and on the CPU (plain versions, pocketfft): the PSFs and psf_d
    within 1e-7, s_corr within 1e-3, d held against float64."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import zogy
    new, ref, xs, ys = _zogy_star_scene()
    pos = [torch.as_tensor(xs.astype('f4')), torch.as_tensor(ys.astype('f4')),
           torch.ones(30, dtype=torch.bool)]
    counts = [w.launches for w in (launch.psf_stamps, launch.psf_clip,
                                   launch.zogy_spectral,
                                   launch.zogy_normalize)]
    psf = {}
    for where in ('cuda', 'cpu'):
        psf[where] = [zogy.estimate_psf_from_stars(
            torch.as_tensor(a, device=where), *(t.to(where) for t in pos))
            for a in (new, ref)]
    for a, b in zip(psf['cuda'], psf['cpu']):
        _allclose(a.cpu(), b, 0.0, 1e-7)
    out = {where: zogy.zogy_subtract(
        torch.as_tensor(new, device=where), torch.as_tensor(ref, device=where),
        *(p.to(where) for p in psf['cpu']), 1.0, 1.0)
        for where in ('cuda', 'cpu')}
    assert [w.launches for w in (launch.psf_stamps, launch.psf_clip,
                                 launch.zogy_spectral,
                                 launch.zogy_normalize)] == [
        counts[0] + 2, counts[1] + 2, counts[2] + 1, counts[3] + 1]
    k, c = ({key: v.cpu() for key, v in out[w].items()}
            for w in ('cuda', 'cpu'))
    _allclose(k['psf_d'], c['psf_d'], 0.0, 1e-7)
    _allclose(k['s_corr'], c['s_corr'], 0.0, 1e-3)
    assert float(k['f_d']) == float(c['f_d'])
    f64 = zogy.zogy_subtract_plain(
        *(torch.as_tensor(a).double() for a in (new, ref)),
        *(p.double() for p in psf['cpu']), 1.0, 1.0)['d']
    card_err = float((k['d'] - f64).abs().max())
    cpu_err = float((c['d'] - f64).abs().max())
    assert card_err <= 2 * cpu_err + 1e-3, (card_err, cpu_err)
    assert float(k['s_corr'][140, 130]) > 20.0


def test_zogy_pair_card_equals_cpu(dev, tmp_path):
    """from_images(method='zogy') on a 256^2 pair rotated by 0.5 degrees,
    on the card and on the CPU: masks and header cards equal, diff and
    scorr_image as close as the aligned references let them (99% of the
    pixels within 5e-3, all within 0.1)."""
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.coadd import ReferenceImage
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.subtraction import SingleEpochSubtraction
    subs = {}
    for where in ('cuda', 'cpu'):
        d = tmp_path / where
        d.mkdir()
        work, _ = inputs.write_night_pairs(
            str(d), 1, 256, 256, ref_rot_deg=(0.5,), nstars=30,
            header_json=Path(__file__).resolve().parent / 'data'
            / 'ztf_real_header.json')
        sci_path, ref_path = work[0].split()
        sci = ScienceImage.from_file(sci_path)
        ref = ReferenceImage.from_file(ref_path)
        subs[where] = SingleEpochSubtraction.from_images(
            sci, ref, method='zogy', device=where)
    a, b = subs['cuda'], subs['cpu']
    assert np.array_equal(a.mask_image.data, b.mask_image.data)
    for key in ('SUBKO', 'SUBNRX', 'SUBMETH', 'SEEING'):
        assert a.header[key] == b.header[key]
    assert a.header['SUBMETH'] == 'zogy'
    ok = a.mask_image.data == 0
    for x, y in ((a.data, b.data), (a.scorr_image.data, b.scorr_image.data)):
        err = np.abs(x - y)[ok]
        assert np.percentile(err, 99) < 5e-3 and err.max() < 0.1


def test_h15_h18_refuse_wrong_inputs(dev):
    from zuds_tpu_torch.kernels import launch
    c = torch.zeros((8, 5), dtype=torch.complex64, device=dev)
    with pytest.raises(TypeError):
        launch.zogy_spectral(c.to(torch.complex128), c, c, c, 1.0, 1.0, 1.0,
                             1.0, 1.0, 1.0)
    with pytest.raises(ValueError):
        launch.zogy_spectral(c, c[:4], c, c, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    # dense layouts that differ, and a view that is not dense
    with pytest.raises(ValueError, match='dense layout'):
        launch.zogy_spectral(c, c, c, c.t().contiguous().t(), 1.0, 1.0, 1.0,
                             1.0, 1.0, 1.0)
    wide = torch.zeros((8, 10), dtype=torch.complex64, device=dev)[:, ::2]
    with pytest.raises(ValueError, match='dense layout'):
        launch.zogy_spectral(wide, wide, wide, wide, 1.0, 1.0, 1.0, 1.0, 1.0,
                             1.0)
    f = torch.zeros((8, 8), device=dev)
    with pytest.raises(ValueError):
        launch.zogy_normalize(f, f[:4], 1.0)
    xs = torch.zeros(2, device=dev)
    ok = torch.ones(2, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match='unsupported'):
        launch.psf_stamps(torch.zeros((40, 40), device=dev), xs, xs, ok, 33)
    with pytest.raises(ValueError, match='unsupported'):
        launch.psf_stamps(f, xs, xs, ok, 9)
    with pytest.raises(ValueError, match='unsupported'):
        launch.psf_clip(torch.zeros((2, 33, 33), device=dev), ok, 2)


def launch_counts():
    from zuds_tpu_torch.kernels import launch
    return launch.triplet_cut.launches, launch.braai_conv3x3.launches


def _near_ties(r, pool_out, tol):
    """Windows of the 2x2 pool over the pre-activations ``r`` (N, C, Hc,
    Wc; before ReLU) whose largest value lies within ``tol`` of 0 or,
    positive, within ``tol`` of the second: their first maximum may move
    with the summation order. NHWC bool."""
    n, c, ho, wo = pool_out.shape
    win = r[:, :, :2 * ho, :2 * wo].reshape(n, c, ho, 2, wo, 2)
    win = win.permute(0, 1, 2, 4, 3, 5).reshape(n, c, ho, wo, 4)
    top = win.topk(2, dim=-1).values
    tie = (top[..., 0].abs() <= tol) | (
        (top[..., 0] > 0) & (top[..., 0] - top[..., 1] <= tol))
    return tie.permute(0, 2, 3, 1)


def _close_to_max(a, b, rel):
    err = float((a - b).abs().max())
    assert err <= rel * float(b.abs().max()), (err, float(b.abs().max()))


@pytest.mark.parametrize('i', range(4))
def test_braai_training_kernels(dev, i):
    """H13t, H19 (layers 2-4) and H20 on one layer at a batch of 7."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import braai
    cin, cout, pool = launch.BRAAI_LAYERS[i]
    side = (63, 61, 29, 27)[i]
    x = _rand((7, side, side, cin), dev, 80 + i, 0.05).abs()
    w = _rand((3, 3, cin, cout), dev, 90 + i, (1.0 / (9 * cin)) ** 0.5)
    b = _rand((cout,), dev, 100 + i, 0.01)
    hc = side - 2
    shape = (7, hc // 2, hc // 2, cout) if pool else (7, hc, hc, cout)
    g = torch.Generator(device=dev).manual_seed(110 + i)
    mask = torch.rand(shape, generator=g, device=dev) < 0.75 if pool else None
    keep = 0.75 if pool else 1.0
    n0 = {k: launch.WRAPPERS[k].launches for k in (
        'braai_conv3x3_train', 'braai_conv3x3_dgrad', 'braai_conv3x3_wgrad')}
    k, kr = braai.conv3x3_train(x, w, b, pool, mask, keep)
    p, pr = braai.conv3x3_train_plain(x, w, b, pool, mask, keep)
    assert k.shape == p.shape == shape
    _allclose(k, p, 1e-5, 1e-6)
    bare, _ = launch.braai_conv3x3_train(x, w, b, pool)
    assert torch.equal(bare, launch.braai_conv3x3(x, w, b, pool))
    if pool:
        r = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b)
        tie = _near_ties(r, F.max_pool2d(r, 2, 2),
                         1e-5 * float(r.abs().max()))
        assert kr.dtype == torch.uint8 and kr.shape == shape
        assert torch.equal(kr[~tie], pr[~tie])
        assert float(tie.float().mean()) < 0.01
        assert bool((pr == 255).any()) and bool((pr < 4).any())
        # the dropout: zero where the mask drops, the bare value / keep
        assert not bool(k[~mask].any())
        assert torch.equal(k[mask], bare[mask] / torch.full(
            (), keep, device=dev))
    else:
        assert kr is None and pr is None
    gy = _rand(shape, dev, 120 + i)
    saved = pr if pool else p
    if i > 0:
        gk = braai.conv3x3_dgrad(gy, w, saved, mask, keep, pool, x.shape)
        gp = braai.conv3x3_dgrad_plain(gy, w, saved, mask, keep, pool,
                                       x.shape)
        assert gk.shape == x.shape
        _close_to_max(gk, gp, 1e-5)
    else:
        with pytest.raises(ValueError, match='triplets'):
            launch.braai_conv3x3_dgrad(gy, w, saved, mask, keep, pool,
                                       tuple(x.shape))
    wk, bk = braai.conv3x3_wgrad(x, gy, saved, mask, keep, pool)
    wk2, bk2 = braai.conv3x3_wgrad(x, gy, saved, mask, keep, pool)
    assert torch.equal(wk, wk2) and torch.equal(bk, bk2)
    wp, bp = braai.conv3x3_wgrad_plain(x, gy, saved, mask, keep, pool)
    assert wk.shape == w.shape and bk.shape == b.shape
    _close_to_max(wk, wp, 1e-5)
    _close_to_max(bk, bp, 1e-5)
    assert launch.braai_conv3x3_train.launches == \
        n0['braai_conv3x3_train'] + 2
    assert launch.braai_conv3x3_dgrad.launches == \
        n0['braai_conv3x3_dgrad'] + (1 if i > 0 else 0)
    assert launch.braai_conv3x3_wgrad.launches == \
        n0['braai_conv3x3_wgrad'] + 2


@pytest.mark.parametrize('n', (1, 3, 5))
@pytest.mark.parametrize('i', range(4))
def test_braai_backward_kernels_at_small_batches(dev, i, n):
    """H19 (layers 2-4) and H20 at batches of 1, 3 and 5: one image, and
    batches that leave H20's last chunk of images (2 at layer 3, 4 at
    layer 4) part-filled; with and without the dropout mask on a pooled
    layer. Within 1e-5 of the plain gradient's largest magnitude, two
    calls bit-equal, one launch each."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import braai
    cin, cout, pool = launch.BRAAI_LAYERS[i]
    side = (63, 61, 29, 27)[i]
    x = _rand((n, side, side, cin), dev, 140 + i, 0.05).abs()
    w = _rand((3, 3, cin, cout), dev, 150 + i, (1.0 / (9 * cin)) ** 0.5)
    b = _rand((cout,), dev, 160 + i, 0.01)
    hc = side - 2
    shape = (n, hc // 2, hc // 2, cout) if pool else (n, hc, hc, cout)
    gy = _rand(shape, dev, 170 + i)
    g = torch.Generator(device=dev).manual_seed(180 + i)
    masks = ((None, torch.rand(shape, generator=g, device=dev) < 0.75)
             if pool else (None,))
    for mask in masks:
        keep = 0.75 if mask is not None else 1.0
        p, pr = braai.conv3x3_train_plain(x, w, b, pool, mask, keep)
        saved = pr if pool else p
        if i > 0:
            n0 = launch.braai_conv3x3_dgrad.launches
            gk = launch.braai_conv3x3_dgrad(gy, w, saved, mask, keep, pool,
                                            tuple(x.shape))
            gk2 = launch.braai_conv3x3_dgrad(gy, w, saved, mask, keep, pool,
                                             tuple(x.shape))
            assert launch.braai_conv3x3_dgrad.launches == n0 + 2
            assert torch.equal(gk, gk2)
            gp = braai.conv3x3_dgrad_plain(gy, w, saved, mask, keep, pool,
                                           x.shape)
            _close_to_max(gk, gp, 1e-5)
        n0 = launch.braai_conv3x3_wgrad.launches
        wk, bk = launch.braai_conv3x3_wgrad(x, gy, saved, mask, keep, pool)
        wk2, bk2 = launch.braai_conv3x3_wgrad(x, gy, saved, mask, keep, pool)
        assert launch.braai_conv3x3_wgrad.launches == n0 + 2
        assert torch.equal(wk, wk2) and torch.equal(bk, bk2)
        wp, bp = braai.conv3x3_wgrad_plain(x, gy, saved, mask, keep, pool)
        _close_to_max(wk, wp, 1e-5)
        _close_to_max(bk, bp, 1e-5)


def test_braai_backward_resources(dev):
    """H19 and H20 at the four layers' widths: two blocks resident per SM,
    as their tiles are sized for (registers, shared memory), under the
    card's 227 KB a block; H19 has no kernel for the triplets."""
    from zuds_tpu_torch.kernels import launch
    for (cin, cout, pool), side in zip(launch.BRAAI_LAYERS,
                                       (63, 61, 29, 27)):
        for kind in ('dgrad', 'wgrad'):
            if kind == 'dgrad' and cin == 3:
                with pytest.raises(RuntimeError, match='CUDA error'):
                    launch.braai_backward_resources(kind, cin, cout, pool,
                                                    side)
                continue
            r = launch.braai_backward_resources(kind, cin, cout, pool, side)
            assert r['blocks_per_sm'] >= 2, r
            assert 0 < r['smem_bytes'] <= 227 * 1024, r


def test_braai_backward_refuses_inputs_too_wide(dev):
    """Layer 2 a thousand columns wide: H19's span and H20's bands do not
    fit in shared memory, and both wrappers raise at launch, counting
    nothing; the next call at the layer's width runs."""
    from zuds_tpu_torch.kernels import launch
    x = torch.zeros((1, 61, 1000, 32), device=dev)
    w = torch.zeros((3, 3, 32, 32), device=dev)
    gy = torch.zeros((1, 29, 499, 32), device=dev)
    route = torch.zeros((1, 29, 499, 32), dtype=torch.uint8, device=dev)
    n0 = (launch.braai_conv3x3_dgrad.launches,
          launch.braai_conv3x3_wgrad.launches)
    with pytest.raises(RuntimeError, match='CUDA error'):
        launch.braai_conv3x3_dgrad(gy, w, route, None, 0.75, True,
                                   tuple(x.shape))
    with pytest.raises(RuntimeError, match='CUDA error'):
        launch.braai_conv3x3_wgrad(x, gy, route, None, 0.75, True)
    assert (launch.braai_conv3x3_dgrad.launches,
            launch.braai_conv3x3_wgrad.launches) == n0
    # the refusal is not left pending for the next launcher
    gx = launch.braai_conv3x3_dgrad(gy[:, :, :29].contiguous(), w,
                                    route[:, :, :29].contiguous(), None,
                                    0.75, True, (1, 61, 61, 32))
    assert gx.shape == (1, 61, 61, 32) and bool(torch.isfinite(gx).all())


def test_adam_kernel_bit_equal(dev):
    """H21 on braai's 2,425,377 parameters at step 3, with exact zeros and
    tiny gradients among them, against adam_update_plain."""
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import adam
    n = 2425377
    p = _rand((n,), dev, 130, 0.05)
    g = _rand((n,), dev, 131, 1e-3)
    g[:1000] = 0.0
    g[1000:2000] *= 1e-7
    mu = _rand((n,), dev, 132, 1e-4)
    nu = _rand((n,), dev, 133, 1e-7).abs()
    bc1, bc2 = adam.bias_corrections(torch.tensor(3, dtype=torch.int32,
                                                  device=dev))
    want = adam.adam_update_plain(p, g, mu, nu, bc1, bc2, 3e-4)
    got = [t.clone() for t in (p, mu, nu)]
    n0 = launch.adam_step.launches
    launch.adam_step(got[0], g, got[1], got[2], bc1, bc2, 3e-4, 0.9, 0.999,
                     1e-8)
    assert launch.adam_step.launches == n0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a - b).abs().max())


def test_train_step_card_equals_plain(dev):
    """One train_step on the card (H13t x4, H19 x3, H20 x4, H21 x1) against
    train_step_plain from the same state with the same masks."""
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import braai
    t, y = inputs.labelled_triplets(32, seed=1)
    masks = braai.draw_masks(32, 5, dev)
    runs = {}
    for plain in (False, True):
        _, params, _, state = braai.make_train_state(0, device=dev)
        step = braai.train_step_plain if plain else braai.train_step
        # the gradient the first step sees, for the Adam-aware rule
        n0 = {k: launch.WRAPPERS[k].launches for k in (
            'braai_conv3x3_train', 'braai_conv3x3_dgrad',
            'braai_conv3x3_wgrad', 'adam_step')}
        params, state, loss = step(params, state, t, y, 0, masks=masks)
        counts = {k: launch.WRAPPERS[k].launches - v for k, v in n0.items()}
        runs[plain] = (params.flat, state['mu'].flat, float(loss), counts)
    (pk, mk, lk, ck), (pp, mp, lp, cp) = runs[False], runs[True]
    assert ck == {'braai_conv3x3_train': 4, 'braai_conv3x3_dgrad': 3,
                  'braai_conv3x3_wgrad': 4, 'adam_step': 1}
    assert set(cp.values()) == {0}
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    # step 1: mu = 0.1 g, the update about lr sign(g)
    _close_to_max(mk, mp, 1e-4)
    d = (pk - pp).abs()
    near0 = mp.abs() <= 1e-3 * float(mp.abs().max())
    assert float(d[~near0].max()) <= 1e-5
    assert float(d[near0].max()) <= 2 * 3e-4
    assert int((d > 1e-5).sum()) <= 1e-3 * d.numel()


def test_training_wrappers_refuse_wrong_inputs(dev):
    from zuds_tpu_torch.kernels import launch
    x = torch.zeros((2, 61, 61, 32), device=dev)
    w, b = torch.zeros((3, 3, 32, 32), device=dev), torch.zeros(32,
                                                                device=dev)
    gy = torch.zeros((2, 29, 29, 32), device=dev)
    route = torch.zeros((2, 29, 29, 32), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match='not a layer'):
        launch.braai_conv3x3_train(x, w, b, False)
    with pytest.raises(ValueError, match='no dropout mask'):
        launch.braai_conv3x3_train(
            torch.zeros((2, 63, 63, 3), device=dev),
            torch.zeros((3, 3, 3, 32), device=dev), b,
            False, torch.ones((2, 61, 61, 32), dtype=torch.bool, device=dev))
    with pytest.raises(TypeError):
        launch.braai_conv3x3_wgrad(x, gy, route.float(), None, 0.75, True)
    with pytest.raises(ValueError, match='shape'):
        launch.braai_conv3x3_dgrad(gy[:, :28].contiguous(), w, route, None,
                                   0.75, True, tuple(x.shape))
    p = torch.zeros(16, device=dev)
    with pytest.raises(ValueError, match='shape'):
        launch.adam_step(p, p[:8], p, p, p[0], p[0], 3e-4, 0.9, 0.999, 1e-8)


def _phot_frame(H, W, dev, seed):
    """A frame of Gaussian sources over sky, its rms and a sparse 20-bit
    mask (bits past the 18 the flags keep included)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    img = _rand((H, W), dev, seed, 5.0, 100.0)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    rng = np.random.default_rng(seed)
    for x, y, f in zip(rng.uniform(0, W, 12), rng.uniform(0, H, 12),
                       rng.uniform(1e3, 3e4, 12)):
        img += f / 28.3 * torch.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 9.0)
    rms = (5.0 + 0.01 * img.abs()).contiguous()
    mask = torch.where(
        torch.rand((H, W), generator=g, device=dev) < 0.05,
        torch.randint(0, 1 << 20, (H, W), generator=g, device=dev,
                      dtype=torch.int32), 0).to(torch.int32)
    return img.contiguous(), rms, mask


def _f32(v, dev):
    return torch.as_tensor(np.asarray(v, 'f4'), device=dev)


@pytest.mark.parametrize('H,W,n,r', [(200, 180, 48, 3.0), (40, 37, 9, 6.0),
                                     (3080, 3072, 4096, 3.0)])
def test_aperture_photometry_kernel(dev, H, W, n, r):
    """H22 against its plain version (checks.aperture_check: overlaps,
    flags and oob bit-equal, the sums within the order bound), with a sixth
    of the positions past an edge; rms and mask None as zeros."""
    from zuds_tpu_torch.kernels import checks
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import photometry as ph
    img, rms, mask = _phot_frame(H, W, dev, 70)
    xs, ys = (_f32(v, dev) for v in _positions(H, W, n, 71))
    n0 = launch.aperture_photometry.launches
    k = ph.aperture_photometry_batched(img, rms, mask, xs, ys, r)
    assert launch.aperture_photometry.launches == n0 + 1
    assert k['oob'].dtype == torch.bool and k['flags'].dtype == torch.int32
    checks.aperture_check(img, rms, mask, xs, ys, r, 'test')
    k0 = ph.aperture_photometry_batched(img, None, None, xs, ys, r)
    p0 = ph.aperture_photometry_batched_plain(img, None, None, xs, ys, r)
    assert torch.equal(k0['flags'], p0['flags']) and not k0['flags'].any()
    assert torch.equal(k0['fluxerr'], torch.zeros_like(k0['fluxerr']))
    assert torch.equal(k0['flux'], k['flux'])


def test_aperture_photometry_kernel_odd_positions(dev):
    """Positions at half-pixel corners (rounded half to even), on and past
    the edges, far off the frame and NaN: oob, flags and overlaps as the
    plain version's."""
    from zuds_tpu_torch.kernels import checks
    H, W = 64, 70
    img, rms, mask = _phot_frame(H, W, dev, 73)
    xs = [2.5, 3.5, 4.5, -0.5, 0.5, W - 0.5, W - 4.5, 1e10, -1e10,
          float('nan'), float('inf'), 30.0, 31.49999, 12.0]
    ys = [10.5, 11.5, 3.5, 20.0, -0.5, 30.0, H - 3.5, 5.0, 5.0, 9.0, 9.0,
          float('nan'), 40.5, -1e10]
    for r in (3.0, 6.0):
        checks.aperture_check(img, rms, mask, _f32(xs, dev),
                              _f32(ys, dev), r, f'odd positions r={r}')


@pytest.mark.parametrize('H,W,n', [(200, 180, 48), (3080, 3072, 4096)])
def test_aperture_sums_kernel(dev, H, W, n):
    """H22's two-plane mode against its plain version, within the order
    bound of the sums."""
    from zuds_tpu_torch.kernels import checks
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import photometry as ph
    img, rms, mask = _phot_frame(H, W, dev, 74)
    badf = ((mask & 0x3) > 0).to(torch.float32)
    xs, ys = (_f32(v, dev) for v in _positions(H, W, n, 75))
    n0 = launch.aperture_sums.launches
    ka = ph.aperture_sums((rms, badf), xs, ys, 6.0)
    assert launch.aperture_sums.launches == n0 + 1
    pa = ph.aperture_sums_plain((rms, badf), xs, ys, 6.0)
    rel = checks.sum_gap_bound(225)
    for kv, pv in zip(ka, pa):
        _allclose(kv, pv, rel, 0.0)
    assert float(ka[1].max()) > 0


def _dup_rows(H, W, n, seed, fill):
    """n positions whose rows past n // 3 repeat the last row's position
    ``fill`` (the slice's empty rows), with duplicates among the first
    rows that are not the last row's and one of the fill among them."""
    xs, ys = _positions(H, W, n, seed)
    xs[n // 3:], ys[n // 3:] = fill
    xs[5:9], ys[5:9] = xs[4], ys[4]            # repeated, not the last's
    xs[10], ys[10] = fill
    return xs, ys


@pytest.mark.parametrize('fill', [(12.25, 7.5), (float('nan'), 3.0),
                                  (0.0, 0.0)])
@pytest.mark.parametrize('H,W,n', [(200, 180, 100), (3080, 3072, 9000)])
def test_aperture_kernel_duplicate_rows(dev, H, W, n, fill):
    """H22's row dedupe: rows at the last row's position take its outputs
    (and overlaps), repeated rows elsewhere are measured; both modes
    against the plain version (overlaps, flags, oob bit-equal), each row
    as the same call on that row alone, two calls bit-identical; past the
    rows block 0 compares ahead (9000)."""
    from zuds_tpu_torch.kernels import checks, launch
    from zuds_tpu_torch.ops import photometry as ph
    img, rms, mask = _phot_frame(H, W, dev, 79)
    xs, ys = (_f32(v, dev) for v in _dup_rows(H, W, n, 80, fill))
    if fill[0] == 0.0:
        xs[11], ys[11] = -0.0, 0.0             # the fill but for the bits
    checks.aperture_check(img, rms, mask, xs, ys, 3.0, 'duplicate rows')
    for r, cut in ((3.0, 9), (6.0, 15)):
        k1 = launch.aperture_photometry(img, rms, mask, xs, ys, r, cut,
                                        weights=True)
        k2 = launch.aperture_photometry(img, rms, mask, xs, ys, r, cut,
                                        weights=True)
        for key in k1:
            assert checks._same(k1[key], k2[key]), key
        one = [launch.aperture_photometry(img, rms, mask, xs[i:i + 1],
                                          ys[i:i + 1], r, cut, weights=True)
               for i in (0, 4, 7, 10, 11, n // 2, n - 1)]
        for i, o in zip((0, 4, 7, 10, 11, n // 2, n - 1), one):
            for key in o:
                assert checks._same(k1[key][i:i + 1], o[key]), (i, key)
        s1 = launch.aperture_sums(rms, img, xs, ys, r, cut)
        s2 = launch.aperture_sums(rms, img, xs, ys, r, cut)
        assert all(checks._same(a, b) for a, b in zip(s1, s2))
        sa, sb = ph.aperture_sums_plain((rms, img), xs, ys, r)
        rel = checks.sum_gap_bound(cut * cut)
        scale = ph.aperture_sums_plain((rms.abs(), img.abs()), xs, ys, r)
        for kv, pv, sc in zip(s1, (sa, sb), scale):
            fin = pv.isfinite()
            assert torch.equal(fin, kv.isfinite())
            assert bool(((kv - pv).abs()[fin] <= rel * sc[fin]).all())


@pytest.mark.parametrize('H,W,n', [(150, 170, 40), (3080, 3072, 4096)])
def test_refine_detections_kernel(dev, H, W, n):
    """H23 against its plain version within checks.refine_check's
    tolerances, on sources and sky, a sixth of the positions past an edge;
    two calls bit-identical."""
    from zuds_tpu_torch.kernels import checks
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import measure as ms
    img, rms, _ = _phot_frame(H, W, dev, 76)
    rng = np.random.default_rng(77)
    xs, ys = _positions(H, W, n, 78)
    args = tuple(_f32(v, dev) for v in (
        xs, ys, rng.uniform(0.3, 4.0, n), rng.uniform(0.3, 2.0, n),
        rng.uniform(-1.6, 1.6, n), rng.uniform(1.0, 6.0, n)))
    n0 = launch.refine_detections.launches
    k = ms.refine_detections(img, rms, *args)
    assert launch.refine_detections.launches == n0 + 1
    k2 = ms.refine_detections(img, rms, *args)
    for key in k:
        assert torch.equal(k[key].nan_to_num(7.0), k2[key].nan_to_num(7.0))
    p = ms.refine_detections_plain(img, rms, *args)
    checks.refine_check(img, rms, args, k, p)


def test_h22_h23_take_no_rows(dev):
    """N = 0: empty outputs, no launch counted, no launch error."""
    from zuds_tpu_torch.kernels import launch
    img = torch.zeros((64, 64), device=dev)
    e = torch.zeros(0, device=dev)
    counts = [w.launches for w in (launch.aperture_photometry,
                                   launch.aperture_sums,
                                   launch.refine_detections)]
    ph = launch.aperture_photometry(img, img, None, e, e, 3.0, 9)
    sa, sb = launch.aperture_sums(img, img, e, e, 6.0, 15)
    ref = launch.refine_detections(img, img, e, e, e, e, e, e, 33)
    torch.cuda.synchronize()
    assert all(v.shape == (0,) for v in (*ph.values(), sa, sb,
                                         *ref.values()))
    assert counts == [w.launches for w in (launch.aperture_photometry,
                                           launch.aperture_sums,
                                           launch.refine_detections)]


def test_h22_h23_refuse_wrong_inputs(dev):
    from zuds_tpu_torch.kernels import launch
    img = torch.zeros((64, 64), device=dev)
    xs = torch.zeros(4, device=dev)
    mask = torch.zeros((64, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match='CUDA'):
        launch.aperture_photometry(img.cpu(), None, None, xs, xs, 3.0, 9)
    with pytest.raises(ValueError, match='CUDA'):
        launch.aperture_sums(img, img, xs.cpu(), xs, 6.0, 15)
    with pytest.raises(TypeError):
        launch.aperture_photometry(img.double(), None, None, xs, xs, 3.0, 9)
    with pytest.raises(TypeError):
        launch.aperture_photometry(img, None, mask.long(), xs, xs, 3.0, 9)
    with pytest.raises(ValueError, match='shape'):
        launch.aperture_photometry(img, img[:10], None, xs, xs, 3.0, 9)
    with pytest.raises(ValueError, match='at least'):
        launch.aperture_sums(img[:8], img[:8], xs, xs, 6.0, 15)
    with pytest.raises(ValueError, match='shape'):
        launch.refine_detections(img, img, xs, xs, xs[:3], xs, xs, xs, 33)
    with pytest.raises(TypeError):
        launch.refine_detections(img, img, xs, xs.double(), xs, xs, xs, xs,
                                 33)
    with pytest.raises(ValueError, match='CUDA'):
        launch.refine_detections(img, img.cpu(), xs, xs, xs, xs, xs, xs, 33)


@pytest.mark.parametrize('cut', [25, 41])
def test_refine_detections_kernel_other_cut(dev, cut):
    """H23 at window sizes other than the catalogs' 33 (the kernel's
    loop over a window of any size) against the plain version at the same
    size."""
    from zuds_tpu_torch.kernels import checks, launch
    from zuds_tpu_torch.ops import measure as ms
    H, W, n = 300, 290, 200
    img, rms, _ = _phot_frame(H, W, dev, 82)
    rng = np.random.default_rng(83)
    xs, ys = _positions(H, W, n, 84)
    args = tuple(_f32(v, dev) for v in (
        xs, ys, rng.uniform(0.3, 4.0, n), rng.uniform(0.3, 2.0, n),
        rng.uniform(-1.6, 1.6, n), rng.uniform(1.0, 6.0, n)))
    k = launch.refine_detections(img, rms, *args, cut)
    k2 = launch.refine_detections(img, rms, *args, cut)
    for key in k:
        assert torch.equal(k[key].nan_to_num(7.0), k2[key].nan_to_num(7.0))
    p = ms.refine_detections_plain(img, rms, *args, cut)
    checks.refine_check(img, rms, args, k, p, cut)

@pytest.mark.parametrize('nlive', [0, 3, 57, 4095])
def test_refine_detections_kernel_repeated_rows(dev, nlive):
    """H23 on 4096 rows of which all but ``nlive`` (interleaved) carry the
    last row's six inputs bitwise, as detect_sources' empty rows do; one
    row differs from the last in theta by one ulp and one in x by half a
    pixel: those are measured on their own. Within refine_check of the plain version,
    the copies bitwise the last row's outputs, two calls bit-identical."""
    from zuds_tpu_torch.kernels import checks, launch
    from zuds_tpu_torch.ops import measure as ms
    H, W, n = 3080, 3072, 4096
    img, rms, _ = _phot_frame(H, W, dev, 79)
    rng = np.random.default_rng(80 + nlive)
    xs, ys = _positions(H, W, n, 81 + nlive)
    cols = [np.asarray(v, 'f4').copy() for v in (
        xs, ys, rng.uniform(0.3, 4.0, n), rng.uniform(0.3, 2.0, n),
        rng.uniform(-1.6, 1.6, n), rng.uniform(1.0, 6.0, n))]
    copies = np.ones(n, bool)
    copies[rng.choice(n - 1, nlive, replace=False)] = False
    copies[-1] = False
    for c in cols:
        c[copies] = c[-1]
    if nlive >= 3:
        live = np.flatnonzero(~copies[:-1])
        cols[4][live[0]] = np.nextafter(cols[4][-1], np.float32(9))
        for k in (0, 1, 2, 3, 5):
            cols[k][live[0]] = cols[k][-1]
            cols[k][live[1]] = cols[k][-1]
        cols[4][live[1]] = cols[4][-1]
        cols[0][live[1]] += np.float32(0.5)
    args = tuple(_f32(c, dev) for c in cols)
    k = launch.refine_detections(img, rms, *args, 33)
    k2 = launch.refine_detections(img, rms, *args, 33)
    for key in k:
        assert torch.equal(k[key].nan_to_num(7.0), k2[key].nan_to_num(7.0))
        got = k[key][torch.as_tensor(copies, device=dev)]
        assert torch.equal(got.view(torch.int32), k[key][-1].expand(
            got.shape).contiguous().view(torch.int32)), key
    p = ms.refine_detections_plain(img, rms, *args)
    checks.refine_check(img, rms, args, k, p)


def _stats_layout(dev, counts, seed, H=700, W=600):
    """object_stats' arguments for rows of the given entry counts (row j
    holds counts[j] entries, at shuffled positions of the list), over
    seeded pixels of an H x W frame."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts)
    cap, nseg = int(counts.sum()), len(counts)
    cid = np.repeat(np.arange(nseg), counts)
    rng.shuffle(cid)
    pidx = np.sort(rng.choice(H * W, cap, replace=False))
    vals = rng.normal(5, 30, cap).astype('f4')
    mask = np.where(rng.random(cap) < 0.05, rng.integers(0, 1 << 17, cap),
                    0).astype('i4')
    T = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    return (T(cid), T(pidx), T(vals), T(mask), T(rng.random(cap) > 0.02),
            T((15.0 * (1 + 0.1 * rng.random(cap))).astype('f4')),
            T(rng.random(cap) < 0.01), T(np.int64(cap + 3)), (H, W), nseg,
            5.0, nseg - 2)


def _stats_counts(seed, cap):
    """Row lengths of a frame's list: empty rows, rows of 1-400 entries,
    rows past one 1024-entry window, rows starting and ending on a window
    boundary, and a discard row with the rest of ``cap``."""
    rng = np.random.default_rng(seed)
    lens = list(rng.integers(1, 400, 300) * (rng.random(300) > 0.4))
    lens[:4] = [0, 7, 1024 - 7, 2048]      # rows 2, 3 on window bounds
    lens[10:13] = [1025, 3000, 1]
    lens += [0] * 20
    lens.append(max(0, cap - sum(lens)))
    return lens


@pytest.mark.parametrize('seed,cap', [(0, 65536), (1, 40000), (2, 131072),
                                      (3, 9999)])
def test_object_stats_kernel_layouts(dev, seed, cap):
    """H26 on seeded row layouts (rows of every length up to past three
    windows, on and off the windows' bounds, a long discard row, lists of
    odd length): bit-equal to object_stats_plain (checks.stats_check),
    two calls bit-identical."""
    from zuds_tpu_torch.kernels import checks, launch
    args = _stats_layout(dev, _stats_counts(seed, cap), seed)
    checks.stats_check(args)
    a = launch.object_stats(*args)
    b = launch.object_stats(*args)
    assert all(torch.equal(a[k].nan_to_num(7.0), b[k].nan_to_num(7.0))
               for k in a)


def test_object_stats_kernel_single_rows(dev):
    """H26 with one row holding the whole list (one window, several, an
    odd length past a window) and with every entry its own row."""
    from zuds_tpu_torch.kernels import checks
    for counts in ([0, 1024, 0], [0, 5 * 1024, 0], [3, 4097, 0],
                   [1] * 2050, [0, 1]):
        checks.stats_check(_stats_layout(dev, counts, len(counts)))


def _detect_scene(dev, H, W, nsrc, seed, plateau=False):
    """tests/test_torch_detect.py's scene (sources stamped in 25x25
    windows), as (diff, rms, mask, weight_ok) on the card."""
    rng = np.random.default_rng(seed)
    diff = rng.normal(0, 5, (H, W)).astype('f4')
    for _ in range(nsrc):
        x0, y0 = rng.uniform(-2, W + 2), rng.uniform(-2, H + 2)
        s, f = rng.uniform(1.2, 3.0), rng.uniform(200, 2e4)
        xi, yi = int(x0), int(y0)
        ys, xs = np.mgrid[max(0, yi - 12):min(H, yi + 13),
                          max(0, xi - 12):min(W, xi + 13)]
        diff[ys, xs] += (f * np.exp(-((xs - x0) ** 2 + (ys - y0) ** 2)
                                    / (2 * s * s))
                         / (2 * np.pi * s * s)).astype('f4')
    if plateau:
        diff[60:200, 40:220] += 40.0
    diff[rng.random((H, W)) < 2e-4] = np.nan
    rms = (5.0 * (1 + 0.1 * rng.random((H, W)))).astype('f4')
    mask = np.where(rng.random((H, W)) < 0.01,
                    rng.integers(0, 1 << 17, (H, W)), 0).astype('i4')
    wok = rng.random((H, W)) > 0.01
    return tuple(torch.as_tensor(a).to(dev) for a in (diff, rms, mask, wok))


def _wing_scene(dev):
    """A bright star with three marginal bumps in its wing (CLEAN merges
    all three into it) and one on blank sky (tests/test_detect.py's
    recipe)."""
    rng = np.random.default_rng(11)
    H = W = 128
    img = rng.normal(0, 0.3, (H, W)).astype('f4')
    yy, xx = np.mgrid[0:H, 0:W]
    img += (400000.0 / (2 * np.pi * 36) * np.exp(
        -((xx - 64) ** 2 + (yy - 64) ** 2) / (2 * 36.0))).astype('f4')
    for x0, y0 in ((94, 64), (64, 94), (43, 43), (20, 110)):
        img += (3.0 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                             / (2 * 2.25))).astype('f4')
    return (torch.as_tensor(img).to(dev), torch.ones((H, W), device=dev),
            torch.zeros((H, W), dtype=torch.int32, device=dev),
            torch.ones((H, W), dtype=torch.bool, device=dev))


# (scene, detect_sources keywords): small, overflowing (pixels and objects
# past their caps), a CLEAN merge of three rows, a flagship-size frame
DETECT_SCENES = {
    'small': (lambda d: _detect_scene(d, 256, 256, 40, 5), {'max_det': 128}),
    'overflowing': (lambda d: _detect_scene(d, 256, 256, 200, 9, True),
                    {'max_det': 8, 'det_cap': 4096}),
    'wings': (_wing_scene, {'max_det': 64}),
    'flagship': (lambda d: _detect_scene(d, 3080, 3072, 900, 1),
                 {'max_det': 4096, 'det_cap': 1 << 16, 'deb_cap': 1 << 16}),
}


def _seed_lists(det):
    """The bool mask ``det``'s compact lists as the callers make them: at
    capacity H*W (label_components), with padding past its detected pixels
    and overflowing (half of them listed)."""
    from zuds_tpu_torch.ops.compact import compact_indices
    n = det.numel()
    nd = int(det.sum())
    for cap in sorted({n, min(n, nd + 37), max(1, nd // 2)}):
        yield compact_indices(det.reshape(-1), cap, n - 1)


@pytest.mark.parametrize('H,W,p,sweeps', [(200, 136, 0.45, 12),
                                          (97, 131, 0.7, 5), (33, 70, 1.0, 12),
                                          (40, 40, 0.0, 12), (64, 64, 0.3, 0),
                                          (3080, 3072, 0.01, 12)])
def test_seed_sweeps_kernel(dev, H, W, p, sweeps):
    """H24 bit-equal to its plain version at the list's entries, +inf past
    them, at capacity, padded and overflowing; two calls bit-equal."""
    from zuds_tpu_torch.kernels import checks, launch
    g = torch.Generator(device=dev).manual_seed(H)
    det = torch.rand((H, W), generator=g, device=dev) < p
    for pidx, count in _seed_lists(det):
        n0 = launch.seed_sweeps.launches
        checks.seeds_check(det, pidx, count, sweeps)
        assert launch.seed_sweeps.launches == n0 + 2


@pytest.mark.parametrize('joined', [False, True])
@pytest.mark.parametrize('H,W', [(64, 80), (67, 93), (31, 33)])
def test_seed_sweeps_kernel_corners(dev, H, W, joined):
    """H24 where the frame's last pixel is detected (alone or joined; the
    list padded, where _extract's inverse map drops that entry, and
    overflowing), at widths that are no multiple of 16, with whole tiles
    detected and a view at a byte offset."""
    from zuds_tpu_torch.kernels import checks
    rng = np.random.default_rng(H * W)
    det = rng.random((H, W)) < 0.35
    det[-3:, -3:] = joined
    det[-1, -1] = True
    det[:min(H, 32), :min(W, 32)] = True     # an all-detected tile
    t = torch.as_tensor(det, device=dev)
    for pidx, count in _seed_lists(t):
        checks.seeds_check(t, pidx, count)
    # a mask at an odd byte offset of its storage (no 16-byte loads)
    base = torch.zeros(H * W + 1, dtype=torch.bool, device=dev)
    view = base[1:].view(H, W)
    view.copy_(t)
    for pidx, count in _seed_lists(view):
        checks.seeds_check(view, pidx, count)


@pytest.mark.parametrize('which', list(DETECT_SCENES))
def test_ccl_stats_clean_kernels(dev, which):
    """H25, H26 and H27 on the inputs detect_sources gives them."""
    from zuds_tpu_torch.kernels import checks
    from zuds_tpu_torch.ops import detect
    make, kw = DETECT_SCENES[which]
    taps = detect.detect_taps(*make(dev), **kw)
    checks.seeds_check(*taps['seeds'])
    checks.ccl_check(*taps['ccl'])
    checks.stats_check(taps['stats'])
    _, _, ncleaned, _ = checks.clean_check(taps['clean'])
    if which == 'wings':
        assert ncleaned == 3


def test_ccl_fixpoint_kernel_snake(dev):
    """A snake from the identity (many rounds for the plain loop) and a
    random graph, bit-equal; no entries, no launch."""
    from zuds_tpu_torch.kernels import checks, launch
    from zuds_tpu_torch.ops import detect
    rng = np.random.default_rng(3)
    det = rng.random((96, 96)) < 0.45
    det[10, 5:90] = True
    det[10:80, 89] = True
    det[79, 20:90] = True
    for mask in (det, rng.random((300, 200)) < 0.55):
        H, W = mask.shape
        flat = torch.as_tensor(np.flatnonzero(mask.ravel()), device=dev)
        inv = torch.full((H * W,), -1, dtype=torch.int64, device=dev)
        inv[flat] = torch.arange(len(flat), device=dev)
        pok = torch.ones(len(flat), dtype=torch.bool, device=dev)
        nbr_pos, nbr_ok = detect._adjacency(flat, pok, inv, (H, W))
        checks.ccl_check(nbr_pos, nbr_ok, torch.arange(len(flat), device=dev))
    n0 = launch.ccl_fixpoint.launches
    e = torch.zeros(0, dtype=torch.int64, device=dev)
    assert launch.ccl_fixpoint(e.reshape(8, 0), e.reshape(8, 0).bool(),
                               e).numel() == 0
    assert launch.ccl_fixpoint.launches == n0


@pytest.mark.parametrize('det_cap', [4096, 512])
@pytest.mark.parametrize('joined', [False, True])
def test_ccl_fixpoint_kernel_corner_pixel(dev, joined, det_cap):
    """H25 where the frame's last pixel is detected (its own backward
    edges valid, no neighbour's edge reaching it when the list has
    padding), with padding and at overflow, from the seeds and from the
    identity; two calls bit-equal."""
    from zuds_tpu_torch.bench_detect import corner_mask
    from zuds_tpu_torch.kernels import checks, launch
    from zuds_tpu_torch.ops import detect
    det = torch.as_tensor(corner_mask(joined), device=dev)
    H, W = det.shape
    diff = torch.full((H, W), 1000.0, device=dev)
    taps = detect.detect_taps(diff, torch.ones((H, W), device=dev),
                              torch.zeros((H, W), dtype=torch.int32,
                                          device=dev), det, nsigma=5.0,
                              max_det=64, deblend=False, det_cap=det_cap)
    nbr_pos, okb, lab0 = taps['ccl']
    assert (int(det.sum()) < lab0.numel()) == (det_cap == 4096)
    for lab in (lab0, torch.arange(lab0.numel(), device=dev)):
        checks.ccl_check(nbr_pos, okb, lab)
        assert torch.equal(launch.ccl_fixpoint(nbr_pos, okb, lab),
                           launch.ccl_fixpoint(nbr_pos, okb, lab))


def _clean_twice(args):
    """H27's outputs from two calls, bit-equal, each one launch."""
    from zuds_tpu_torch.bench_detect import clean_inv
    from zuds_tpu_torch.kernels import launch
    inv = clean_inv()
    n0 = launch.clean.launches
    first = launch.clean(*args, inv)
    assert launch.clean.launches == n0 + 1
    again = launch.clean(*args, inv)
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(first, again))
    return first


@pytest.mark.parametrize('nseg', [130, 1026, 4098, 4099, 50000])
def test_clean_kernel_random_rows(dev, nseg):
    """H27 on seeded rows at widths past, at and inside one 512-column
    block, bright rows close together so that CLEAN merges some
    (``bench_detect.clean_rows``); two calls bit-equal."""
    from zuds_tpu_torch.bench_detect import clean_rows
    from zuds_tpu_torch.kernels import checks
    args = clean_rows(nseg, dev)
    _, _, ncleaned, _ = checks.clean_check(args)
    assert ncleaned > 0
    _clean_twice(args)


@pytest.mark.parametrize('nseg,nvalid', [(130, None), (1026, None),
                                         (4098, None), (4099, None),
                                         (50000, None), (4098, 0),
                                         (4098, 1), (130, 1)])
def test_clean_kernel_edge_rows(dev, nseg, nvalid):
    """H27 with -0, NaN, negative, zero and equal peaks, NaN positions and
    angles, -0 fluxes (``bench_detect.clean_edge_rows``), and with no
    valid row or one; two calls bit-equal."""
    from zuds_tpu_torch.bench_detect import clean_edge_rows
    from zuds_tpu_torch.kernels import checks
    args = tuple(torch.as_tensor(v, device=dev)
                 for v in clean_edge_rows(nseg, nseg, nvalid))
    _, _, ncleaned, _ = checks.clean_check(args)
    if nvalid is None:
        assert ncleaned > 0
    flux, npix, flags, valid, contrib, tgt = _clean_twice(args)
    assert int(valid.sum()) == int(args[10].sum()) - ncleaned
    assert bool((contrib[~args[10]] == 0).all())
    assert bool((tgt[~args[10]] == nseg - 1).all())


@pytest.mark.parametrize('mode', [True, 'watershed', False])
@pytest.mark.parametrize('which', ['small', 'overflowing', 'wings'])
def test_detect_sources_kernels_equal_plain(dev, which, mode):
    from zuds_tpu_torch.kernels import checks, launch
    from zuds_tpu_torch.ops import detect
    make, kw = DETECT_SCENES[which]
    scene = make(dev)
    n0 = {k: getattr(launch, k).launches
          for k in ('seed_sweeps', 'ccl_fixpoint', 'object_stats', 'clean')}
    k = detect.detect_sources(*scene, deblend=mode, **kw)
    assert all(getattr(launch, n).launches == c + 1 for n, c in n0.items())
    with checks.plain_detect():
        p = detect.detect_sources(*scene, deblend=mode, **kw)
    assert all(getattr(launch, n).launches == c + 1 for n, c in n0.items())
    checks.detect_check(k, p, detect.detect_taps(*scene, deblend=mode,
                                                 **kw)['clean'])


def test_label_components_card_equals_cpu(dev):
    from zuds_tpu_torch.ops import detect
    g = torch.Generator(device=dev).manual_seed(0)
    m = torch.rand((512, 384), generator=g, device=dev) < 0.45
    assert torch.equal(detect.label_components(m).cpu(),
                       detect.label_components(m.cpu()))


def test_detect_ranges_read_nothing_back(dev):
    """No host copy or wait inside the ccl, stats and clean ranges."""
    from torch.profiler import ProfilerActivity, profile
    from zuds_tpu_torch.ops import detect
    from zuds_tpu_torch.profile import host_waits
    make, kw = DETECT_SCENES['small']
    scene = make(dev)
    detect.detect_sources(*scene, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        detect.detect_sources(*scene, **kw)
        torch.cuda.synchronize()
    waits = host_waits(prof)
    assert all(c == {'copies': 0, 'syncs': 0} for c in waits.values()), waits


def test_h24_h27_refuse_wrong_inputs(dev):
    from zuds_tpu_torch.kernels import launch
    det = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    pidx = torch.zeros(16, dtype=torch.int64, device=dev)
    cnt = torch.zeros((), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        launch.seed_sweeps(det, pidx, cnt, 13)
    with pytest.raises(TypeError):
        launch.seed_sweeps(det.int(), pidx, cnt, 12)
    with pytest.raises(ValueError):
        launch.seed_sweeps(det.cpu(), pidx, cnt, 12)
    with pytest.raises(TypeError):
        launch.seed_sweeps(det, pidx.int(), cnt, 12)
    with pytest.raises(ValueError):
        launch.seed_sweeps(det, pidx, cnt[None], 12)
    n = 10
    pos = torch.zeros((8, n), dtype=torch.int64, device=dev)
    ok = torch.zeros((8, n), dtype=torch.bool, device=dev)
    lab = torch.arange(n, device=dev)
    with pytest.raises(ValueError):
        launch.ccl_fixpoint(pos[:7], ok, lab)
    with pytest.raises(TypeError):
        launch.ccl_fixpoint(pos, ok, lab.int())
    f = torch.zeros(n, device=dev)
    i64 = torch.zeros(n, dtype=torch.int64, device=dev)
    b = torch.zeros(n, dtype=torch.bool, device=dev)
    nd = torch.zeros((), dtype=torch.int64, device=dev)
    args = (i64, i64, f, i64.int(), b, f, b, nd, (8, 8), 6, 5.0, 4)
    launch.object_stats(*args)
    with pytest.raises(ValueError):
        launch.object_stats(*args[:9], launch.OBJECT_MAX_ROWS + 1,
                            *args[10:])
    with pytest.raises(TypeError):
        launch.object_stats(i64, i64, f.double(), *args[3:])
    with pytest.raises(TypeError):
        launch.clean(f, f, f, f, f, f, f, f, f, i64, b, 0.5)
    with pytest.raises(ValueError):
        launch.clean(f, f, f, f, f, f, f, f, f[:5], i64.int(), b, 0.5)


def _guarded(t, fill, guard=8192):
    """``t`` copied into the middle of a buffer that holds ``fill`` for
    ``guard`` elements on either side: a read past either end of the
    tensor picks the fill up."""
    buf = torch.full((t.numel() + 2 * guard,), fill, dtype=t.dtype,
                     device=t.device)
    view = buf[guard:guard + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def _poisoned(like):
    """An output the kernel must overwrite: NaN, or 0x5a5a5a5a."""
    if like.dtype == torch.int32:
        return torch.full_like(like, 0x5a5a5a5a)
    return torch.full_like(like, float('nan'))


@pytest.mark.parametrize('H,W,window', [(200, 136, 2), (97, 131, 3),
                                        (240, 264, 8), (13, 17, 2)])
def test_warp_kernel_reads_and_writes_only_its_planes(dev, H, W, window):
    """H1, one and two planes, 20 times on inputs that lie inside NaN
    guard bands (the mask's all bits set) and into outputs filled with
    NaN or 0x5a5a5a5a: every launch bit-equal to the wrapper's launch on
    plain tensors. A read outside an input plane, a pixel left unwritten
    or a launch that differs from the next would show here (the card's
    machine has no memory checker)."""
    from zuds_tpu_torch.kernels import build, launch
    ref, wgt, mask, _, _, covb = _warp_inputs(dev, H, W, 71)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    amp = window + 0.8
    u = (xx + amp * torch.sin(yy / 23.0 + xx / 31.0)).contiguous()
    v = (yy + amp * torch.cos(xx / 19.0)).contiguous()
    u[H // 2, W // 3], v[H // 3, W // 2] = 1e6, float('nan')
    covb = torch.tensor([2.0, W - 3.0, 4.5, H - 7.0], device=dev)
    nan = float('nan')
    g = [_guarded(ref, nan), _guarded(wgt, nan), _guarded(mask, -1),
         _guarded(u, nan), _guarded(v, nan), _guarded(covb, nan)]
    for two in (False, True):
        want = launch.warp(ref, mask, u, v, covb, window,
                           ref2=wgt if two else None)
        want = (want if two else (want[0], None) + want[1:])
        for _ in range(20):
            outs = [None if w is None else _poisoned(w) for w in want]
            p = launch._ptr_or_null
            err = build.library().zuds_warp(
                p(g[0]), p(g[1] if two else None), p(g[2]), p(g[3]),
                p(g[4]), p(g[5]), p(outs[0]), p(outs[1]), p(outs[2]),
                p(outs[3]), H, W, window, launch._stream())
            build.check(err, 'zuds_warp')
            for a, b in zip(outs, want):
                assert (a is None and b is None) or torch.equal(a, b)
    assert bool(torch.isfinite(want[0]).all())


@pytest.mark.parametrize('Hs,Ws,Ho,Wo', [(200, 180, 160, 224),
                                         (97, 131, 140, 90),
                                         (64, 300, 96, 96)])
def test_warp_gather_kernel_reads_and_writes_only_its_planes(dev, Hs, Ws,
                                                             Ho, Wo):
    """H10 with two planes and a mask, as H1 above: 20 launches from
    guarded inputs into poisoned outputs, each bit-equal to the wrapper's
    launch on plain tensors."""
    from zuds_tpu_torch.kernels import build, launch
    img, wgt, mask, u, v = _gather_inputs(dev, Hs, Ws, Ho, Wo, 73)
    nan = float('nan')
    g = [_guarded(img, nan), _guarded(wgt, nan), _guarded(mask, -1),
         _guarded(u, nan), _guarded(v, nan)]
    want = launch.warp_gather(img, mask, u, v, img2=wgt)
    for _ in range(20):
        outs = [_poisoned(w) for w in want]
        p = launch._ptr_or_null
        err = build.library().zuds_warp_gather(
            p(g[0]), p(g[1]), p(g[2]), p(g[3]), p(g[4]), p(outs[0]),
            p(outs[1]), p(outs[2]), p(outs[3]), Hs, Ws, Ho, Wo,
            launch._stream())
        build.check(err, 'zuds_warp_gather')
        assert all(torch.equal(a, b) for a, b in zip(outs, want))
    assert bool(torch.isfinite(want[0]).all())
