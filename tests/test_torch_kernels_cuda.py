"""The port's hand kernels (H1-H4) against their plain PyTorch versions,
on a CUDA card, at small and ragged shapes (partial tiles, partial cells).

These need the card: they skip on a CPU-only machine. The card machine has
no JAX, and tests/conftest.py imports it, so run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: warp pixels rtol 3e-5, atol 5e-3 counts, mask and coverage
bit-equal; background cells rtol 1e-4 and counts equal; model convolution
rtol 1e-4, atol 1e-3; matched filter img and det equal, filt rtol 1e-6.
"""
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize('H,W,box', [(200, 136, 64), (264, 256, 128)])
def test_background_kernel(dev, H, W, box):
    from zuds_tpu_torch.ops import background
    from zuds_tpu_torch.kernels import launch
    img = _rand((H, W), dev, 3, 5.0, 150.0)
    img[10:30, 10:40] += 500.0
    g = torch.Generator(device=dev).manual_seed(4)
    valid = torch.rand((H, W), generator=g, device=dev) > 0.05
    k = launch.background_cells(img, valid, box, 3)
    p = background.background_cells_plain(img, valid, box, 3)
    _allclose(k[0], p[0], 1e-4, 0.0)
    _allclose(k[1], p[1], 1e-4, 0.0)
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


@pytest.mark.parametrize('H,W', [(200, 136), (33, 70)])
def test_detect_filter_kernel(dev, H, W):
    from zuds_tpu_torch.ops import detect
    from zuds_tpu_torch.kernels import detect_filter
    diff = _rand((H, W), dev, 7, 8.0)
    diff[5, 5] = float('nan')
    diff[6, 9] = float('inf')
    rms = (_rand((H, W), dev, 8, 0.5, 5.0)).abs()
    rms[3, 3] = 0.0
    g = torch.Generator(device=dev).manual_seed(9)
    wok = torch.rand((H, W), generator=g, device=dev) > 0.02
    n0 = detect_filter.detect_filter.launches
    k = detect.matched_filter(diff, rms, wok, 1.5)
    assert detect_filter.detect_filter.launches == n0 + 1
    p = detect.matched_filter_plain(diff, rms, wok, 1.5)
    assert torch.equal(k[0], p[0]) and torch.equal(k[2], p[2])
    _allclose(k[1], p[1], 1e-6, 0.0)
