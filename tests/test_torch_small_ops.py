"""K21, the reference's small exported ops, against the JAX package on the
same seeded numpy inputs: ``box_mask_or`` (bit-equal), ``fft_convolve_same``
and ``gaussian_kernel`` (f32 tolerances: rtol 1e-5 and 1e-6 of the
output's largest magnitude for the FFT convolution, whose transforms round
in other orders; rtol 1e-6 for the Gaussian, summed in another order), and
the flat ``zuds_tpu_torch.ops`` namespace against ``zuds_tpu.ops``.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zuds_tpu.ops import convolve as jconv
from zuds_tpu.ops import resample as jres
from zuds_tpu_torch.ops import convolve as tconv
from zuds_tpu_torch.ops import resample as tres

ROOT = Path(__file__).resolve().parent.parent


def _mask(H, W, seed, p=0.01):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << 18, (H, W))
    return np.where(rng.random((H, W)) < p, bits, 0).astype(np.int32)


@pytest.mark.parametrize('reach', [1, 3, 7, 11])
def test_box_mask_or_bit_equal(reach):
    m = _mask(97, 131, reach)
    m[0, 0] = 1 << 17
    m[-1, 5] = 3
    m[40, -1] = 1 << 9
    want = np.asarray(jres.box_mask_or(jnp.asarray(m), reach=reach))
    got = tres.box_mask_or(torch.from_numpy(m), reach=reach).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # each pixel holds the OR of its (2 reach + 1)^2 box, edges padded 0
    y, x = 50, 60
    box = m[max(y - reach, 0):y + reach + 1, max(x - reach, 0):x + reach + 1]
    assert int(got[y, x]) == int(np.bitwise_or.reduce(box.ravel()))


@pytest.mark.parametrize('H,W,kh,kw', [(64, 80, 9, 9), (50, 37, 15, 7),
                                       (33, 33, 1, 1)])
def test_fft_convolve_same(H, W, kh, kw):
    rng = np.random.default_rng(H + kh)
    img = (100 + 10 * rng.standard_normal((H, W))).astype(np.float32)
    k = rng.random((kh, kw)).astype(np.float32)
    want = np.asarray(jconv.fft_convolve_same(jnp.asarray(img), k))
    got = tconv.fft_convolve_same(torch.from_numpy(img), k).numpy()
    assert got.shape == want.shape == (H, W) and got.dtype == want.dtype
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
    # against the direct sum in float64
    pad = np.pad(img.astype(np.float64),
                 ((kh - 1 - kh // 2, kh // 2), (kw - 1 - kw // 2, kw // 2)))
    direct = np.zeros((H, W))
    for dy in range(kh):
        for dx in range(kw):
            direct += k[kh - 1 - dy, kw - 1 - dx] * pad[dy:dy + H, dx:dx + W]
    np.testing.assert_allclose(got, direct, rtol=1e-5, atol=1e-6 * scale)
    kt = tconv.fft_convolve_same(torch.from_numpy(img), torch.from_numpy(k))
    assert torch.equal(kt, torch.from_numpy(got))


@pytest.mark.parametrize('sigma,size', [(1.3, 9), (2.5, 15), (0.8, 3)])
def test_gaussian_kernel(sigma, size):
    want = np.asarray(jconv.gaussian_kernel(sigma, size))
    got = tconv.gaussian_kernel(sigma, size, device='cpu').numpy()
    assert got.shape == want.shape == (size, size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert abs(float(got.sum(dtype=np.float64)) - 1.0) < 1e-6


def test_ops_namespace_is_the_reference_s():
    import zuds_tpu.ops as jops
    import zuds_tpu_torch.ops as tops
    assert list(tops.__all__) == list(jops.__all__)
    assert all(hasattr(tops, n) for n in tops.__all__)
    assert tops.fft_convolve_same is tconv.fft_convolve_same
    assert np.array_equal(tops.DEFAULT_FILTER, np.asarray(jops.DEFAULT_FILTER))


def test_ops_import_needs_no_card_or_triton():
    """Importing the flat namespace in a fresh process loads no ``triton``,
    builds no kernel and does not initialise CUDA."""
    code = ('import sys, torch\n'
            'sys.modules["triton"] = None\n'
            'import zuds_tpu_torch.ops as o\n'
            'from zuds_tpu_torch.kernels import build\n'
            'assert len(o.__all__) == 24\n'
            'assert build.library.cache_info().currsize == 0\n'
            'assert not torch.cuda.is_initialized()\n'
            'print("ok")\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr
