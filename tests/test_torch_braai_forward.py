"""The precision of H13 (``kernels/braai.cu``, braai's forward convolution at
layers 2-4: a 3xTF32 implicit GEMM on the card's tensor cores) emulated on
the CPU, at the full width of the d6 net and a batch of 4.

* ``cvt.rna`` on the uint32 view (round half away from zero on the 13
  dropped mantissa bits), each operand split v = hi + lo with hi = tf32(v)
  and lo = tf32(v - hi); lo*hi + hi*lo + hi*hi in f32 over a chain of 32
  input channels (4 k-steps), the chains added into the sum by Kahan's
  compensated sum as the kernel flushes them. On ``inputs.spread_braai``'s
  seed-0 weights and ``inputs.labelled_triplets``, each layer's output
  (bias, ReLU, pool) comes within 1e-5 of the float64 output's largest
  magnitude and no further from float64 than 4 times the fp32 plain
  version (``conv3x3_plain``).
* The split of a non-finite value: the kernel puts it whole into lo with
  hi = 0, and drops the flush's compensation where the sum is not finite,
  so +-inf and NaN come out exactly where ``conv3x3_plain`` puts them. The
  split with lo = 0 instead would add inf * w_lo, NaN wherever w_lo is 0
  or of the other sign than w_hi.
"""
import numpy as np
import pytest
import torch

from zuds_tpu_torch import inputs
from zuds_tpu_torch.kernels import launch
from zuds_tpu_torch.models import braai

torch.set_num_threads(2)

N = 4
CHAIN = 32      # input channels a chain: the kernel flushes every 4 k-steps


def tf32_rna(a):
    """``cvt.rna.tf32.f32`` in numpy: the 13 low mantissa bits dropped,
    the magnitude rounded half away from zero (the sign bit is apart)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_nf(a):
    """The kernel's split (``split_nf``): hi = tf32(v), lo = tf32(v - hi);
    a value whose hi is not finite goes whole into lo, hi = 0."""
    a = np.asarray(a, np.float32)
    h = tf32_rna(a)
    fin = np.isfinite(h)
    with np.errstate(invalid='ignore'):
        lo = tf32_rna(np.where(fin, a - np.where(fin, h, 0), 0))
    return np.where(fin, h, 0).astype(np.float32), \
        np.where(fin, lo, a).astype(np.float32)


def split_lo0(a):
    """The split that keeps a non-finite value in hi with lo = 0."""
    a = np.asarray(a, np.float32)
    h = tf32_rna(a)
    with np.errstate(invalid='ignore'):
        lo = tf32_rna(a - h)
    return h, np.where(np.isfinite(a), lo, 0).astype(np.float32)


def relu_nan(v):
    with np.errstate(invalid='ignore'):
        return np.where((v > 0) | np.isnan(v), v, 0).astype(np.float32)


def conv_3xtf32(x, w, b, pool, split=split_nf):
    """H13's arithmetic in numpy: x (N, H, W, Cin) f32, w (3, 3, Cin,
    Cout), b (Cout,); the convolution outputs a pooled layer's pool reads,
    then bias, ReLU and the floor 2x2 max pool."""
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    he, we = h - 2, wd - 2
    if pool:
        he, we = 2 * (he // 2), 2 * (we // 2)
    xh, xl = split(x)
    wh, wl = split(w)
    s = np.zeros((n * he * we, cout), np.float32)
    acc = np.zeros_like(s)
    with np.errstate(invalid='ignore', over='ignore'):
        for ky in range(3):
            for kx in range(3):
                for c0 in range(0, cin, CHAIN):
                    sl = slice(c0, c0 + CHAIN)
                    ah = xh[:, ky:ky + he, kx:kx + we, sl].reshape(-1, CHAIN)
                    al = xl[:, ky:ky + he, kx:kx + we, sl].reshape(-1, CHAIN)
                    bh, bl = wh[ky, kx, sl], wl[ky, kx, sl]
                    chain = acc + (al @ bh + ah @ bl) + ah @ bh
                    t = s + chain
                    acc = np.where(np.isfinite(t), chain - (t - s), 0)
                    s = t.astype(np.float32)
        s = s + acc
    y = relu_nan(s.reshape(n, he, we, cout) + b)
    if pool:
        y = y.reshape(n, he // 2, 2, we // 2, 2, cout).max(axis=(2, 4))
    return y


@pytest.fixture(scope='module')
def layer_inputs():
    """Each layer's input, weights and bias: the spread seed-0 net on
    ``labelled_triplets(4)``, the earlier layers by the plain version."""
    model, params = braai.init_braai(0, device='cpu')
    model.load_params(inputs.spread_braai(params))
    t, _ = inputs.labelled_triplets(N, seed=11)
    x = torch.as_tensor(t)
    out = []
    with torch.no_grad():
        for i, (_, _, pool) in enumerate(launch.BRAAI_LAYERS):
            layer = getattr(model, f'Conv_{i}')
            w, b = layer['kernel'].detach(), layer['bias'].detach()
            out.append((x, w, b, pool))
            x = braai.conv3x3_plain(x, w, b, pool)
    return out


@pytest.mark.parametrize('i', (1, 2, 3))
def test_h13_precision_3xtf32(layer_inputs, i):
    x, w, b, pool = layer_inputs[i]
    emu = conv_3xtf32(x.numpy(), w.numpy(), b.numpy(), pool)
    ref = braai.conv3x3_plain(x.double(), w.double(), b.double(),
                              pool).numpy()
    plain = braai.conv3x3_plain(x, w, b, pool).numpy()
    assert emu.shape == ref.shape
    e3 = float(np.abs(emu.astype(np.float64) - ref).max())
    ep = float(np.abs(plain.astype(np.float64) - ref).max())
    scale = float(np.abs(ref).max())
    assert scale > 0 and e3 <= 1e-5 * scale, (e3, scale)
    assert e3 <= 4 * ep, (e3, ep)


@pytest.mark.parametrize('i', (2, 3))
def test_h13_split_of_non_finite_values(layer_inputs, i):
    """A +inf, a -inf and a NaN input value (one channel each, apart):
    the emulated kernel has NaN and +-inf exactly where the plain version
    has them; the lo = 0 split does not."""
    x, w, b, pool = layer_inputs[i]
    x = x[:2].clone()
    side = x.shape[1]
    x[0, 3, 4, 0] = float('inf')
    x[0, side - 4, side - 5, 1] = float('-inf')
    x[1, side // 2, side // 2, 2] = float('nan')
    plain = braai.conv3x3_plain(x, w, b, pool).numpy()
    assert np.isnan(plain).any() and np.isposinf(plain).any()
    emu = conv_3xtf32(x.numpy(), w.numpy(), b.numpy(), pool)
    assert np.array_equal(np.isnan(emu), np.isnan(plain))
    assert np.array_equal(np.isposinf(emu), np.isposinf(plain))
    fin = np.isfinite(plain)
    assert np.abs(emu[fin] - plain[fin]).max() \
        <= 1e-5 * np.abs(plain[fin]).max()
    naive = conv_3xtf32(x.numpy(), w.numpy(), b.numpy(), pool, split_lo0)
    assert np.isnan(naive[np.isposinf(plain)]).any()
