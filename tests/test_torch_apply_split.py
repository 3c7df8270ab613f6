"""The 3xTF32 arithmetic of hand kernel H3 (kernels/apply.cu), emulated in
plain torch on the CPU and held against the JAX reference's apply_kernel.

The card's kernel cannot run here; this shows that its arithmetic meets
the contract before any card run. The emulation, kept in this file only:
round f32 to TF32 as ``cvt.rna.tf32.f32`` does (to nearest, ties away from
zero, 10 explicit mantissa bits) by integer operations on the int32 view;
split both operands, x_hi = tf32(x), x_lo = tf32(x - x_hi); form the dense
per-region kernels kd; and convolve as the three products
ref_hi*kd_hi + ref_hi*kd_lo + ref_lo*kd_hi, each exact in f32 and summed in
f32, then blend the terms in order. Tolerance: the card gate, rtol 1e-4
and atol 1e-3 counts on a frame with stars up to ~3000 counts. One pass
(ref_hi*kd_hi) misses that gate, which is why the kernel takes three.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from zuds_tpu.ops import subtract as js
from zuds_tpu_torch import inputs
from zuds_tpu_torch.ops import subtract as ts

H = W = 96
K, ORDER, NREG = 15, 4, 3


def tf32(x):
    """f32 -> TF32 (as f32 bits), round to nearest with ties away."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def emulate(ref, coeffs, basis, order, nreg, passes=3):
    """The model as H3 computes it (``passes=1``: 1xTF32)."""
    Hh, Ww = ref.shape
    Nb, k = basis[0].shape
    terms = ts.spatial_terms(order)
    Nm, R2 = len(terms), nreg * nreg
    a = coeffs[:, :Nb * Nm].reshape(R2, Nb, Nm)
    kd = torch.einsum('rnm,nkl->rmkl', a, ts.dense_basis(*basis))
    (rh, rl), (kh, kl) = split(ref), split(kd.reshape(R2 * Nm, 1, k, k))

    def conv(img, w):
        return F.conv2d(img[None, None], w, padding=k // 2)[0]

    acc = conv(rh, kh)
    if passes == 3:
        acc = acc + conv(rh, kl) + conv(rl, kh)
    acc = acc.reshape(R2, Nm, Hh, Ww)
    ye, xe = ts.region_edges(Hh, nreg), ts.region_edges(Ww, nreg)
    model = torch.empty_like(ref)
    for ri in range(nreg):
        for rj in range(nreg):
            r = ri * nreg + rj
            sy, sx = slice(ye[ri], ye[ri + 1]), slice(xe[rj], xe[rj + 1])
            xs = torch.arange(xe[rj], xe[rj + 1], dtype=torch.float32)
            ys = torch.arange(ye[ri], ye[ri + 1], dtype=torch.float32)
            xn = ((xs - (rj + 0.5) * Ww / nreg) / (Ww / (2.0 * nreg)))[None]
            yn = ((ys - (ri + 0.5) * Hh / nreg) / (Hh / (2.0 * nreg)))[:, None]
            out = torch.zeros_like(acc[r, 0, sy, sx]) + coeffs[r, -1]
            for m, (p, q) in enumerate(terms):
                out = out + (xn ** p) * (yn ** q) * acc[r, m, sy, sx]
            model[sy, sx] = out
    return model


@pytest.fixture(scope='module')
def scene():
    rng = np.random.default_rng(11)
    b = inputs.KernelBasis(K, 2.0 / 2.355)
    nm = len(ts.spatial_terms(ORDER))
    coeffs = rng.normal(0, 0.01, (NREG * NREG, b.nbasis * nm + 1))
    coeffs[:, 0] += 1.0
    coeffs[:, -1] = rng.normal(0, 3, NREG * NREG)
    coeffs = coeffs.astype('f4')
    ref = rng.normal(150, 5, (H, W)).astype('f4')
    yy, xx = np.mgrid[:H, :W]
    for x0, y0 in rng.uniform(4, H - 4, (8, 2)):
        ref += (3000 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                              / (2 * 1.4 ** 2))).astype('f4')
    basis = (b.gx, b.gy, b.sums, b.b0_2d)
    want = np.asarray(js.apply_kernel(
        jnp.asarray(ref), jnp.asarray(coeffs),
        *(jnp.asarray(x) for x in basis), order=ORDER, nreg=NREG))
    tb = [torch.as_tensor(x) for x in basis]
    return torch.as_tensor(ref), torch.as_tensor(coeffs), tb, want


def _excess(got, want):
    """Largest |got - want| / (atol + rtol |want|) at the card gate."""
    return float(np.max(np.abs(got - want) / (1e-3 + 1e-4 * np.abs(want))))


def test_three_pass_split_meets_the_card_gate(scene):
    ref, coeffs, basis, want = scene
    got = emulate(ref, coeffs, basis, ORDER, NREG).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_one_pass_tf32_misses_the_card_gate(scene):
    ref, coeffs, basis, want = scene
    one = emulate(ref, coeffs, basis, ORDER, NREG, passes=1).numpy()
    three = emulate(ref, coeffs, basis, ORDER, NREG).numpy()
    assert _excess(one, want) > 1.0
    assert _excess(three, want) < 0.5 * _excess(one, want)


@pytest.mark.parametrize('x,want', [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),            # tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),            # below the tie: down
    (3.0 * 2.0 ** -12, 3.0 * 2.0 ** -12),            # already TF32
])
def test_tf32_rounds_as_cvt_rna(x, want):
    got = tf32(torch.tensor([x], dtype=torch.float32))
    assert float(got[0]) == want


def test_split_keeps_22_bits():
    rng = np.random.default_rng(3)
    x = torch.as_tensor((rng.normal(size=4096) * 10.0 **
                         rng.uniform(-3, 4, 4096)).astype('f4'))
    hi, lo = split(x)
    assert bool((tf32(hi) == hi).all() and (tf32(lo) == lo).all())
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -22
