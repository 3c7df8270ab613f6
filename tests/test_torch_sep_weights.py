"""H28 (``zuds_tpu_torch/kernels/warp.cu``, ``warp_sep_kernel``) emulated
in torch on the CPU, against the plain separable warp and float64.

H28's six derivative weights of an axis (``axis_dweights``) come from
sin and cos of pi t0 and pi t0 / 3 turned by the constants of k pi / 3,
the two centre taps from the derivative of H1's polynomial
(``lanczos3_centre_d``), and the reference's Taylor slope below
|t| < 1e-3. The emulation rounds each step to f32 as the kernel does,
with ``sinpif``/``sincospif`` and ``fmaf`` stood in for as
tests/test_torch_warp_weights.py does (whose helpers and constants, read
out of warp.cu, it reuses); nvcc may contract a product into a following
add that the source leaves separate, so it is held to float64 by a bound,
not to the card's bits.

Bounds: each derivative weight within 1e-6 of ``_lanczos3_d`` in float64
on a 2^-20 grid of phases (it enters the warp times ``dy dudy``, at most
~0.02 here, so 2e-8 of a pixel's weight); the plain f32 version, whose
closed form cancels near t = 0, is 3.8e-4 off there. The whole warp
through the emulation (H28's taps from the first tap, the rows wrapped,
pass 1 at each source row, pass 2 with the correction by FMAs, the
mask's middle four taps) on a rotated 128^2 frame: mask and coverage
bit-equal to ``warp_reference_sep_plain``, pixels within the warp
contract (rtol 3e-5, atol 5e-3) and no further from its float64 run than
the f32 plain version.
"""
import math
import re

import numpy as np
import pytest
import torch

from test_torch_warp_weights import (F32, F64, HALF_SQRT3, Q, THIRD,
                                     THREE_OVER_PI2, WARP_CU, _LIT, _f32,
                                     axis_weights, cospi, first_tap, fma,
                                     sinpi)
from zuds_tpu_torch.ops import resample

KPI = torch.tensor(np.float32(math.pi), dtype=F32)
TAYLOR = torch.tensor(_f32(re.search(
    r'constexpr float kTaylorC = (' + _LIT + ')', WARP_CU).group(1)),
    dtype=F32)
SIG = [float(np.float32(v)) for v in (resample._SIG_A, resample._SIG_B,
                                      resample._SIG_C)]


def centre_d(t):
    """lanczos3_centre_d: 2 t ((1 - s) Q'(s) - Q(s)), s = t^2."""
    s = t * t
    q = torch.full_like(t, Q[0])
    for c in Q[1:]:
        q = fma(q, s, c)
    n = len(Q) - 1
    dq = torch.full_like(t, np.float32(n * Q[0]))
    for i, c in enumerate(Q[1:-1]):
        dq = fma(dq, s, np.float32((n - 1 - i) * c))
    return (2.0 * t) * fma(1.0 - s, dq, -q)


def axis_dweights(t0):
    """warp.cu's axis_dweights: L'(t0 - k), k = 0..5, each f32."""
    s0, c0 = sinpi(t0), cospi(t0)
    a = t0 * THIRD
    sa, ca = sinpi(a), cospi(a)
    hs, hc, rs, rc = 0.5 * sa, 0.5 * ca, HALF_SQRT3 * sa, HALF_SQRT3 * ca
    s3 = [sa, hs - rc, -hs - rc, -sa, rc - hs, hs + rc]
    c3 = [ca, hc + rs, rs - hc, -ca, -hc - rs, hc - rs]
    out = []
    for k in range(6):
        t = t0 - k
        if k in (2, 3):
            d = centre_d(t)
        else:
            s1, c1 = (-s0, -c0) if k % 2 else (s0, c0)
            num = fma(KPI * c1, s3[k], ((KPI * THIRD) * s1) * c3[k])
            d = THREE_OVER_PI2 * ((num - ((2.0 * s1) * s3[k]) / t) / (t * t))
        d = torch.where(t.abs() < 1e-3, (-2.0 * TAYLOR) * t, d)
        out.append(torch.where(t.abs() < 3, d, torch.zeros_like(d)))
    return torch.stack(out)


def test_derivative_weights_against_float64():
    t0 = (2.0 + torch.arange(1 << 20, dtype=F64) / (1 << 20)).to(F32)
    t = t0[None] - torch.arange(6, dtype=F32)[:, None]
    want = resample._lanczos3_d(t.double())
    got = (axis_dweights(t0).double() - want).abs().amax(1)
    plain = (resample._lanczos3_d(t).double() - want).abs().amax(1)
    print(f'H28 L\' weights against float64 by tap {got.tolist()}; the '
          f'f32 plain version {plain.tolist()}')
    assert float(got.max()) <= 1e-6
    assert float(plain[2:4].max()) > 1e-4      # the cancellation H28 avoids


def _sig(t):
    a = t.abs()
    return (a < SIG[0]) | ((a > SIG[1]) & (a < SIG[2]))


def _axis(d, reach, deriv):
    """The six taps' offsets, weights and derivative weights (zero past
    the reach) and the taps that count, from H28's first tap."""
    d0 = first_tap(d, reach)
    t0 = d - d0.to(F32)
    k = torch.arange(6).reshape((6,) + (1,) * d.dim())
    off = d0[None] + k
    live = off.abs() <= reach
    w = torch.where(live, axis_weights(t0), 0.0)
    wd = torch.where(live, axis_dweights(t0), 0.0) if deriv else None
    return off, w, wd, live


def emulate_h28(ref, mask, u, v, covb, window, order):
    H, W = ref.shape
    reach = window + 3
    yy = torch.arange(H)[:, None].expand(H, W)
    xx = torch.arange(W)[None, :].expand(H, W)
    # pass 1 at every source row: hp, ws, hd, wsd and the mask's OR
    du = u - xx.to(F32)
    off, w, wd, live = _axis(du, reach, order)
    # hp and ws in double, hd and wsd in f32, as H28 keeps them
    hp, ws = torch.zeros(H, W, dtype=F64), torch.zeros(H, W, dtype=F64)
    hd, wsd = torch.zeros(H, W), torch.zeros(H, W)
    inner = torch.zeros(H, W, dtype=torch.int32)
    for k in range(6):
        p = ref[yy, (xx + off[k]) % W]
        hp = hp + w[k].double() * p.double()
        ws = ws + w[k].double()
        if order:
            hd = fma(wd[k], p, hd)
            wsd = wsd + wd[k]
        if 1 <= k <= 4:
            take = live[k] & _sig(du - off[k].to(F32))
            inner = inner | torch.where(take, mask[yy, (xx + off[k]) % W], 0)
    # pass 2 at each output pixel
    dv = v - yy.to(F32)
    dudy = torch.cat([u[1:] - u[:-1], u[-1:] - u[-2:-1]])
    off, wy, _, live = _axis(dv, reach, False)
    acc = torch.zeros(H, W, dtype=F64)
    wacc = torch.zeros(H, W, dtype=F64)
    m = torch.zeros(H, W, dtype=torch.int32)
    for k in range(6):
        rows = (yy + off[k]) % H
        hrow, wrow = hp[rows, xx], ws[rows, xx]
        if order:
            corr = (off[k].to(F32) * dudy).double()
            hrow = hrow - corr * hd[rows, xx].double()
            wrow = wrow - corr * wsd[rows, xx].double()
        acc = acc + wy[k].double() * hrow
        wacc = wacc + wy[k].double() * wrow
        if 1 <= k <= 4:
            take = live[k] & _sig(dv - off[k].to(F32))
            m = m | torch.where(take, inner[rows, xx], 0)
    inb = (u >= 2) & (u <= W - 3) & (v >= 2) & (v <= H - 3)
    c = inb & (u >= covb[0]) & (u <= covb[1]) & (v >= covb[2]) \
        & (v <= covb[3])
    norm = torch.where(wacc == 0, 1.0, wacc)
    return (torch.where(c, (acc / norm).to(F32), 0.0), torch.where(c, m, 0),
            c.to(F32))


@pytest.mark.parametrize('window,order', [(2, 1), (4, 1), (2, 0)])
def test_emulated_warp_against_the_plain_version(window, order):
    H = W = 128
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:H, 0:W].astype('f4')
    ref = (150 + 5 * np.sin(x / 9.0) + 4 * np.cos(y / 7.0)
           + rng.normal(0, 5, (H, W))).astype('f4')
    ref[60:71, 40:51] += (4000 * np.exp(-((x[60:71, 40:51] - 45) ** 2
                                          + (y[60:71, 40:51] - 65) ** 2)
                                        / 6.0)).astype('f4')
    mask = np.where(rng.random((H, W)) < 0.02,
                    rng.integers(0, 1 << 18, (H, W)), 0).astype('i4')
    th = math.radians(0.3)
    u = (W / 2 + math.cos(th) * (x - W / 2) - math.sin(th) * (y - H / 2)
         + 1.3).astype('f4')
    v = (H / 2 + math.sin(th) * (x - W / 2) + math.cos(th) * (y - H / 2)
         - 0.7).astype('f4')
    args = [torch.as_tensor(a) for a in (ref, mask, u, v)]
    covb = torch.tensor([2.0, W - 5.0, 3.5, H - 3.0])
    k = emulate_h28(*args, covb, window, order)
    p = resample.warp_reference_sep_plain(*args, covb, window, order)
    assert torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
    assert bool((p[1] != 0).any()) and bool((p[2] == 0).any())
    np.testing.assert_allclose(k[0].numpy(), p[0].numpy(), rtol=3e-5,
                               atol=5e-3)
    p64 = resample.warp_reference_sep_plain(
        args[0].double(), args[1], args[2].double(), args[3].double(),
        covb.double(), window, order)[0]
    c = p[2] > 0
    ek = float((k[0].double() - p64).abs()[c].max())
    ep = float((p[0].double() - p64).abs()[c].max())
    print(f'window {window} order {order}: emulated H28 {ek:.3g} from '
          f'float64, the f32 plain version {ep:.3g}')
    assert ek <= ep
