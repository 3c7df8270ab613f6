"""The Lanczos-3 weights of the warp kernels H1 and H10
(``zuds_tpu_torch/kernels/warp.cu``, ``axis_weights``), emulated in torch
on the CPU, against the plain version's ``ops.resample.lanczos3`` and
against float64.

The kernel forms an axis's six weights at t_k = t0 - k (t0 in [2, 3)) from
exact identities: sin(pi t_k) = (-1)^k sinpi(t0); sin(pi t_k / 3) by turning
sincospi(t0 / 3) through the constants cos(k pi / 3), sin(k pi / 3) at the
outer taps k = 0, 1, 4, 5, with one division a tap; the two centre taps
(|t| < 1) as (1 - t)(1 + t) Q(t^2), a degree-7 polynomial. The emulation
rounds every step to f32 as the kernel does, stands in for ``sinpif`` and
``sincospif`` by float64 sin(pi r), cos(pi r) rounded to f32, r = x - 2
round(x / 2) (the exact reduction ``sinpif`` makes first; the card's are
within 1 ulp), and for ``fmaf`` by the float64 product (exact for f32
operands) and sum rounded to f32.

Bounds: each emulated weight within 2e-7 of ``lanczos3`` in f32 (the two
f32 forms' errors against float64 added); against float64 the emulation's
largest error no larger than ``lanczos3``'s, per tap, on a dense grid of
phases. A small warp through the emulated weights (H1's rows summed first
with FMAs, its normaliser sum_dy (sum_dx wx) wy; H10's normaliser
(sum wx)(sum wy)) within the warp contract of the plain versions (rtol
3e-5, atol 5e-3), its rms error against the float64 warp under the f32
plain version's. H1's and H10's mask paths test only the middle 4x4 of the 6x6
candidate taps: the emulation of that is bit-equal to the plain masks.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from zuds_tpu_torch.bench_warp import star_field
from zuds_tpu_torch.ops import resample

F32 = torch.float32
F64 = torch.float64
# The emulation reads its constants out of the kernel's source, so that it
# follows any change there: the named constexpr floats, lanczos3_centre's
# coefficients (highest power first) and the signs of the turn.
WARP_CU = (Path(resample.__file__).resolve().parents[1] / 'kernels'
           / 'warp.cu').read_text()
_LIT = r'-?(?:0x[0-9a-fA-F.]+p[-+]?\d+|\d+\.\d*(?:e[-+]?\d+)?)f'


def _f32(lit):
    lit = lit[:-1]
    return float(np.float32(float.fromhex(lit) if 'x' in lit else float(lit)))


def _constant(name):
    """A ``constexpr float name = a;`` or ``= a / b;`` of warp.cu, as the
    kernel's f32."""
    m = re.search(rf'constexpr float {name} = ({_LIT})(?: / ({_LIT}))?;',
                  WARP_CU)
    assert m, name
    a = torch.tensor(_f32(m.group(1)), dtype=F32)
    return a if m.group(2) is None else a / _f32(m.group(2))


THIRD = _constant('kThird')
THREE_OVER_PI2 = _constant('kThreeOverPi2')
HALF_SQRT3 = _constant('kHalfSqrt3')
_CENTRE = re.search(r'float lanczos3_centre\(float t\) \{(.*?)\n\}', WARP_CU,
                    re.S).group(1)
Q = [_f32(h) for h in re.findall(r'(?:q = |fmaf\(q, s, )(' + _LIT + ')',
                                  _CENTRE)]
# s3[k] = fmaf(+-kHalfSqrt3, ca, +-hs): k -> (sign of the first, of hs)
TURN = {int(k): (-1.0 if a else 1.0, -1.0 if b else 1.0) for k, a, b in
        re.findall(r's3\[(\d)\] = fmaf\((-?)kHalfSqrt3, ca, (-?)hs\)',
                   WARP_CU)}
# each f32 form's error against float64 is under 1e-7 on the grid
WEIGHT_ATOL = 2e-7


def _reduced(x):
    """x - 2 round(x / 2), exact: sinpif's own first step."""
    x = x.to(F64)
    return x - 2.0 * torch.round(x / 2.0)


def sinpi(x):
    return torch.sin(math.pi * _reduced(x)).to(F32)


def cospi(x):
    return torch.cos(math.pi * _reduced(x)).to(F32)


def fma(a, b, c):
    a, b, c = (torch.as_tensor(z, dtype=F32) for z in (a, b, c))
    return (a.to(F64) * b.to(F64) + c.to(F64)).to(F32)


def centre(t):
    a = t.abs()
    s = t * t
    q = torch.full_like(t, Q[0])
    for c in Q[1:]:
        q = fma(q, s, c)
    return ((1.0 - a) * (1.0 + a)) * q


def axis_weights(t0):
    """warp.cu's axis_weights: the six weights at t0 - k, each f32."""
    s0 = sinpi(t0)
    a = t0 * THIRD
    sa, ca = sinpi(a), cospi(a)
    hs = 0.5 * sa
    s3 = {0: sa}
    s3.update({k: fma(a * HALF_SQRT3, ca, b * hs)
               for k, (a, b) in TURN.items()})
    w = []
    for k in range(6):
        t = t0 - k
        if k in (2, 3):
            w.append(centre(t))
            continue
        st = -s0 if k % 2 else s0
        num = (st * s3[k]) * THREE_OVER_PI2
        lk = num / (t * t)
        w.append(torch.where(t.abs() < 3, lk, torch.zeros_like(lk)))
    return torch.stack(w)


def first_tap(d, reach):
    """warp.cu's first_tap: fminf/fmaxf take a NaN to the lower bound."""
    f = torch.fmin(torch.fmax(torch.floor(d), torch.tensor(-reach - 4.0)),
                   torch.tensor(reach + 4.0))
    return f.to(torch.int64) - 2


def h1_weights(d, reach):
    """The taps and weights H1 forms for the offsets ``d``: (first tap,
    (6, ...) weights with the taps past ``reach`` zeroed)."""
    d0 = first_tap(d, reach)
    w = axis_weights(d - d0.to(F32))
    k = torch.arange(6).reshape((6,) + (1,) * d.dim())
    return d0, torch.where((d0 + k).abs() <= reach, w, torch.zeros_like(w))


def lanczos64(t):
    t = t.to(F64)
    return torch.where(t.abs() < 3, torch.sinc(t) * torch.sinc(t / 3),
                       torch.zeros_like(t))


def phases(n=1 << 20):
    return torch.arange(n, dtype=F64).div(n).to(F32)


@pytest.mark.parametrize('offset', [0.0, 1.0, -1.0, -3.0, 2.0])
def test_weights_on_a_dense_grid(offset):
    """Displacements d = offset + phase on a 2^-20 grid of phases, each
    tap's weight against ``lanczos3`` at the same t (the plain version's
    d - dx) and against float64."""
    d = (phases() + offset).to(F32)
    d0, w = h1_weights(d, reach=11)
    for k in range(6):
        t = d - (d0 + k).to(F32)
        plain = resample.lanczos3(t)
        exact = lanczos64(t)
        assert float((w[k] - plain).abs().max()) <= WEIGHT_ATOL
        err = float((w[k].to(F64) - exact).abs().max())
        plain_err = float((plain.to(F64) - exact).abs().max())
        assert err <= plain_err, (k, err, plain_err)


def test_weights_rms_against_float64():
    """Over the whole grid the weights' rms error is under the plain
    version's, and so is the error of the normalised weights w / sum w,
    which is what a warp's output sees."""
    t0 = phases() + 2.0
    w = axis_weights(t0)
    t = torch.stack([t0 - k for k in range(6)])
    plain = resample.lanczos3(t)
    exact = lanczos64(t)
    for got in (w, plain):
        assert torch.isfinite(got).all()
    rms = float((w.to(F64) - exact).pow(2).mean().sqrt())
    plain_rms = float((plain.to(F64) - exact).pow(2).mean().sqrt())
    assert rms < plain_rms
    norm = (w.to(F64) / w.to(F64).sum(0) - exact / exact.sum(0)).abs().max()
    plain_norm = (plain.to(F64) / plain.to(F64).sum(0)
                  - exact / exact.sum(0)).abs().max()
    assert float(norm) <= float(plain_norm)


def test_weights_at_a_tap_on_zero():
    """t0 = 2 exactly (u an integer): the tap at t = 0 weighs exactly 1,
    the others exactly 0; at a half-integer each weight is within half an
    ulp of its float64 value."""
    w = axis_weights(torch.tensor([2.0]))[:, 0]
    assert w.tolist() == [0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
    d = torch.tensor([-5.0, -1.0, 0.0, 3.0, 5.0])
    d0, w = h1_weights(d, reach=5)
    assert torch.equal(d - d0.to(F32), torch.full((5,), 2.0))
    assert torch.equal(w[2], torch.ones(5))
    assert bool((w[[0, 1, 3, 4, 5]] == 0).all())
    h = axis_weights(torch.tensor([2.5]))[:, 0]
    exact = lanczos64(torch.tensor([2.5, 1.5, 0.5, -0.5, -1.5, -2.5]))
    assert float((h.to(F64) - exact).abs().max()) < 6e-8


def test_weights_past_reach_and_clamp():
    """Taps past the reach carry 0; a displacement past the clamp puts all
    six taps past it (all 0), as does NaN."""
    reach = 5
    d = torch.tensor([5.3, -5.7, 7.9, -9.2, 1e6, -3e9, float('nan')])
    d0, w = h1_weights(d, reach)
    for j in range(d.numel()):
        for k in range(6):
            dx = int(d0[j]) + k
            if abs(dx) > reach:
                assert float(w[k, j]) == 0.0
            else:
                t = d[j:j + 1] - float(dx)
                assert abs(float(w[k, j] - resample.lanczos3(t)[0])) \
                    <= WEIGHT_ATOL
    assert bool((w[:, 4:] == 0).all())
    assert int(d0[4]) == reach + 2 and int(d0[5]) == -reach - 6
    assert bool(torch.isfinite(w).all())


def _scene(H, W, seed):
    """A star field (``bench_warp.star_field``: noise 5 about 150 counts,
    stars to 1e5) and a 3% 18-bit mask."""
    rng = np.random.default_rng(seed + 100)
    bits = rng.integers(0, 1 << 18, (H, W))
    mask = np.where(rng.random((H, W)) < 0.03, bits, 0).astype(np.int32)
    return (torch.from_numpy(star_field(H, W, seed, nstar=25)),
            torch.from_numpy(mask))


def _smooth(H, W, amp_u, amp_v):
    yy = torch.arange(H, dtype=F32)[:, None]
    xx = torch.arange(W, dtype=F32)[None, :]
    u = xx + amp_u * torch.sin(xx / 41.0 + 0.3) * torch.cos(yy / 53.0 - 0.3)
    v = yy + amp_v * torch.sin(xx / 41.0 + 1.1) * torch.cos(yy / 53.0 - 1.1)
    return u.contiguous(), v.contiguous()


def _rms(got, want64, covered):
    """The rms error of ``got`` against a float64 result on the covered
    pixels. At these sizes the largest error is a rounding of the few
    brightest pixels, a draw between the two f32 forms; the rms is not
    (chip_smoke.py and the card tests hold the largest at full frames)."""
    return float((got.double() - want64)[covered].pow(2).mean().sqrt())


def h1_emulated(ref, u, v, covb, window):
    """H1's pixels through the emulated weights: the rows summed first with
    FMAs, the normaliser sum_dy (sum_dx wx) wy, 0 outside the coverage."""
    H, W = ref.shape
    reach = window + 3
    yy = torch.arange(H)[:, None]
    xx = torch.arange(W)[None, :]
    dx0, wx = h1_weights(u - xx.to(F32), reach)
    dy0, wy = h1_weights(v - yy.to(F32), reach)
    wxsum = torch.zeros_like(u)
    for k in range(6):
        wxsum = wxsum + wx[k]
    acc = torch.zeros_like(u)
    wacc = torch.zeros_like(u)
    for ky in range(6):
        rows = (yy + dy0 + ky) % H
        racc = torch.zeros_like(u)
        for kx in range(6):
            racc = fma(wx[kx], ref[rows, (xx + dx0 + kx) % W], racc)
        acc = fma(wy[ky], racc, acc)
        wacc = fma(wxsum, wy[ky], wacc)
    norm = torch.where(wacc == 0, torch.ones_like(wacc), wacc)
    inb = (u >= 2) & (u <= W - 3) & (v >= 2) & (v <= H - 3)
    covo = (u >= covb[0]) & (u <= covb[1]) & (v >= covb[2]) & (v <= covb[3])
    c = inb & covo
    return torch.where(c, acc / norm, torch.zeros_like(acc)), c


def h1_mask_emulated(mask, u, v, covb, window):
    """H1's mask path: only the middle 4x4 of the candidate taps, the
    column test at the intermediate row's u."""
    H, W = mask.shape
    reach = window + 3
    yy = torch.arange(H)[:, None]
    xx = torch.arange(W)[None, :]
    dv = v - yy.to(F32)
    dy0 = first_tap(dv, reach)
    m = torch.zeros_like(mask)
    for ky in range(1, 5):
        dy = dy0 + ky
        rows = (yy + dy) % H
        rok = (dy.abs() <= reach) & resample._sig_lanczos(dv - dy.to(F32))
        dur = u[rows, xx.expand(H, W)] - xx.to(F32)
        ex0 = first_tap(dur, reach)
        for kx in range(1, 5):
            dx = ex0 + kx
            take = rok & (dx.abs() <= reach) & resample._sig_lanczos(
                dur - dx.to(F32))
            m = m | torch.where(take, mask[rows, (xx + dx) % W],
                                torch.zeros_like(m))
    inb = (u >= 2) & (u <= W - 3) & (v >= 2) & (v <= H - 3)
    covo = (u >= covb[0]) & (u <= covb[1]) & (v >= covb[2]) & (v <= covb[3])
    return torch.where(inb & covo, m, torch.zeros_like(m))


@pytest.mark.parametrize('H,W,window,amp', [(256, 256, 2, (1.9, 1.7)),
                                            (200, 136, 3, (-2.9, 2.6)),
                                            (97, 131, 8, (9.5, -10.0))])
def test_h1_emulated_warp_against_plain(H, W, window, amp):
    """A small warp through the emulated weights: within the warp contract
    of ``warp_reference_plain``, closer to its float64 run (rms) than the
    f32 plain version, the 4x4 mask bit-equal."""
    ref, mask = _scene(H, W, 3)
    u, v = _smooth(H, W, *amp)
    covb = torch.tensor([4.0, W - 9.0, 3.5, H - 6.0])
    out, c = h1_emulated(ref, u, v, covb, window)
    pw, pm, pc = resample.warp_reference_plain(ref, mask, u, v, covb, window)
    assert torch.equal(c.to(F32), pc) and 0.5 < float(pc.mean()) < 1
    err = (out - pw).abs()
    assert bool((err <= 5e-3 + 3e-5 * pw.abs()).all()), float(err.max())
    p64, _, _ = resample.warp_reference_plain(ref.double(), mask, u.double(),
                                              v.double(), covb.double(),
                                              window)
    assert _rms(out, p64, c) < _rms(pw, p64, c)
    assert torch.equal(h1_mask_emulated(mask, u, v, covb, window), pm)


def _rotated(Ho, Wo, deg, off):
    yy = torch.arange(Ho, dtype=F64)[:, None]
    xx = torch.arange(Wo, dtype=F64)[None, :]
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    u = c * xx - s * yy + off[0]
    v = s * xx + c * yy + off[1]
    return u.to(F32).contiguous(), v.to(F32).contiguous()


def h10_emulated(img, mask, u, v):
    """H10 through the emulated weights: the rows summed first with FMAs,
    the normaliser (sum wx)(sum wy), the select on the coverage; the mask
    over the middle 4x4 taps with the column tests made once."""
    Hs, Ws = img.shape
    fiu = torch.floor(u).clamp(-2.0 ** 30, 2.0 ** 30)
    fiv = torch.floor(v).clamp(-2.0 ** 30, 2.0 ** 30)
    iu, iv = fiu.to(torch.int64), fiv.to(torch.int64)
    fu, fv = u - fiu, v - fiv
    inb = ((iu - 2 >= 0) & (iu + 3 <= Ws - 1) & (iv - 2 >= 0)
           & (iv + 3 <= Hs - 1))
    iuc, ivc = iu.clamp(2, Ws - 4), iv.clamp(2, Hs - 4)
    wx, wy = axis_weights(fu + 2.0), axis_weights(fv + 2.0)
    wxs = torch.zeros_like(u)
    wys = torch.zeros_like(u)
    for k in range(6):
        wxs = wxs + wx[k]
        wys = wys + wy[k]
    acc = torch.zeros_like(u)
    for ky in range(6):
        racc = torch.zeros_like(u)
        for kx in range(6):
            racc = fma(wx[kx], img[ivc + ky - 2, iuc + kx - 2], racc)
        acc = fma(wy[ky], racc, acc)
    wsum = wxs * wys
    norm = torch.where(wsum == 0, torch.ones_like(wsum), wsum)
    out = torch.where(inb, acc / norm, torch.zeros_like(acc))
    sx = [resample._sig_lanczos(fu - dx) for dx in range(-1, 3)]
    m = torch.zeros(u.shape, dtype=mask.dtype)
    for jy, dy in enumerate(range(-1, 3)):
        takey = resample._sig_lanczos(fv - dy)
        for jx, dx in enumerate(range(-1, 3)):
            m = m | torch.where(takey & sx[jx], mask[ivc + dy, iuc + dx],
                                torch.zeros_like(m))
    return out, torch.where(inb, m, torch.zeros_like(m)), inb


@pytest.mark.parametrize('Hs,Ws,Ho,Wo,deg', [(256, 256, 256, 256, 0.5),
                                             (200, 180, 160, 224, 7.0)])
def test_h10_emulated_warp_against_plain(Hs, Ws, Ho, Wo, deg):
    """The gather through the emulated weights: within the warp contract
    of ``_gather_plain``, closer to its float64 run (rms), the mask
    bit-equal."""
    img, mask = _scene(Hs, Ws, 5)
    u, v = _rotated(Ho, Wo, deg, (0.06 * Ws + 0.3, -0.05 * Hs - 0.7))
    out, m, inb = h10_emulated(img, mask, u, v)
    (pa,), pm, pc = resample._gather_plain([img], mask, u, v)
    assert torch.equal(inb.to(F32), pc) and 0.3 < float(pc.mean()) <= 1
    err = (out - pa).abs()
    assert bool((err <= 5e-3 + 3e-5 * pa.abs()).all()), float(err.max())
    assert torch.equal(m, pm)
    (p64,), _, _ = resample._gather_plain([img.double()], None, u.double(),
                                          v.double())
    assert _rms(out, p64, inb) < _rms(pa, p64, inb)
