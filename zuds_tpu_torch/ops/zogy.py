"""ZOGY proper image subtraction in Fourier space (twin of
``zuds_tpu/ops/zogy.py``): the proper difference D, its PSF P_D and the
matched-filter score S_corr of Zackay, Ofek & Gal-Yam (2016), and the PSF
as a clipped mean of recentred star cutouts.

The seven FFTs are ``torch.fft`` (cuFFT on the card, fp32), as the
reference leaves them to XLA. Everything between them is a hand kernel on
a CUDA tensor (``kernels/zogy.cu``): H15 the spectral pass
(:func:`spectral_pass`), H16 the score normalisation
(:func:`score_normalize`), H17 the star stamps (:func:`psf_stamps`) and
H18 their clipped mean (:func:`psf_clip`). On a CPU tensor each runs its
plain version, the reference's formulas step by step in its f32
roundings: ``|P|^2`` XLA's complex abs squared, complex products and quotients
written out on the real and imaginary planes, every scalar formed in the
frame's precision (the jitted reference receives its Python floats as f32
values), ``jnp.fft.fftfreq``'s quotients and ``jnp.median``'s midpoint.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import launch
from .cutouts import clamped_corners
from .photometry import cutouts

__all__ = ['zogy_subtract', 'zogy_subtract_plain', 'estimate_psf_from_stars',
           'estimate_psf_plain', 'zogy_scalars', 'spectral_pass',
           'spectral_pass_plain', 'score_normalize', 'score_normalize_plain',
           'psf_stamps', 'psf_stamps_plain', 'psf_clip', 'psf_clip_plain']


def _np_dtype(dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype.type


def zogy_scalars(sigma_new, sigma_ref, f_new=1.0, f_ref=1.0,
                 dtype=torch.float32):
    """The scalars of the spectral pass as Python floats holding values of
    ``dtype`` (zogy.py:56-58, :66): ``c_r = sn^2 fr^2`` and ``c_n = sr^2
    fn^2`` (the weights of ``|P_r|^2`` and ``|P_n|^2``), ``f_ref``,
    ``f_new``, ``f_rn = f_ref f_new`` and ``f_d = f_new f_ref / sqrt(c_r +
    c_n)``, each rounded to ``dtype`` as it is formed."""
    t = _np_dtype(dtype)
    sn, sr, fn, fr = (t(float(v)) for v in (sigma_new, sigma_ref, f_new,
                                            f_ref))
    c_r = (sn * sn) * (fr * fr)
    c_n = (sr * sr) * (fn * fn)
    f_d = fn * fr / np.sqrt(c_r + c_n)
    return {k: float(v) for k, v in (('c_r', c_r), ('c_n', c_n),
                                     ('f_ref', fr), ('f_new', fn),
                                     ('f_rn', fr * fn), ('f_d', f_d))}


def _psf_to_otf(psf, shape):
    """Centre a (k, k) PSF into an (H, W) frame at the origin and rfft2 it
    (zogy.py:23-31)."""
    k = psf.shape[0]
    padded = torch.zeros(shape, dtype=psf.dtype, device=psf.device)
    padded[:psf.shape[0], :psf.shape[1]] = psf
    padded = torch.roll(padded, (-(k // 2), -(k // 2)), dims=(0, 1))
    return torch.fft.rfft2(padded)


def _cabs(re, im):
    """``jnp.abs`` of a complex number as XLA computes it: ``max * sqrt(1 +
    (min / max)^2)`` of ``|re|`` and ``|im|`` with the square and the add
    one FMA (held exact here by forming them in double), and ``max`` itself
    where that is 0 or infinite. ``torch.hypot`` rounds otherwise on ~1 in
    10 values. The root is taken in double and rounded once: the CPU
    build's f32 ``sqrt`` is an ulp off at times."""
    a, b = re.abs(), im.abs()
    mx, mn = torch.maximum(a, b), torch.minimum(a, b)
    r = (mn / mx).double()
    one = (r * r + 1).to(re.dtype)
    h = mx * torch.sqrt(one.double()).to(re.dtype)
    return torch.where((mx == 0) | torch.isinf(mx), mx, h)


def _mul(ar, ai, br, bi):
    """(a)(b) on real and imaginary planes, each product and sum rounded."""
    return ar * br - ai * bi, ar * bi + ai * br


def spectral_pass_plain(N, R, Pn, Pr, c_r, c_n, f_ref, f_new, f_rn, f_d):
    """Plain version of H15 (zogy.py:61-67, :71) on the half spectra ``N``,
    ``R`` of new and ref and the OTFs ``Pn``, ``Pr``: ``denom = c_r |Pr|^2
    + c_n |Pn|^2`` (``|P|`` XLA's complex abs, squared) clamped at ``1e-12
    max(denom)``, ``sq = sqrt(denom)``;
    returns (``D_hat = (f_ref Pr N - f_new Pn R) / sq``, ``P_d_hat = f_rn Pr
    Pn / (f_d sq)``, ``S_hat = f_d D_hat conj(P_d_hat)``)."""
    apr = _cabs(Pr.real, Pr.imag)
    apn = _cabs(Pn.real, Pn.imag)
    denom = c_r * (apr * apr) + c_n * (apn * apn)
    denom = torch.maximum(denom, 1e-12 * denom.max())
    sq = torch.sqrt(denom)
    t1 = _mul(f_ref * Pr.real, f_ref * Pr.imag, N.real, N.imag)
    t2 = _mul(f_new * Pn.real, f_new * Pn.imag, R.real, R.imag)
    dr, di = (t1[0] - t2[0]) / sq, (t1[1] - t2[1]) / sq
    u = _mul(f_rn * Pr.real, f_rn * Pr.imag, Pn.real, Pn.imag)
    fsq = f_d * sq
    qr, qi = u[0] / fsq, u[1] / fsq
    gr, gi = f_d * dr, f_d * di
    return (torch.complex(dr, di), torch.complex(qr, qi),
            torch.complex(gr * qr + gi * qi, gi * qr - gr * qi))


def spectral_pass(N, R, Pn, Pr, c_r, c_n, f_ref, f_new, f_rn, f_d):
    """The spectral pass of :func:`spectral_pass_plain`: H15 on CUDA
    tensors (complex64, one dense layout), the plain version on CPU
    tensors."""
    if N.is_cuda:
        return launch.zogy_spectral(N, R, Pn, Pr, c_r, c_n, f_ref, f_new,
                                    f_rn, f_d)
    return spectral_pass_plain(N, R, Pn, Pr, c_r, c_n, f_ref, f_new, f_rn,
                               f_d)


def score_normalize_plain(p_d, s, f_d):
    """Plain version of H16 (zogy.py:75-76): ``s / (f_d sqrt(max(sum p_d^2,
    1e-20)))``. The rounded squares are summed in double and the sum
    rounded once, as H16 sums them (the reference's f32 sum is ~1e-7
    relative from either)."""
    total = (p_d * p_d).double().sum().to(p_d.dtype)
    return s / (f_d * torch.sqrt(torch.clamp(total, min=1e-20)))


def score_normalize(p_d, s, f_d):
    """The score of :func:`score_normalize_plain`: H16 on CUDA tensors (the
    sum stays on the card), the plain version on CPU tensors."""
    if p_d.is_cuda:
        return launch.zogy_normalize(p_d, s, f_d)
    return score_normalize_plain(p_d, s, f_d)


def _zogy(new, ref, psf_new, psf_ref, sigma_new, sigma_ref, f_new, f_ref,
          spectral, normalize):
    H, W = new.shape
    # the four spectra share rfft2's layout (transposed on the card); H15's
    # outputs and the plain passes' products keep it, so both paths reach
    # the inverse transforms in one layout and round alike there
    N, R, Pn, Pr = (torch.fft.rfft2(new), torch.fft.rfft2(ref),
                    _psf_to_otf(psf_new.to(new.dtype), (H, W)),
                    _psf_to_otf(psf_ref.to(new.dtype), (H, W)))
    sc = zogy_scalars(sigma_new, sigma_ref, f_new, f_ref, new.dtype)
    D_hat, P_d_hat, S_hat = spectral(N, R, Pn, Pr, **sc)
    d = torch.fft.irfft2(D_hat, s=(H, W))
    s = torch.fft.irfft2(S_hat, s=(H, W))
    p_d = torch.fft.irfft2(P_d_hat, s=(H, W))
    return {'d': d, 'psf_d': p_d, 's_corr': normalize(p_d, s, sc['f_d']),
            'f_d': torch.tensor(sc['f_d'], dtype=new.dtype,
                                device=new.device)}


def zogy_subtract(new, ref, psf_new, psf_ref, sigma_new, sigma_ref,
                  f_new=1.0, f_ref=1.0):
    """Proper image subtraction of two aligned, background-subtracted
    frames (zogy.py:35-78).

    new, ref: (H, W) frames; psf_new, psf_ref: (k, k) unit-sum PSFs, all
    on one device; sigma_new, sigma_ref: the background noise sigmas and
    f_new, f_ref the flux scales, host numbers. Returns dict ``d`` (the
    proper difference), ``psf_d`` (its (H, W) PSF at the origin),
    ``s_corr`` (the score in units of sigma) and ``f_d`` (0-d). On the card
    the FFTs are cuFFT and the passes between them H15 and H16; on the CPU
    the plain passes."""
    return _zogy(new, ref, psf_new, psf_ref, sigma_new, sigma_ref, f_new,
                 f_ref, spectral_pass, score_normalize)


def zogy_subtract_plain(new, ref, psf_new, psf_ref, sigma_new, sigma_ref,
                        f_new=1.0, f_ref=1.0):
    """:func:`zogy_subtract` through the plain passes, in ``new``'s dtype
    (float64 frames give the float64 reference the tests hold ``d``
    against)."""
    return _zogy(new, ref, psf_new, psf_ref, sigma_new, sigma_ref, f_new,
                 f_ref, spectral_pass_plain, score_normalize_plain)


def _fftfreq(n, dtype, device):
    """``jnp.fft.fftfreq(n)``: the signed integer frequencies divided by
    ``n`` (``torch.fft.fftfreq`` multiplies by ``1 / n``, an ulp away at
    some entries)."""
    i = torch.arange(n, device=device)
    return ((i + n // 2) % n - n // 2).to(dtype) / n


def _median_rows(x):
    """``jnp.median(x, axis=1)``: the midpoint of the two middle values of
    each sorted row, NaN for a row holding a NaN (``torch.median`` returns
    the lower middle value)."""
    s = torch.sort(x, dim=1).values
    n = x.shape[1]
    mid = (s[:, (n - 1) // 2] + s[:, n // 2]) * 0.5
    return torch.where(x.isnan().any(1), torch.nan, mid)


def psf_stamps_plain(img, xs, ys, valid, size=25):
    """Plain version of H17 (zogy.py:89-114): the (S, size, size) cutouts
    at the clamped corners of the positions ``xs``, ``ys`` (rounded half to
    even), each shifted by its sub-pixel offset through a Fourier phase
    ramp (``fft2``, ``exp(2j pi (fy dy + fx dx))``, ``ifft2``, real part),
    less the median of its border, divided by its sum where that is
    positive; and ``good0 = valid & (sum > 0)``. The transforms run in
    double and round once (an f32 transform of a cut on a sky pedestal
    carries the pedestal's rounding into every mode); the ramp's argument,
    cosine and sine are the reference's, in ``img``'s precision."""
    H, W = img.shape
    half = size // 2
    x0, y0 = clamped_corners(xs, ys, size, H, W)
    c = cutouts(img[None], x0.long(), y0.long(), size)[0]
    dx = xs - (x0 + half).to(xs.dtype)
    dy = ys - (y0 + half).to(ys.dtype)
    F = torch.fft.fft2(c.double())
    f = _fftfreq(size, img.dtype, img.device)
    arg = f[None, :, None] * dy[:, None, None] + f[None, None, :] \
        * dx[:, None, None]
    theta = float(_np_dtype(img.dtype)(2 * np.pi)) * arg
    Fr, Fi = _mul(F.real, F.imag, torch.cos(theta).double(),
                  torch.sin(theta).double())
    st = torch.fft.ifft2(torch.complex(Fr, Fi)).real.to(img.dtype)
    border = torch.cat([st[:, 0, :], st[:, -1, :], st[:, :, 0],
                        st[:, :, -1]], 1)
    st = st - _median_rows(border)[:, None, None]
    total = st.sum((1, 2))
    good0 = valid & (total > 0)
    st = st / torch.where(total > 0, total, torch.ones_like(total))[
        :, None, None]
    return st, good0


def psf_stamps(img, xs, ys, valid, size=25):
    """The stamps of :func:`psf_stamps_plain`: H17 on CUDA tensors, the
    plain version on CPU tensors."""
    if img.is_cuda:
        return launch.psf_stamps(img.contiguous(), xs.contiguous(),
                                 ys.contiguous(), valid.contiguous(), size)
    return psf_stamps_plain(img, xs, ys, valid, size)


def psf_clip_plain(stamps, good0, iters=2):
    """Plain version of H18 (zogy.py:116-132): ``iters`` passes of the 5
    sigma clip (the mean and variance of the good stamps per pixel, a
    stamp kept while its largest deviation stays under 5 sigma), then the
    mean of the kept stamps clamped at 0 and renormalised to unit sum.
    Returns (psf (size, size), good (S,))."""
    good = good0
    for _ in range(iters):
        g = good[:, None, None].to(stamps.dtype)
        n = torch.clamp(g.sum(), min=1.0)
        mean = (stamps * g).sum(0) / n
        dev = stamps - mean
        var = (dev * dev * g).sum(0) / n
        sig = torch.sqrt(torch.clamp(var, min=1e-20))
        good = good0 & ((dev.abs() / (sig + 1e-12)).amax((1, 2)) < 5.0)
    g = good[:, None, None].to(stamps.dtype)
    psf = (stamps * g).sum(0) / torch.clamp(g.sum(), min=1.0)
    psf = torch.clamp(psf, min=0.0)
    return psf / torch.clamp(psf.sum(), min=1e-20), good


def psf_clip(stamps, good0, iters=2):
    """The clipped mean of :func:`psf_clip_plain`: H18 on CUDA tensors,
    the plain version on CPU tensors."""
    if stamps.is_cuda:
        return launch.psf_clip(stamps.contiguous(), good0.contiguous(),
                               iters)
    return psf_clip_plain(stamps, good0, iters)


def estimate_psf_from_stars(img, xs, ys, valid, size=25, iters=2):
    """Unit-sum (size, size) PSF from the star cutouts at ``xs``, ``ys``
    (0-based, f32 (S,); ``valid`` (S,) bool marks the rows that are not
    padding) (zogy.py:82-132): H17 and H18 on the card, the plain versions
    on the CPU."""
    stamps, good0 = psf_stamps(img, xs, ys, valid, size)
    return psf_clip(stamps, good0, iters)[0]


def estimate_psf_plain(img, xs, ys, valid, size=25, iters=2):
    """:func:`estimate_psf_from_stars` through the plain versions."""
    stamps, good0 = psf_stamps_plain(img, xs, ys, valid, size)
    return psf_clip_plain(stamps, good0, iters)[0]
