"""Alard-Lupton PSF-matching fit and model (twin of
``zuds_tpu/ops/subtract.py``).

The fit's products and solves are plain fp32 PyTorch (TF32 is off, see the
package ``__init__``), as the reference leaves them to XLA. The model
convolution runs in hand kernel H3 (``kernels/apply.cu``) on a CUDA tensor
(:func:`apply_kernel_fast`) and as the grouped separable convolution of
the reference's :func:`apply_kernel` on a CPU tensor.

The per-pair difference (:func:`subtract_frames`) adds the noise map: the
reference variance convolved with the squared centre kernel of each static
region (:func:`propagate_ref_var`: H3 launched with one term on a CUDA
tensor, :func:`propagate_ref_var_plain` on a CPU tensor), then the
difference, the square root and the no-data fills in one pass
(:func:`subtract_epilogue`: hand kernel H11, ``kernels/subtract.cu``, or
:func:`subtract_epilogue_plain`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import (BIG_RMS, KERNEL_GAUSS_DEGREES, KERNEL_GAUSS_SIGMAS,
                         KERNEL_SPATIAL_ORDER, MASK_BIT_NODATA_SUB, NREG_SIDE,
                         SUB_NODATA_SENTINEL)
from ..kernels import launch
from .background import masked_median

__all__ = ['KernelBasis', 'spatial_terms', 'dense_basis', 'region_outer', 'fit_kernel',
           'apply_kernel', 'apply_kernel_fast', 'model_kernels',
           'model_geometry', 'center_kernels', 'region_edges',
           'propagate_ref_var', 'propagate_ref_var_plain',
           'subtract_epilogue', 'subtract_epilogue_plain', 'subtract_frames']

# order-weighted Jacobi ridge of the fit (subtract.py:260-293 defaults)
RIDGE_BASE = 1e-5
RIDGE_GROWTH = 4.0


class KernelBasis:
    """Separable Gaussian x polynomial kernel basis (twin of
    ``zuds_tpu/ops/subtract.py:58-100``): float64 construction, float32
    tables ``gx``/``gy`` (Nb, K), ``sums`` (Nb,) and ``b0_2d`` (K, K).
    """

    def __init__(self, ksize, seeing_sigma=2.0,
                 sigmas=KERNEL_GAUSS_SIGMAS, degrees=KERNEL_GAUSS_DEGREES):
        if ksize % 2 != 1:
            raise ValueError(f'ksize must be odd, got {ksize}')
        self.ksize = ksize
        r = ksize // 2
        u = np.arange(-r, r + 1, dtype=np.float64)
        gx_list, gy_list, meta = [], [], []
        for sig_f, deg in zip(sigmas, degrees):
            sig = max(sig_f * seeing_sigma, 0.5)
            g = np.exp(-u * u / (2 * sig * sig))
            for p in range(deg + 1):
                for q in range(deg + 1 - p):
                    gx_list.append(g * (u / sig) ** p)
                    gy_list.append(g * (u / sig) ** q)
                    meta.append((sig, p, q))
        gx = np.stack(gx_list)
        gy = np.stack(gy_list)
        b0 = np.outer(gy[0], gx[0])
        self.b0_2d = (b0 / b0.sum()).astype(np.float32)
        sums = np.einsum('nk,nl->n', gy, gx)
        self.gx = gx.astype(np.float32)
        self.gy = gy.astype(np.float32)
        self.sums = sums.astype(np.float32)
        self.nbasis = gx.shape[0]
        self.meta = meta


def spatial_terms(order):
    """(p, q) exponents of a 2-D polynomial of total order ``order``."""
    return [(p, q) for o in range(order + 1) for p in range(o + 1)
            for q in [o - p]]


def region_edges(n, nreg):
    """Static region edges ceil(i * n / nreg), closed by n."""
    return [int(math.ceil(i * n / nreg)) for i in range(nreg)] + [n]


def dense_basis(basis_gx, basis_gy, basis_sums, b0_2d):
    """(Nb, K, K) sum-normalised dense basis: B_0 = b0_2d, and
    B_n = gy_n (x) gx_n - sums_n * b0_2d for n > 0."""
    raw = basis_gy[:, :, None] * basis_gx[:, None, :]
    return torch.cat([b0_2d[None],
                      raw[1:] - basis_sums[1:, None, None] * b0_2d[None]])


def _terms(xn, yn, terms):
    return [(xn ** p) * (yn ** q) for p, q in terms]


def region_outer(rw, A, B):
    """``einsum('sr,sa,sb->rab', rw, A, B)`` as one matmul per region.

    torch.einsum contracts three operands left to right (no opt_einsum),
    which for the fit's Gram blocks would first build an (S, a, b)
    intermediate (~830 MB at smax=384, a = 49*49, b = 15*15); weighting A
    per region and multiplying keeps every intermediate (R2, S, a)."""
    return torch.matmul((rw.t()[:, :, None] * A[None]).transpose(1, 2), B)


def fit_kernel(ref, sci, ivar, xs, ys, svalid, basis_gx, basis_gy,
               basis_sums, b0_2d, stamp=31, order=KERNEL_SPATIAL_ORDER,
               nreg=NREG_SIDE):
    """Fit the spatially varying PSF-matching kernel from star stamps
    (subtract.py:130). Returns ``coeffs`` (R2, Nb*Nm+1), ``stamp_ok``,
    ``stamp_chi2``, ``nb`` and ``nm``."""
    H, W = ref.shape
    Nb, K = basis_gx.shape
    dev = ref.device
    P = stamp
    Pi = P - K + 1
    terms = spatial_terms(order)
    Nm = len(terms)
    D = Nb * Nm + 1
    R2 = nreg * nreg
    S = xs.shape[0]

    x0 = torch.clamp(torch.round(xs).to(torch.int64) - P // 2, 0, W - P)
    y0 = torch.clamp(torch.round(ys).to(torch.int64) - P // 2, 0, H - P)
    ar = torch.arange(P, device=dev)
    iy = (y0[:, None] + ar)[:, :, None]
    ix = (x0[:, None] + ar)[:, None, :]
    R_s, S_s, W_s = ref[iy, ix], sci[iy, ix], ivar[iy, ix]    # (S, P, P)

    # basis-convolved reference stamps (S, Nb, Pi, Pi): a 'valid'
    # correlation, as the reference's im2col einsum computes it
    dense = dense_basis(basis_gx, basis_gy, basis_sums, b0_2d)
    C = F.conv2d(R_s[:, None], dense[:, None])
    off = K // 2
    y = S_s[:, off:off + Pi, off:off + Pi]
    w = W_s[:, off:off + Pi, off:off + Pi]

    rx = torch.clamp((xs * nreg / W).to(torch.int64), 0, nreg - 1)
    ry = torch.clamp((ys * nreg / H).to(torch.int64), 0, nreg - 1)
    rid = ry * nreg + rx
    rhot = F.one_hot(rid, R2).to(torch.float32)                  # (S, R2)
    cx = (rx.to(torch.float32) + 0.5) * W / nreg
    cy = (ry.to(torch.float32) + 0.5) * H / nreg
    xn = (xs - cx) / (W / (2.0 * nreg))
    yn = (ys - cy) / (H / (2.0 * nreg))
    T = torch.stack(_terms(xn, yn, terms), dim=1)               # (S, Nm)

    Cf = C.reshape(S, Nb, Pi * Pi)
    yf = y.reshape(S, Pi * Pi)
    wf = w.reshape(S, Pi * Pi)

    # stamp Gram blocks: independent of the rejection state (hoisted)
    CtC0 = torch.bmm(Cf * wf[:, None], Cf.transpose(1, 2))      # (S,Nb,Nb)
    Cw0 = (Cf * wf[:, None]).sum(-1)                             # (S, Nb)
    wsum0 = wf.sum(1)
    TT = (T[:, :, None] * T[:, None, :]).reshape(S, Nm * Nm)

    def normal_eq(stamp_ok):
        okf = (stamp_ok & svalid).to(torch.float32)
        sw = wf * okf[:, None]
        rhow = rhot * okf[:, None]
        G_bb = region_outer(rhow, CtC0.reshape(S, Nb * Nb), TT)
        G_bb = G_bb.reshape(R2, Nb, Nb, Nm, Nm).permute(0, 1, 3, 2, 4)
        G_bb = G_bb.reshape(R2, Nb * Nm, Nb * Nm)
        G_bg = region_outer(rhow, Cw0, T).reshape(R2, Nb * Nm)
        wsum = rhow.t() @ wsum0
        G = torch.zeros((R2, D, D), device=dev)
        G[:, :Nb * Nm, :Nb * Nm] = G_bb
        G[:, :Nb * Nm, -1] = G_bg
        G[:, -1, :Nb * Nm] = G_bg
        G[:, -1, -1] = wsum
        return G, sw

    def rhs(yvec, sw):
        swy = sw * yvec
        Cy = (Cf * swy[:, None]).sum(-1)                         # (S, Nb)
        h_b = region_outer(rhot, Cy, T).reshape(R2, Nb * Nm)
        h_g = rhot.t() @ swy.sum(1)
        return torch.cat([h_b, h_g[:, None]], dim=1)

    def model_stamps(coeffs):
        a = coeffs[:, :Nb * Nm].reshape(R2, Nb * Nm)
        a_s = (rhot @ a).reshape(S, Nb, Nm)
        bg_s = rhot @ coeffs[:, -1]
        wmap = (a_s * T[:, None, :]).sum(-1)                     # (S, Nb)
        return torch.bmm(wmap[:, None, :], Cf)[:, 0] + bg_s[:, None]

    t_ord = np.asarray([p + q for p, q in terms], np.float32)
    lam_nm = np.repeat((RIDGE_BASE * RIDGE_GROWTH ** t_ord)[None, :], Nb,
                       0).ravel()
    lam_col = torch.as_tensor(
        np.concatenate([lam_nm, [RIDGE_BASE]]).astype(np.float32),
        device=dev)

    def solve_factory(G):
        d = torch.diagonal(G, dim1=1, dim2=2)
        sc = 1.0 / torch.sqrt(torch.clamp(d, min=1e-20))
        Gr = G * sc[:, :, None] * sc[:, None, :] + torch.diag(lam_col)[None]

        # one factorisation per region, reused by the three solves of a
        # pass; per region because the CPU build's batched LU hangs (MKL
        # SLASWP errors) above ~400 unknowns with several threads
        lus = [torch.linalg.lu_factor(Gr[r]) for r in range(R2)]

        def solve(h):
            hs = h * sc
            return torch.stack([
                torch.linalg.lu_solve(*lu, hs[r][:, None])[:, 0]
                for r, lu in enumerate(lus)]) * sc
        return solve

    def stamp_chi2(coeffs):
        resid2 = (model_stamps(coeffs) - yf) ** 2 * wf
        npix = torch.clamp((wf > 0).sum(1), min=1)
        return resid2.sum(1) / npix

    def region_chi2(c, sw):
        return ((model_stamps(c) - yf) ** 2 * sw).sum(1) @ rhot

    ok = torch.ones(S, dtype=torch.bool, device=dev)
    coeffs = None
    for _ in range(3):                 # 2 rejection passes + final fit
        G, sw = normal_eq(ok)
        solve = solve_factory(G)
        coeffs = solve(rhs(yf, sw))
        for _r in range(2):            # data-space refinement (:325-342)
            cand = coeffs + solve(rhs(yf - model_stamps(coeffs), sw))
            better = region_chi2(cand, sw) <= region_chi2(coeffs, sw)
            coeffs = torch.where(better[:, None], cand, coeffs)
        chi2 = stamp_chi2(coeffs)
        live = ok & svalid
        new_ok = torch.zeros_like(ok)
        for r in range(R2):
            inr = live & (rid == r)
            med = _nanmedian_or_one(chi2, inr)
            mad = _nanmedian_or_one((chi2 - med).abs(), inr)
            keep = chi2 <= med + 3.0 * 1.4826 * torch.clamp(mad, min=1e-12)
            new_ok = new_ok | ((rid == r) & keep)
        ok = new_ok

    return {'coeffs': coeffs, 'stamp_ok': ok & svalid,
            'stamp_chi2': stamp_chi2(coeffs), 'nb': Nb, 'nm': Nm}


def _nanmedian_or_one(x, sel):
    """``nan_to_num(jnp.nanmedian(where(sel, x, nan)), nan=1)``: an even
    count averages the two middle values (``torch.nanmedian`` would take
    the lower one)."""
    med = masked_median(x, sel, dim=0)
    return torch.where(sel.any(), med, torch.ones_like(med))


def apply_kernel(ref, coeffs, basis_gx, basis_gy, basis_sums, b0_2d,
                 order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """Plain version of the model convolution (subtract.py:557): the raw
    separable basis convolved with ``ref`` (zero padding), combined per
    static region with the fitted coefficients, blended with the region's
    spatial polynomial, plus the background term."""
    H, W = ref.shape
    Nb, K = basis_gx.shape
    terms = spatial_terms(order)
    Nm = len(terms)
    R2 = nreg * nreg
    a = coeffs[:, :Nb * Nm].reshape(R2, Nb, Nm)
    bg = coeffs[:, -1]
    # fold the sum-normalisation into coefficient space (:589-596)
    s0 = basis_gy[0].sum() * basis_gx[0].sum()
    a0 = (a[:, 0, :] - torch.einsum('rnm,n->rm', a[:, 1:, :],
                                    basis_sums[1:])) / s0
    a_t = torch.cat([a0[:, None, :], a[:, 1:, :]], dim=1)

    t = F.conv2d(ref[None, None], basis_gy[:, None, :, None],
                 padding=(K // 2, 0))
    t = F.conv2d(t, basis_gx[:, None, None, :], padding=(0, K // 2),
                 groups=Nb)[0]                                  # (Nb, H, W)
    y_e, x_e = region_edges(H, nreg), region_edges(W, nreg)
    yy = torch.arange(H, dtype=torch.float32, device=ref.device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=ref.device)[None, :]
    wx, wy = W / (2.0 * nreg), H / (2.0 * nreg)
    rows = []
    for ri in range(nreg):
        row = []
        for rj in range(nreg):
            r = ri * nreg + rj
            E = torch.einsum('nhw,nm->mhw',
                             t[:, y_e[ri]:y_e[ri + 1], x_e[rj]:x_e[rj + 1]],
                             a_t[r])
            xn = (xx[:, x_e[rj]:x_e[rj + 1]] - (rj + 0.5) * W / nreg) / wx
            yn = (yy[y_e[ri]:y_e[ri + 1]] - (ri + 0.5) * H / nreg) / wy
            m_r = torch.zeros_like(E[0]) + bg[r]
            for m, tm in enumerate(_terms(xn, yn, terms)):
                m_r = m_r + tm * E[m]
            row.append(m_r)
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows, dim=0)


def model_kernels(coeffs, basis_gx, basis_gy, basis_sums, b0_2d,
                  order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """(R2, Nm, K, K) dense kernel of each region and spatial term,
    ``einsum('rnm,nkl->rmkl', a, dense basis)`` (subtract.py:450)."""
    Nb = basis_gx.shape[0]
    Nm = len(spatial_terms(order))
    a = coeffs[:, :Nb * Nm].reshape(nreg * nreg, Nb, Nm)
    dense = dense_basis(basis_gx, basis_gy, basis_sums, b0_2d)
    return torch.einsum('rnm,nkl->rmkl', a, dense).contiguous()


def model_geometry(H, W, order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """Host values of the model's blend, as :func:`launch.apply_model`
    takes them: the region centre of each region column and row, the term
    exponents and the half-widths (the wrapper rounds them to f32 as the
    reference's python-scalar arithmetic is, apply_kernel :640-643)."""
    terms = spatial_terms(order)
    return ([(rj + 0.5) * W / nreg for rj in range(nreg)],
            [(ri + 0.5) * H / nreg for ri in range(nreg)],
            [p for p, _ in terms], [q for _, q in terms],
            W / (2.0 * nreg), H / (2.0 * nreg))


def apply_kernel_fast(ref, coeffs, basis_gx, basis_gy, basis_sums, b0_2d,
                      order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """The model frame (subtract.py:380). A CUDA tensor runs hand kernel
    H3 on the per-(region, term) dense kernels, with no copy from the host;
    a CPU tensor runs :func:`apply_kernel`."""
    if not ref.is_cuda:
        return apply_kernel(ref, coeffs, basis_gx, basis_gy, basis_sums,
                            b0_2d, order=order, nreg=nreg)
    kd = model_kernels(coeffs, basis_gx, basis_gy, basis_sums, b0_2d,
                       order=order, nreg=nreg)
    return launch.apply_model(ref.contiguous(), kd,
                              coeffs[:, -1].contiguous(),
                              *model_geometry(*ref.shape, order=order,
                                              nreg=nreg))


def center_kernels(coeffs, basis_gx, basis_gy, basis_sums, b0_2d,
                   order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """(R2, K, K) kernel at each region centre, where only the (0, 0)
    spatial term contributes (subtract.py:673)."""
    Nb, K = basis_gx.shape
    Nm = len(spatial_terms(order))
    a0 = coeffs[:, :Nb * Nm].reshape(-1, Nb, Nm)[:, :, 0]
    dense = dense_basis(basis_gx, basis_gy, basis_sums, b0_2d)
    return (a0 @ dense.reshape(Nb, K * K)).reshape(-1, K, K)


def propagate_ref_var_plain(ref_rms, kerns):
    """Plain version of the variance propagation (subtract.py:707-725): one
    'valid' correlation per static region rectangle of the zero-padded
    ``ref_rms ** 2`` with ``kerns[r] ** 2`` ((R2, K, K), R2 a square)."""
    H, W = ref_rms.shape
    R2, K, _ = kerns.shape
    nreg = math.isqrt(R2)
    r = K // 2
    varp = F.pad(ref_rms ** 2, (r, r, r, r))
    y_e, x_e = region_edges(H, nreg), region_edges(W, nreg)
    rows = []
    for ri in range(nreg):
        y0, y1 = y_e[ri], y_e[ri + 1]
        row = []
        for rj in range(nreg):
            x0, x1 = x_e[rj], x_e[rj + 1]
            k2 = (kerns[ri * nreg + rj] ** 2)[None, None]
            sl = varp[y0:y1 + 2 * r, x0:x1 + 2 * r][None, None]
            row.append(F.conv2d(sl, k2)[0, 0])
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows, dim=0)


def propagate_ref_var(ref_rms, coeffs, basis_gx, basis_gy, basis_sums,
                      b0_2d, order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """conv(var_ref, K_r^2) with K evaluated at each region centre
    (subtract.py:692). A CUDA tensor runs hand kernel H3 with one constant
    term whose kernel is the squared centre kernel (the same zero-padded
    correlation over the same region rectangles as the model, in H3's
    direct fp32 form for one term); a CPU tensor runs
    :func:`propagate_ref_var_plain`."""
    kerns = center_kernels(coeffs, basis_gx, basis_gy, basis_sums, b0_2d,
                           order=order, nreg=nreg)
    if not ref_rms.is_cuda:
        return propagate_ref_var_plain(ref_rms, kerns)
    cx, cy, _, _, wx, wy = model_geometry(*ref_rms.shape, order=0, nreg=nreg)
    return launch.apply_model_variance((ref_rms ** 2).contiguous(),
                                       (kerns ** 2).contiguous(), cx, cy,
                                       wx, wy)


def _propagate_ref_var(ref_rms, fit, basis, order, nreg, shape):
    """:func:`propagate_ref_var` for a basis object (subtract.py:728)."""
    def dev(a):
        return torch.as_tensor(a, device=ref_rms.device)
    return propagate_ref_var(ref_rms, fit['coeffs'], dev(basis.gx),
                             dev(basis.gy), dev(basis.sums),
                             dev(basis.b0_2d), order=order, nreg=nreg)


def subtract_epilogue_plain(sci, model, sci_rms, ref_var, bad, submask=None,
                            contract=False):
    """Plain version of H11: ``diff = sci - model`` and ``rms =
    sqrt(sci_rms^2 + ref_var)``, the sentinel and ``BIG_RMS`` where ``bad``,
    and with ``submask`` the no-data bit 17 where ``diff`` is the sentinel
    (subtract.py:663-670, pipeline.py:264-269). ``contract``: the square
    and the add as one FMA, as XLA:CPU contracts them in a jitted
    program."""
    if contract:
        from .ordered import fma
        var = fma(sci_rms, sci_rms, ref_var)
    else:
        var = sci_rms ** 2 + ref_var
    rms = torch.where(bad, BIG_RMS, torch.sqrt(var))
    diff = torch.where(bad, SUB_NODATA_SENTINEL, sci - model)
    if submask is None:
        return diff, rms
    return diff, rms, submask | torch.where(
        diff == SUB_NODATA_SENTINEL, 1 << MASK_BIT_NODATA_SUB,
        0).to(torch.int32)


def subtract_epilogue(sci, model, sci_rms, ref_var, bad, submask=None,
                      contract=False):
    """The difference, its noise map and the no-data fills in one pass:
    (diff, rms), or (diff, rms, submask) with a ``submask``. A CUDA tensor
    runs hand kernel H11; a CPU tensor :func:`subtract_epilogue_plain`."""
    if not sci.is_cuda:
        return subtract_epilogue_plain(sci, model, sci_rms, ref_var, bad,
                                       submask, contract)
    return launch.subtract_epilogue(
        sci.contiguous(), model.contiguous(), sci_rms.contiguous(),
        ref_var.contiguous(), bad.contiguous(), SUB_NODATA_SENTINEL, BIG_RMS,
        submask=None if submask is None else submask.contiguous(),
        bit=MASK_BIT_NODATA_SUB, contract=contract)


def subtract_frames(sci, ref_aligned, sci_rms, ref_rms, badmask, fit,
                    basis, order=KERNEL_SPATIAL_ORDER, nreg=NREG_SIDE):
    """Full difference (subtract.py:652): D = sci - (K*ref + bg), the noise
    map, the no-data sentinel. ``fit`` is the output of :func:`fit_kernel`,
    ``basis`` a :class:`KernelBasis`. Bad pixels (``badmask`` True) hold
    ``SUB_NODATA_SENTINEL`` in ``diff`` and ``BIG_RMS`` in ``rms``. On a
    CUDA tensor the model and the variance are two launches of H3 and the
    rest one launch of H11."""
    def dev(a):
        return torch.as_tensor(a, device=sci.device)
    tables = (dev(basis.gx), dev(basis.gy), dev(basis.sums),
              dev(basis.b0_2d))
    model = apply_kernel_fast(ref_aligned, fit['coeffs'], *tables,
                              order=order, nreg=nreg)
    ref_var = propagate_ref_var(ref_rms, fit['coeffs'], *tables, order=order,
                                nreg=nreg)
    return subtract_epilogue(sci, model, sci_rms, ref_var, badmask)
