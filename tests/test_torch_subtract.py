"""PyTorch port vs the JAX reference: A&L kernel fit, the model
convolution (H3's plain version) and the region-centre kernels, on the CPU.

Tolerances:
* apply: the same JAX-fitted coefficients on both sides, order 4 over 3x3
  regions, H and W multiples of 8 so the reference takes its s2d path;
  rtol 1e-4, atol 1e-3 (tests/test_subtract.py's contract). The same
  tolerance at K = 17 (order 4, 3x3) and K = 21 (order 5, 2x2) with
  seeded coefficients.
* fit: order 2 over 2x2 regions. ``stamp_ok`` equal; each region's centre
  kernel sum within 1 mmag (relative 9.2e-4). The fitted model frames: the
  reference solves f32 normal equations whose condition number the ridge
  caps near 1e5, so its own model moves by more than 0.01 rms at star
  cores when its input moves by one ulp. The port is held to that: its
  distance from the reference, at each of the median, 90th and 99th
  percentiles and the maximum, at most twice the reference's own distance
  under a 1e-7 relative perturbation of ``ivar``, and a median below
  0.01 x the median rms.
"""
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu.ops import subtract as js
from zuds_tpu_torch import inputs
from zuds_tpu_torch.ops import subtract as ts

torch.set_num_threads(2)

RMS = 5.0 * np.sqrt(2.0)      # sci and ref noise, 5 counts each


def T(a):
    return torch.as_tensor(np.array(a))


def _scene(H, W, smax, seed):
    cfg = SimpleNamespace(smax=smax, map_step=32, ksize=9)
    a = inputs.synth_inputs(1, H, W, cfg, seed=seed)
    sci, _, ref, _, _, _, sx, sy, sv, gx, gy, sums, b0, _ = (x[0] for x in a)
    ivar = np.full((H, W), 1.0 / RMS ** 2, 'f4')
    return dict(ref=ref, sci=sci, ivar=ivar, sx=sx, sy=sy, sv=sv, gx=gx,
                gy=gy, sums=sums, b0=b0)


def _jfit(s, order, nreg, ivar=None):
    return js.fit_kernel(
        *(jnp.asarray(s[k]) for k in ('ref', 'sci')),
        jnp.asarray(s['ivar'] if ivar is None else ivar),
        *(jnp.asarray(s[k]) for k in ('sx', 'sy', 'sv', 'gx', 'gy', 'sums',
                                      'b0')),
        stamp=25, order=order, nreg=nreg)


def _basis(s, conv):
    return [conv(s[k]) for k in ('gx', 'gy', 'sums', 'b0')]


@pytest.fixture(scope='module')
def fit2():
    s = _scene(256, 256, 64, seed=3)
    j = _jfit(s, 2, 2)
    jp = [_jfit(s, 2, 2, s['ivar'] * np.float32(1 + f))
          for f in (1e-7, -1e-7)]
    t = ts.fit_kernel(*(T(s[k]) for k in ('ref', 'sci', 'ivar', 'sx', 'sy',
                                         'sv')),
                      *_basis(s, T), stamp=25, order=2, nreg=2)
    return s, j, jp, t


def test_fit_stamp_ok_equal(fit2):
    _, j, _, t = fit2
    assert int(t['stamp_ok'].sum()) > 40
    np.testing.assert_array_equal(t['stamp_ok'].numpy(),
                                  np.asarray(j['stamp_ok']))


def test_fit_center_kernel_sums_within_1mmag(fit2):
    s, j, _, t = fit2
    jk = np.asarray(js.center_kernels(j['coeffs'], *_basis(s, jnp.asarray),
                                      order=2, nreg=2)).sum((1, 2))
    tk = ts.center_kernels(t['coeffs'], *_basis(s, T), order=2,
                           nreg=2).sum((1, 2)).numpy()
    np.testing.assert_allclose(tk, jk, rtol=9.2e-4)


def test_fit_models_within_reference_spread(fit2):
    s, j, jp, t = fit2

    def model(c):
        return np.asarray(js.apply_kernel_fast(
            jnp.asarray(s['ref']), jnp.asarray(np.asarray(c)),
            *_basis(s, jnp.asarray), order=2, nreg=2))

    m0 = model(j['coeffs'])
    q = [50, 90, 99, 100]
    own = np.max([np.percentile(np.abs(model(p['coeffs']) - m0), q)
                  for p in jp], axis=0)
    port = np.percentile(np.abs(model(t['coeffs'].numpy()) - m0), q)
    assert port[0] < 0.01 * RMS
    assert (port <= 2.0 * own).all(), (port, own)


def test_apply_with_reference_coeffs_order4_3x3():
    s = _scene(240, 256, 128, seed=7)
    j = _jfit(s, 4, 3)
    jm = np.asarray(js.apply_kernel_fast(jnp.asarray(s['ref']), j['coeffs'],
                                         *_basis(s, jnp.asarray), order=4,
                                         nreg=3))
    coeffs = inputs.to_torch(np.asarray(j['coeffs']), 'cpu')
    tm = ts.apply_kernel_fast(T(s['ref']), coeffs, *_basis(s, T), order=4,
                              nreg=3)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-4, atol=1e-3)
    # the plain apply is the reference's direct (non-s2d) form too
    jd = np.asarray(js.apply_kernel(jnp.asarray(s['ref']), j['coeffs'],
                                    *_basis(s, jnp.asarray), order=4,
                                    nreg=3))
    np.testing.assert_allclose(tm.numpy(), jd, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('H,W,K,order,nreg', [
    (128, 120, 17, 4, 3),     # K <= 17, H and W multiples of 8: JAX's s2d
    (104, 96, 21, 5, 2),      # K > 17: JAX's grouped separable form
    (96, 88, 9, 0, 3),        # one term: H3's direct correlation on the card
    (80, 72, 31, 0, 1),       # one term at the largest K, one region
])
def test_apply_general_shapes_match_reference(H, W, K, order, nreg):
    """The plain model convolution against the reference's
    apply_kernel_fast at kernel sizes, orders and region layouts past the
    flagship's, on the same seeded coefficients; rtol 1e-4 as
    tests/test_subtract.py, atol 1e-3 counts on |model| ~ 150-3000."""
    rng = np.random.default_rng(K)
    b = inputs.KernelBasis(K, 2.0 / 2.355)
    nm = len(ts.spatial_terms(order))
    coeffs = rng.normal(0, 0.01, (nreg * nreg, b.nbasis * nm + 1))
    coeffs[:, 0] += 1.0
    coeffs[:, -1] = rng.normal(0, 3, nreg * nreg)
    coeffs = coeffs.astype('f4')
    ref = rng.normal(150, 30, (H, W)).astype('f4')
    yy, xx = np.mgrid[:H, :W]
    for x0, y0 in rng.uniform(10, min(H, W) - 10, (6, 2)):
        ref += (3000 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                              / (2 * 1.4 ** 2))).astype('f4')
    basis = (b.gx, b.gy, b.sums, b.b0_2d)
    jm = np.asarray(js.apply_kernel_fast(
        jnp.asarray(ref), jnp.asarray(coeffs),
        *(jnp.asarray(a) for a in basis), order=order, nreg=nreg))
    tm = ts.apply_kernel(T(ref), T(coeffs), *(T(a) for a in basis),
                         order=order, nreg=nreg)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('K,device,match', [
    (15, 'cpu', 'CUDA tensor'), (14, 'cpu', 'K=14'), (33, 'cpu', 'K=33')])
def test_apply_model_wrapper_refuses(K, device, match):
    """H3's wrapper raises (no fallback) for a CPU tensor, an even K and
    a K whose kernels do not fit in shared memory."""
    from zuds_tpu_torch.kernels import launch
    ref = torch.zeros((64, 64), device=device)
    kd = torch.zeros((4, 3, K, K), device=device)
    with pytest.raises(ValueError, match=match):
        launch.apply_model(ref, kd, torch.zeros(4, device=device),
                           [16.0, 48.0], [16.0, 48.0], [0, 1, 0], [0, 0, 1],
                           16.0, 16.0)


def test_apply_params_mirror_the_c_struct():
    """build.ApplyParams (ctypes) has apply.cu's fields, in order, and
    its capacities, so the launch reads what the wrapper wrote."""
    import ctypes
    import re
    from pathlib import Path
    from zuds_tpu_torch.kernels import build
    src = (Path(build.__file__).parent / 'apply.cu').read_text()
    body = re.search(r'struct ApplyParams \{(.*?)\};', src, re.S).group(1)
    body = re.sub(r'//[^\n]*', '', body)
    names = re.findall(r'(\w+)(?:\[\w+\])?\s*[,;]', body)
    assert names == [f for f, _ in build.ApplyParams._fields_]
    assert f'kMaxReg = {build.APPLY_MAX_REG};' in src
    assert f'kMaxTerms = {build.APPLY_MAX_TERMS};' in src
    assert ctypes.sizeof(build.ApplyParams) == (
        7 * 4 + 2 * 4 * build.APPLY_MAX_REG + 2 * build.APPLY_MAX_TERMS)


def test_center_kernels_match():
    rng = np.random.default_rng(4)
    b = inputs.KernelBasis(15, 2.0 / 2.355)
    coeffs = rng.normal(0, 0.1, (9, b.nbasis * 15 + 1)).astype('f4')
    j = js.center_kernels(jnp.asarray(coeffs), jnp.asarray(b.gx),
                          jnp.asarray(b.gy), jnp.asarray(b.sums),
                          jnp.asarray(b.b0_2d), order=4, nreg=3)
    t = ts.center_kernels(T(coeffs), T(b.gx), T(b.gy), T(b.sums),
                          T(b.b0_2d), order=4, nreg=3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize('order', [0, 1, 2, 4])
def test_spatial_terms_match(order):
    assert ts.spatial_terms(order) == js.spatial_terms(order)


def test_region_outer_is_the_three_operand_einsum():
    """Trap: a three-operand torch.einsum contracts left to right and
    would build an (S, a, b) intermediate; region_outer gives the same
    numbers through one matmul per region."""
    rng = np.random.default_rng(1)
    rw = T(rng.random((30, 4)).astype('f4'))
    A = T(rng.normal(size=(30, 49)).astype('f4'))
    B = T(rng.normal(size=(30, 15)).astype('f4'))
    np.testing.assert_allclose(ts.region_outer(rw, A, B).numpy(),
                               torch.einsum('sr,sa,sb->rab', rw, A,
                                            B).numpy(), rtol=1e-5,
                               atol=1e-5)
