"""The port's separable warp (``sep_warp=True``) against the JAX package on
the CPU: ``warp_shift_sep_image_mask`` and ``warp_shift_image_sep`` at
window 2 and 4 and order 0 and 1 on two scenes, a 0.1 degree rotation at
256^2 with a bright source (tests/test_resample.py's rotation scene) and
a distorted 128^2 field (its fused-parts scene), each with a sparse
18-bit mask.

Coverage and mask are bit-equal: they come from f32 subtractions and
interval tests alone. The pixels are not: XLA:CPU contracts
``hp + rolled * wx``, ``hrow - corr * hd`` and ``acc + wy * hrow`` into
FMAs and computes sin and cos otherwise than PyTorch, and the first-order
correction ``hrow - corr * hd`` amplifies the rounding where ``dudy`` is
steep. They are held to the warp row of docs/PARITY_CONTRACT.md (rtol
3e-5, atol 5e-3 counts) and, as the reference's own test bounds the
approximation, relative to ``|ref| + 1``. Within the port the fused form
equals its parts bit for bit (the contract's "fused sep warp vs two-pass
parts" row).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu.ops import resample as jr
from zuds_tpu_torch.ops import resample as tr

torch.set_num_threads(2)

RTOL, ATOL = 3e-5, 5e-3


def _smooth(H, W):
    y, x = np.mgrid[0:H, 0:W]
    return (150.0 + 5 * np.sin(2 * np.pi * x / 97.0)
            + 4 * np.cos(2 * np.pi * y / 71.0)
            + 3 * np.sin(2 * np.pi * (x + y) / 131.0)).astype('f4')


def _mask(rng, H, W):
    bits = rng.integers(0, 1 << 18, (H, W))
    return np.where(rng.random((H, W)) < 0.01, bits, 0).astype('i4')


def _scene(name):
    rng = np.random.default_rng(8675309)
    if name == 'rotation':
        H = W = 256
        img = _smooth(H, W)
        g = np.mgrid[-5:6, -5:6]
        img[90:101, 110:121] += (4000.0 * np.exp(
            -(g[0] ** 2 + g[1] ** 2) / 6.0)).astype('f4')
        th = np.deg2rad(0.1)
        Y, X = np.mgrid[0:H, 0:W].astype('f4')
        cx, cy = W / 2, H / 2
        u = cx + np.cos(th) * (X - cx) - np.sin(th) * (Y - cy) + 1.3
        v = cy + np.sin(th) * (X - cx) + np.cos(th) * (Y - cy) - 0.7
    else:
        H = W = 128
        img = _smooth(H, W)
        Y, X = np.mgrid[0:H, 0:W].astype('f4')
        th = np.deg2rad(0.05)
        u = X + 2.1 + 0.5 * np.sin(Y / 40) - th * (Y - H / 2)
        v = Y - 1.4 + 0.3 * np.cos(X / 30) + th * (X - W / 2)
    return (img, _mask(rng, H, W), u.astype('f4'), v.astype('f4'))


CASES = [(s, w, o) for s in ('rotation', 'distorted') for w in (2, 4)
         for o in (0, 1)]


@pytest.fixture(scope='module')
def warps():
    """Both packages' fused warp and the port's parts, per case."""
    out = {}
    for scene, window, order in CASES:
        img, mask, u, v = _scene(scene)
        j = jr.warp_shift_sep_image_mask(
            jnp.asarray(img), jnp.asarray(mask.astype('u4')), jnp.asarray(u),
            jnp.asarray(v), window=window, order=order)
        ti, tm, tu, tv = (torch.as_tensor(a) for a in (img, mask, u, v))
        t = tr.warp_shift_sep_image_mask(ti, tm, tu, tv, window=window,
                                         order=order)
        parts = (tr.warp_shift_image_sep(ti, tu, tv, window=window,
                                         order=order),
                 tr.warp_shift_mask(tm, tu, tv, window=window))
        out[scene, window, order] = (
            img, [np.asarray(a) for a in j], [a.numpy() for a in t],
            [p.numpy() for p in parts[0]] + [parts[1].numpy()])
    return out


@pytest.mark.parametrize('scene,window,order', CASES)
def test_coverage_and_mask_bit_equal(warps, scene, window, order):
    _, j, t, _ = warps[scene, window, order]
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_array_equal(t[1], j[1].astype('i4'))
    assert t[1].dtype == np.int32 and t[2].dtype == np.float32
    assert (t[2] > 0).any() and (t[2] == 0).any()
    assert (t[1] != 0).any()


@pytest.mark.parametrize('scene,window,order', CASES)
def test_pixels_within_the_warp_contract(warps, scene, window, order):
    _, j, t, _ = warps[scene, window, order]
    err = np.abs(t[0].astype('f8') - j[0])
    m = j[2] > 0
    rel = err[m] / (np.abs(j[0][m]) + 1.0)
    print(f'{scene} window {window} order {order}: max |port - JAX| '
          f'{err.max():.3g} counts, {rel.max():.3g} of |ref| + 1')
    assert t[0].dtype == np.float32
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL, atol=ATOL)
    assert rel.max() < RTOL


@pytest.mark.parametrize('scene,window,order', CASES)
def test_fused_equals_its_parts(warps, scene, window, order):
    _, _, t, parts = warps[scene, window, order]
    img, cov, mask = parts
    np.testing.assert_array_equal(t[0], img)
    np.testing.assert_array_equal(t[2], cov)
    np.testing.assert_array_equal(t[1], np.where(cov > 0, mask, 0))


@pytest.mark.parametrize('window', [2, 4])
def test_first_order_term_matches_the_exact_warp(warps, window):
    """The reference's own bound for the approximation: order 1 within
    5e-5 of |ref| + 1 of the exact shift-accumulate warp under the 0.1
    degree rotation, order 0 further off."""
    img, _, t1, _ = warps['rotation', window, 1]
    _, _, t0, _ = warps['rotation', window, 0]
    _, _, u, v = _scene('rotation')
    exact, cov = tr.warp_shift_image(torch.as_tensor(img),
                                     torch.as_tensor(u), torch.as_tensor(v),
                                     window=window)
    exact, m = exact.numpy(), cov.numpy() > 0
    np.testing.assert_array_equal(cov.numpy(), t1[2])
    rel1 = np.abs(t1[0] - exact)[m] / (np.abs(exact)[m] + 1.0)
    rel0 = np.abs(t0[0] - exact)[m] / (np.abs(exact)[m] + 1.0)
    assert rel1.max() < 5e-5 < rel0.max()


def test_lanczos3_d_matches_the_reference():
    t = np.concatenate([np.linspace(-3.5, 3.5, 20001),
                        [0.0, 1e-7, -1e-7, 9.99e-4, -1.001e-3, 1.0, -2.0,
                         3.0, -3.0]]).astype('f4')
    j = np.asarray(jr._lanczos3_d(jnp.asarray(t)))
    p = tr._lanczos3_d(torch.as_tensor(t)).numpy()
    small = np.abs(t) < 1e-3
    np.testing.assert_array_equal(p[small], j[small])
    np.testing.assert_array_equal(p[np.abs(t) >= 3], 0.0)
    # the closed form cancels near 0: its rounding, not the formula, sets
    # the gap (<= 4e-4 at |t| ~ 1e-3, where its terms are ~1e4 times L')
    gap = np.abs(p - j) / (1e-4 + 1e-3 / np.maximum(np.abs(t), 1e-3))
    assert gap.max() < 1.0


# ---- the pipeline at sep_warp=True ------------------------------------

KW = dict(height=256, width=256, ksize=9, stamp=25, smax=32, order=2,
          nreg=2, max_det=128, box=64, deblend=False, sep_warp=True)


@pytest.fixture(scope='module')
def pipelines():
    """The reference's and the port's pipeline at sep_warp=True on the
    inputs of tests/test_torch_pipeline.py, and the reference's runs on
    sci perturbed by 1e-7 and on ref perturbed by -1e-7, 1e-7, 2e-7 and
    5e-7 (relative): the two packages' separable warps differ by up to
    5.3e-7 of |ref| + 1 (the warp tests above), and the reference's fit
    amplifies a change of its warped reference as it does one of sci."""
    from zuds_tpu.parallel import pipeline as jp
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.parallel import pipeline as tp
    args, planted = inputs.plant_sources(
        inputs.synth_inputs(2, 256, 256, tp.PipelineConfig(**KW), seed=0),
        n=3, flux=2e4, seed=1)
    fn = jp.make_subtract_detect_pipeline(jp.PipelineConfig(**KW))
    ja = [jnp.asarray(a) for a in args]
    j = {k: np.asarray(v) for k, v in fn(*ja).items()}
    jpert = []
    for which, e in ((0, 1e-7), (2, -1e-7), (2, 1e-7), (2, 2e-7),
                     (2, 5e-7)):
        a = list(ja)
        a[which] = jnp.asarray((args[which] * np.float32(1 + e))
                               .astype('f4'))
        jpert.append({k: np.asarray(v) for k, v in fn(*a).items()})
    t = tp.SubtractDetectPipeline(tp.PipelineConfig(**KW))(
        *inputs.to_torch(args, 'cpu'))
    return args, planted, j, jpert, {k: v.numpy() for k, v in t.items()}


def test_pipeline_sep_warp_matches_the_reference(pipelines):
    """The default warp's gates (tests/test_torch_pipeline.py), the
    reference's own spread taken over the perturbations of the fixture:
    keys and shapes, submask equal, diff within twice that spread at the
    median, 90th and 99th percentiles and the maximum (median below 0.01
    rms), det_n within 1 plus twice its spread, the planted sources
    among the shared detections at 0.01 px and ap_flux rtol 1e-3, rms_med
    rtol 1e-4, the fit's surviving stamps and the overflow counters
    equal."""
    args, planted, j, jpert, t = pipelines
    assert set(t) == set(j)
    for k in j:
        assert t[k].shape == j[k].shape, k
    np.testing.assert_array_equal(t['submask'], j['submask'])
    ok = j['submask'] == 0
    q = [50, 90, 99, 100]
    own = np.max([np.percentile((np.abs(p['diff'] - j['diff'])
                                 / j['rms'])[ok], q) for p in jpert], 0)
    spread = np.abs(np.stack([p['det_n'] for p in jpert])
                    - j['det_n']).max(0)
    port = np.percentile((np.abs(t['diff'] - j['diff']) / j['rms'])[ok], q)
    assert port[0] < 0.01 and (port <= 2.0 * own).all(), (port, own)
    med_own = np.abs(np.stack([p['rms_med'] for p in jpert])
                     - j['rms_med']).max(0)
    assert (np.abs(t['rms_med'] - j['rms_med'])
            <= np.maximum(1e-4 * np.abs(j['rms_med']), 2 * med_own)).all()
    for k in ('fit_stamps_ok', 'det_pix_overflow', 'det_deblend_overflow',
              'det_obj_overflow'):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for b in range(2):
        assert abs(int(t['det_n'][b]) - int(j['det_n'][b])) \
            <= 1 + 2 * int(spread[b])
        found = 0
        for px, py in planted[b]:
            dj = np.hypot(j['det_x'][b] - px, j['det_y'][b] - py)
            dt = np.hypot(t['det_x'][b] - px, t['det_y'][b] - py)
            dj[~j['det_valid'][b]] = np.inf
            dt[~t['det_valid'][b]] = np.inf
            i, k = dj.argmin(), dt.argmin()
            assert dj[i] <= 1.0 and dt[k] <= 1.0
            assert abs(t['det_x'][b][k] - j['det_x'][b][i]) <= 0.01
            assert abs(t['det_y'][b][k] - j['det_y'][b][i]) <= 0.01
            np.testing.assert_allclose(t['ap_flux'][b][k],
                                       j['ap_flux'][b][i], rtol=1e-3)
            found += 1
        assert found == 3


def test_pipeline_sep_warp_stays_near_the_exact_warp(pipelines):
    """The port's sep_warp=True frame against its own default warp: the
    approximation moves the difference image by a small share of the
    noise."""
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.parallel import pipeline as tp
    args, _, _, _, t = pipelines
    exact = tp.SubtractDetectPipeline(tp.PipelineConfig(
        **{**KW, 'sep_warp': False}))(*inputs.to_torch(args, 'cpu'))
    ok = t['submask'] == 0
    np.testing.assert_array_equal(t['submask'], exact['submask'].numpy())
    rel = np.abs(t['diff'] - exact['diff'].numpy())[ok] / t['rms'][ok]
    assert np.percentile(rel, 50) < 0.01
