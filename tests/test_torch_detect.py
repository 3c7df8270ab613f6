"""PyTorch port vs the JAX reference: detection with ``deblend=False``
(the matched filter is H4's plain version, the compaction H6's), aperture
photometry and the windowed/Kron refinement, on the CPU at 256^2.

Tolerances: n, valid, npix, the bounding boxes, imaflags, flags and the
three overflow counters bit-equal; x, y atol 1e-4 px; flux, peak, a, b and
thresh rtol 1e-5 (``thresh`` is the segment MAX of the threshold map,
detect.py:904-909). Photometry and refinement from identical detections:
rtol 1e-5 and flags equal; position angles, which are ill-conditioned for
near-round shapes, to 1e-4 rad.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu.ops import detect as jd
from zuds_tpu.ops.convolve import DEFAULT_FILTER as j_filter
from zuds_tpu.ops.convolve import conv2_same as j_conv2_same
from zuds_tpu.ops.measure import refine_detections as j_refine
from zuds_tpu.ops.photometry import aperture_photometry_batched as j_phot
from zuds_tpu_torch.ops import detect as td
from zuds_tpu_torch.ops.convolve import DEFAULT_FILTER, conv2_same
from zuds_tpu_torch.ops.measure import refine_detections as t_refine
from zuds_tpu_torch.ops.photometry import aperture_photometry_batched as t_phot

torch.set_num_threads(2)

H = W = 256
MAX_DET = 128


def T(a):
    return torch.as_tensor(np.array(a))


def _scene(seed, nsrc=40, overflow=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    diff = rng.normal(0, 5, (H, W)).astype('f4')
    for _ in range(nsrc):
        x0, y0 = rng.uniform(-2, W + 2), rng.uniform(-2, H + 2)
        s, f = rng.uniform(1.2, 3.0), rng.uniform(200, 2e4)
        diff += (f * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * s * s))
                 / (2 * np.pi * s * s)).astype('f4')
    if overflow:
        diff[60:200, 40:220] += 40.0          # a bright plateau
    diff[rng.random((H, W)) < 2e-4] = np.nan
    rms = (5.0 * (1 + 0.1 * rng.random((H, W)))).astype('f4')
    mask = np.where(rng.random((H, W)) < 0.01,
                    rng.integers(0, 1 << 17, (H, W)), 0).astype('i4')
    wok = rng.random((H, W)) > 0.01
    return diff, rms, mask, wok


def _run(scene, max_det=MAX_DET, **kw):
    diff, rms, mask, wok = scene
    j = jd.detect_sources(jnp.asarray(diff), jnp.asarray(rms),
                          jnp.asarray(mask).astype(jnp.uint32),
                          jnp.asarray(wok), max_det=max_det,
                          return_labels=False, deblend=False, **kw)
    t = td.detect_sources(T(diff), T(rms), T(mask), T(wok), max_det=max_det,
                          return_labels=False, deblend=False, **kw)
    return ({k: np.asarray(v) for k, v in j.items()},
            {k: v.numpy() for k, v in t.items()})


@pytest.fixture(scope='module')
def busy():
    scene = _scene(5)
    return scene, _run(scene)


@pytest.fixture(scope='module')
def overflowing():
    """Pixel capacity and object capacity both overflow."""
    scene = _scene(9, nsrc=200, overflow=True)
    return scene, _run(scene, max_det=8, det_cap=4096)


EXACT = ('n', 'valid', 'npix', 'xmin', 'xmax', 'ymin', 'ymax', 'imaflags',
         'flags', 'pix_overflow', 'deblend_overflow', 'obj_overflow')
RELATIVE = ('flux', 'peak', 'a', 'b', 'thresh')


@pytest.mark.parametrize('which', ['busy', 'overflowing'])
def test_detect_sources_matches(which, request):
    _, (j, t) = request.getfixturevalue(which)
    assert int(j['n']) > 5
    if which == 'overflowing':
        assert int(j['pix_overflow']) > 0 and int(j['obj_overflow']) > 0
    for k in EXACT:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    v = j['valid']
    for k in ('x', 'y'):
        np.testing.assert_allclose(t[k][v], j[k][v], rtol=0, atol=1e-4,
                                   err_msg=k)
    for k in RELATIVE:
        np.testing.assert_allclose(t[k][v], j[k][v], rtol=1e-5, err_msg=k)
    assert set(t) >= set(td.DETECTION_FIELDS) | {'n', 'valid'}


def test_matched_filter_plain_is_the_reference(busy):
    (diff, rms, _, wok), _ = busy
    good = wok & (rms > 0) & np.isfinite(diff)
    img = np.where(good, diff, 0).astype('f4')
    jf = np.asarray(j_conv2_same(jnp.asarray(img), j_filter))
    np.testing.assert_array_equal(DEFAULT_FILTER, j_filter)
    ti, tf, tdet = td.matched_filter_plain(T(diff), T(rms), T(wok), 1.5)
    np.testing.assert_array_equal(ti.numpy(), img)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tdet.numpy(), good & (jf > 1.5 * rms))
    np.testing.assert_array_equal(
        conv2_same(T(img), np.ones((3, 5)) / 15).numpy(),
        np.asarray(j_conv2_same(jnp.asarray(img), np.ones((3, 5)) / 15)))


def test_compact_indices_semantics():
    rng = np.random.default_rng(0)
    m = rng.random(5000) < 0.1
    for size in (100, 2000):
        np.testing.assert_array_equal(
            td.compact_indices(T(m), size, 4999)[0].numpy(),
            np.asarray(jd.compact_indices(jnp.asarray(m), size, 4999)))


def test_ccl_labels_are_component_minima():
    """Snakes and spirals need many rounds; the fixed point is the
    component's minimum flat index whatever the algorithm."""
    rng = np.random.default_rng(3)
    det = rng.random((96, 96)) < 0.45
    det[10, 5:90] = True
    det[10:80, 89] = True
    det[79, 20:90] = True
    j = np.asarray(jd.label_components(jnp.asarray(det), max_rounds=200))
    flat = np.flatnonzero(det.ravel())
    pidx = torch.as_tensor(flat)
    inv = torch.full((96 * 96,), -1, dtype=torch.int64)
    inv[pidx] = torch.arange(len(flat))
    pok = torch.ones(len(flat), dtype=torch.bool)
    nbr_pos, nbr_ok = td._adjacency(pidx, pok, inv, (96, 96))
    lab = td.label_compact(nbr_pos, nbr_ok & pok[nbr_pos],
                           torch.arange(len(flat)))
    np.testing.assert_array_equal(pidx[lab].numpy(), j.ravel()[flat])


def test_other_deblend_modes_run():
    """The exact tree and the watershed mode run (their parity with the
    reference is tests/test_torch_deblend.py) and return the segmentation
    map by default, as the reference does."""
    diff, rms, mask, wok = (T(a) for a in _scene(1, nsrc=3))
    for mode in (True, 'watershed'):
        out = td.detect_sources(diff, rms, mask, wok, max_det=MAX_DET,
                                deblend=mode)
        assert out['labels'].shape == (H, W)
        ids = torch.unique(out['labels'])
        assert len(ids[ids > 0]) == int(out['n']) > 0


def test_photometry_from_identical_detections(busy):
    (diff, rms, mask, _), (j, _) = busy
    x, y = j['x'], j['y']
    jp = j_phot(jnp.asarray(diff), jnp.asarray(rms),
                jnp.asarray(mask).astype(jnp.uint32), jnp.asarray(x),
                jnp.asarray(y))
    tp = t_phot(T(diff), T(rms), T(mask), T(x), T(y))
    for k in ('flux', 'fluxerr', 'area'):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-3, err_msg=k)
    np.testing.assert_array_equal(tp['oob'].numpy(), np.asarray(jp['oob']))
    # a mask bit under a pixel whose overlap with the circle is a rounding
    # residue (the four signed quarter areas cancel to ~1 ulp of ~7 px^2)
    # is set or not by the last bit of asin/sqrt: compare the other bits
    res = _residue_bits(mask, x, y, 3.0, 9)
    assert (res != 0).sum() < len(x) // 4
    np.testing.assert_array_equal(tp['flags'].numpy() & ~res,
                                  np.asarray(jp['flags']) & ~res)


def _residue_bits(mask, xs, ys, r, cut, eps=1e-5):
    """Per aperture, the OR of the mask bits under pixels whose overlap is
    0 < w < eps in either version."""
    from zuds_tpu.ops.photometry import circle_pixel_overlap as jc
    from zuds_tpu_torch.ops.photometry import circle_pixel_overlap as tc
    half = cut // 2
    out = []
    for xc, yc in zip(xs, ys):
        x0 = min(max(int(np.round(xc)) - half, 0), W - cut)
        y0 = min(max(int(np.round(yc)) - half, 0), H - cut)
        dx = np.broadcast_to(x0 + np.arange(cut, dtype='f4') - xc,
                             (cut, cut))
        dy = np.broadcast_to((y0 + np.arange(cut, dtype='f4') - yc)[:, None],
                             (cut, cut))
        wj = np.asarray(jc(jnp.asarray(dx), jnp.asarray(dy),
                           jnp.float32(r)))
        wt = tc(T(dx), T(dy), r).numpy()
        tiny = ((wj > 0) & (wj < eps)) | ((wt > 0) & (wt < eps))
        out.append(np.bitwise_or.reduce(
            np.where(tiny, mask[y0:y0 + cut, x0:x0 + cut], 0), axis=None))
    return np.array(out, np.int64)


def test_round_half_to_even_at_cutout_corners():
    """Trap: torch.round and jnp.round both round half to even, so a
    source at x = k + 0.5 gets the reference's cutout (photometry.py:92,
    pipeline.py:314 and :344)."""
    half = np.array([2.5, 3.5, -0.5, 0.5, 100.5, 101.5], 'f4')
    np.testing.assert_array_equal(torch.round(T(half)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(half))))
    rng = np.random.default_rng(2)
    img = rng.normal(0, 5, (64, 64)).astype('f4')
    xs = np.array([10.5, 11.5, 30.5, 31.5], 'f4')
    ys = np.array([20.5, 21.5, 7.5, 8.5], 'f4')
    jp = j_phot(jnp.asarray(img), None, None, jnp.asarray(xs),
                jnp.asarray(ys))
    tp = t_phot(T(img), torch.zeros(64, 64), torch.zeros(64, 64,
                                                         dtype=torch.int32),
                T(xs), T(ys))
    np.testing.assert_allclose(tp['flux'].numpy(), np.asarray(jp['flux']),
                               rtol=1e-5, atol=1e-4)


def test_refine_from_identical_detections(busy):
    (diff, rms, _, _), (j, _) = busy
    v = j['valid']
    args = [j[k][v] for k in ('x', 'y', 'a', 'b', 'theta', 'fwhm')]
    jm = j_refine(jnp.asarray(diff), jnp.asarray(rms),
                  *(jnp.asarray(a) for a in args))
    tm = t_refine(T(diff), T(rms), *(T(a) for a in args))
    for k, want in jm.items():
        got, want = tm[k].numpy(), np.asarray(want)
        if k in ('thetawin', 'errthetawin'):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
