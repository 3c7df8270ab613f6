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


# ---- the reference's probes (dbg_stop_after) ---------------------------

PROBE_CASES = [(p, True) for p in td.DETECT_PROBES] + [
    ('cell', False), ('deblend', 'watershed'), ('stats', False)]


@pytest.fixture(scope='module')
def busy_probes(busy):
    (diff, rms, mask, wok), _ = busy
    out = {}
    for probe, mode in PROBE_CASES:
        kw = dict(max_det=MAX_DET, return_labels=False, deblend=mode,
                  dbg_stop_after=probe)
        j = jd.detect_sources(jnp.asarray(diff), jnp.asarray(rms),
                              jnp.asarray(mask).astype(jnp.uint32),
                              jnp.asarray(wok), **kw)
        t = td.detect_sources(T(diff), T(rms), T(mask), T(wok), **kw)
        out[probe, mode] = (np.asarray(j['dbg']), t)
    return out


@pytest.mark.parametrize('probe,mode', PROBE_CASES)
def test_probe_bit_equal(busy_probes, probe, mode):
    """Every probe of the reference, bit for bit: int32 sums that wrap as
    JAX's x64-off sums (the compact list's and the inverse map's sums pass
    2^31 here), the (4,) edge census; 'stats' is a float sum whose empty
    row 0 has xmin = +inf, so +inf in both."""
    j, t = busy_probes[probe, mode]
    assert set(t) == {'dbg'}
    t = t['dbg'].numpy()
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)
    if probe == 'stats':
        assert np.isposinf(j)
    elif probe == 'deb_edges':
        assert j.shape == (4,) and (j > 0).all()
    else:
        assert j.dtype == np.int32 and j != 0


def test_probe_past_the_path_returns_the_full_dict(busy):
    """A tree probe at deblend=False never fires: the full dict, no 'dbg'
    (the pipeline then raises KeyError, as the reference's)."""
    (diff, rms, mask, wok), (_, t) = busy
    got = td.detect_sources(T(diff), T(rms), T(mask), T(wok),
                            max_det=MAX_DET, return_labels=False,
                            deblend=False, dbg_stop_after='deb_lab')
    assert 'dbg' not in got
    for k in t:
        np.testing.assert_array_equal(got[k].numpy(), t[k], err_msg=k)


# ---- detect_sources(kernel=) ------------------------------------------

def _filters():
    rng = np.random.default_rng(11)
    zeros = np.zeros((5, 5))
    zeros[2, :] = [1, 2, 4, 2, 1]
    zeros[:, 2] = [1, 2, 4, 2, 1]
    zeros[0, 0] = -0.5
    return {
        'default': DEFAULT_FILTER,
        'gauss5': td_gaussian(1.5, 5),
        'row7': np.array([[1.0, 2.0, 3.0, 4.0, 3.0, 2.0, 1.0]]) / 16.0,
        'rand7x7': rng.uniform(0.1, 1.0, (7, 7)) / 25.0,
        'zero_taps': zeros / zeros.sum(),
        'rand9x9': rng.uniform(0.1, 1.0, (9, 9)) / 40.0,
    }


def td_gaussian(sigma, size):
    from zuds_tpu_torch.ops.convolve import gaussian_kernel
    return gaussian_kernel(sigma, size, device='cpu')


FILTERS = list(_filters())


@pytest.fixture(scope='module')
def filtered(busy):
    """Each filter through both packages at deblend=False, and the
    reference's filtered frame as its jitted call computes it (an explicit
    filter is traced there, so it takes XLA's convolution)."""
    import jax
    from zuds_tpu.ops.convolve import conv2_same as jconv
    (diff, rms, mask, wok), _ = busy
    good = wok & (rms > 0) & np.isfinite(diff)
    img = np.where(good, diff, 0).astype('f4')
    out = {}
    for name, k in _filters().items():
        kn = k.numpy() if torch.is_tensor(k) else np.asarray(k)
        j = jd.detect_sources(jnp.asarray(diff), jnp.asarray(rms),
                              jnp.asarray(mask).astype(jnp.uint32),
                              jnp.asarray(wok), max_det=MAX_DET,
                              return_labels=False, deblend=False,
                              kernel=kn)
        t = td.detect_sources(T(diff), T(rms), T(mask), T(wok),
                              max_det=MAX_DET, return_labels=False,
                              deblend=False, kernel=k)
        jf = np.asarray(jax.jit(jconv)(jnp.asarray(img), jnp.asarray(kn)))
        tf = td.matched_filter(T(diff), T(rms), T(wok), 1.5, k)
        out[name] = (kn, {a: np.asarray(b) for a, b in j.items()},
                     {a: b.numpy() for a, b in t.items()}, jf,
                     [a.numpy() for a in tf])
    return img, rms, good, out


@pytest.mark.parametrize('name', FILTERS)
def test_detect_sources_with_a_filter(filtered, name):
    """filt within 1e-6 sum|k| max|img| of the reference's (its
    convolution sums in another order), det equal but where filt lies that
    close to the threshold, and the catalog held as the default filter's
    (bit-equal counts, flags and boxes; x, y to 1e-4 px; flux, peak, a,
    b, thresh to rtol 1e-5)."""
    img, rms, good, out = filtered
    kn, j, t, jf, (ti, tf, tdet) = out[name]
    np.testing.assert_array_equal(ti, img)
    tol = 1e-6 * np.abs(kn).sum() * np.abs(img).max()
    err = np.abs(tf.astype('f8') - jf)
    print(f'{name}: {kn.shape}, max |filt - reference| {err.max():.3g} '
          f'(tolerance {tol:.3g})')
    assert err.max() <= tol
    jdet = good & (jf > np.float32(1.5) * rms)
    near = np.abs(jf.astype('f8') - np.float32(1.5) * rms) <= tol
    assert not (tdet != jdet)[~near].any()
    if (tdet != jdet).any():
        pytest.skip(f'{name}: a pixel within the tolerance of its '
                    'threshold flips; the catalogs may differ there')
    assert int(j['n']) > 5
    for k in EXACT:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    v = j['valid']
    for k in ('x', 'y'):
        np.testing.assert_allclose(t[k][v], j[k][v], rtol=0, atol=1e-4)
    for k in RELATIVE:
        np.testing.assert_allclose(t[k][v], j[k][v], rtol=1e-5, err_msg=k)


def test_default_filter_given_is_the_default(busy, filtered):
    (diff, rms, mask, wok), (_, t) = busy
    got = filtered[3]['default'][2]
    for k in t:
        np.testing.assert_array_equal(got[k], t[k], err_msg=k)
    for given in (DEFAULT_FILTER.astype('f4'), T(DEFAULT_FILTER)):
        a = td.matched_filter(T(diff), T(rms), T(wok), 1.5, given)
        b = td.matched_filter(T(diff), T(rms), T(wok), 1.5)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_conv2_same_branches(busy):
    """The tap-by-tap branch equals the reference's unjitted call bit for
    bit (its numpy filter stays static there); past max_taps one
    convolution, with asymmetric padding for even sizes."""
    from zuds_tpu.ops.convolve import conv2_same as jconv
    (diff, _, _, _), _ = busy
    img = np.nan_to_num(diff).astype('f4')
    rng = np.random.default_rng(4)
    for shape in ((4, 6), (2, 1), (7, 7)):
        k = rng.normal(0, 1, shape)
        k[0, 0] = 0.0
        np.testing.assert_array_equal(
            conv2_same(T(img), k).numpy(),
            np.asarray(jconv(jnp.asarray(img), k)))
    for shape, taps in (((6, 8), 10), ((9, 9), 49), ((3, 3), 4)):
        k = rng.normal(0, 1, shape)
        got = conv2_same(T(img), T(k.astype('f4')), max_taps=taps).numpy()
        want = np.asarray(jconv(jnp.asarray(img), k, max_taps=taps))
        tol = 1e-6 * np.abs(k).sum() * np.abs(img).max()
        assert np.abs(got.astype('f8') - want).max() <= tol, shape
