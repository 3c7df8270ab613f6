"""The plain twins of the detect stage's hand kernels H24-H27 on the CPU,
and the detect stage through them against the JAX package, at <= 256^2
with compact lists of <= 16,384 entries.

- ``ordered.tree_scan_at`` (the walk up the scan's tree from a row's end,
  which ``tests/test_torch_row_scan.py`` holds H26's per-row twin to) equals
  ``segmented_scan(...)[:, ends]`` bit for bit at even, odd and
  non-power-of-two lengths, with single-entry and empty rows;
  ``ordered.counting_sort`` (H26's sort) gives ``torch.sort(stable=True)``'s
  permutation and ``searchsorted``'s starts.
- A sequential union-find in H25's passes (parent = lab0, hook the larger
  root under the smaller, flatten) gives ``label_compact_plain``'s fixed
  point, bit for bit.
- ``detect_sources`` (whose statistics and CLEAN are ``object_stats_plain``
  and ``_clean_plain`` here) against JAX's on the ``busy`` and
  ``overflowing`` scenes at ``deblend=True`` and on a scene whose CLEAN
  merges three wing spikes into one star, to the tolerances of
  ``tests/test_torch_detect.py``: n, valid, npix, the boxes, imaflags,
  flags and the overflow counters bit-equal; x, y atol 1e-4 px; flux,
  peak, a, b, thresh rtol 1e-5.
- ``label_components`` equals ``zuds_tpu.ops.detect.label_components(...,
  max_rounds=200)`` bit for bit on the snake scene and a random 128^2 mask.
- The reference's hook-and-compress loop stops after 64 rounds
  (detect.py:685-687); the port's plain loop, the same round, reaches the
  fixed point well within that on every tested scene.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu.ops import detect as jd
from zuds_tpu_torch.ops import detect as td
from zuds_tpu_torch.ops.ordered import (counting_sort, segmented_scan,
                                        tree_scan_at)

torch.set_num_threads(2)


def T(a):
    return torch.as_tensor(np.array(a))


def _segments(n, seed):
    """Sorted ids over n entries with gaps (empty rows) and single-entry
    rows; the scan's start flags and each row's last position."""
    rng = np.random.default_rng(seed)
    nrows = max(2, n // 3)
    cid = np.sort(rng.integers(0, nrows, n))
    cid[0] = 1                       # row 0 empty
    if n > 4:
        cid[-1] = nrows + 1          # a single-entry last row, nrows empty
    cid = np.sort(cid)
    start = np.r_[True, cid[1:] != cid[:-1]]
    rows = np.arange(nrows + 2)
    ends = np.clip(np.searchsorted(cid, rows + 1) - 1, 0, n - 1)
    return T(cid), T(start), T(ends)


@pytest.mark.parametrize('n', [2, 7, 64, 100, 1023, 16384])
def test_tree_scan_at_is_segmented_scan(n):
    _, start, ends = _segments(n, n)
    rng = np.random.default_rng(n + 1)
    v = rng.normal(0, 1, (3, n)) * 10 ** rng.uniform(-3, 3, (3, n))
    v = T(v.astype('f4'))
    for combine in (torch.add, torch.maximum, torch.minimum):
        want = segmented_scan(v, start, combine)[:, ends]
        got = tree_scan_at(v, start, ends, combine)
        assert torch.equal(got, want), combine
    m = T(rng.integers(0, 1 << 17, n).astype('i4'))[None]
    assert torch.equal(tree_scan_at(m, start, ends, torch.bitwise_or),
                       segmented_scan(m, start, torch.bitwise_or)[:, ends])


@pytest.mark.parametrize('n,nkeys', [(1, 1), (5000, 130), (16384, 4098)])
def test_counting_sort_is_the_stable_sort(n, nkeys):
    keys = T(np.random.default_rng(n).integers(0, nkeys, n))
    perm, starts, counts = counting_sort(keys, nkeys)
    keys_s, want = torch.sort(keys, stable=True)
    assert torch.equal(perm, want)
    assert torch.equal(starts, torch.searchsorted(keys_s,
                                                  torch.arange(nkeys)))
    assert torch.equal(counts, torch.bincount(keys, minlength=nkeys))


def _union_find(nbr_pos, okb, lab0):
    """H25's passes, one edge after another: parent = lab0 (a forest, lab0
    at most the own position), every edge hooks the larger root under the
    smaller, then each entry takes its root."""
    nbr, ok = nbr_pos.numpy(), okb.numpy()
    parent = lab0.numpy().copy()

    def root(x):
        while parent[x] != x:
            x = parent[x]
        return x

    for k in range(8):
        for i in np.flatnonzero(ok[k]):
            a, b = sorted((root(i), root(nbr[k, i])))
            parent[b] = a
    return T(np.array([root(i) for i in range(len(parent))]))


def _snake():
    rng = np.random.default_rng(3)
    det = rng.random((96, 96)) < 0.45
    det[10, 5:90] = True
    det[10:80, 89] = True
    det[79, 20:90] = True
    return det


def _compact_graph(det):
    """The compact list of every pixel of ``det`` with its 8-neighbour
    edges, as test_torch_detect.py's snake test builds it."""
    H, W = det.shape
    flat = np.flatnonzero(det.ravel())
    pidx = torch.as_tensor(flat)
    inv = torch.full((H * W,), -1, dtype=torch.int64)
    inv[pidx] = torch.arange(len(flat))
    pok = torch.ones(len(flat), dtype=torch.bool)
    nbr_pos, nbr_ok = td._adjacency(pidx, pok, inv, (H, W))
    return nbr_pos, nbr_ok & pok[nbr_pos], torch.arange(len(flat))


def _scene(seed, nsrc=40, overflow=False, H=256, W=256):
    """tests/test_torch_detect.py's scene."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    diff = rng.normal(0, 5, (H, W)).astype('f4')
    for _ in range(nsrc):
        x0, y0 = rng.uniform(-2, W + 2), rng.uniform(-2, H + 2)
        s, f = rng.uniform(1.2, 3.0), rng.uniform(200, 2e4)
        diff += (f * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * s * s))
                 / (2 * np.pi * s * s)).astype('f4')
    if overflow:
        diff[60:200, 40:220] += 40.0
    diff[rng.random((H, W)) < 2e-4] = np.nan
    rms = (5.0 * (1 + 0.1 * rng.random((H, W)))).astype('f4')
    mask = np.where(rng.random((H, W)) < 0.01,
                    rng.integers(0, 1 << 17, (H, W)), 0).astype('i4')
    wok = rng.random((H, W)) > 0.01
    return diff, rms, mask, wok


def _wing_scene():
    """tests/test_detect.py's wing-spike scene with three marginal bumps in
    the bright star's wing (CLEAN merges all three into it) and one on
    blank sky."""
    rng = np.random.default_rng(11)
    H, W = 128, 128
    img = rng.normal(0, 0.3, (H, W)).astype('f4')
    yy, xx = np.mgrid[0:H, 0:W]
    img += (400000.0 / (2 * np.pi * 36) * np.exp(
        -((xx - 64) ** 2 + (yy - 64) ** 2) / (2 * 36.0))).astype('f4')
    for x0, y0 in ((94, 64), (64, 94), (43, 43), (20, 110)):
        img += (3.0 * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2)
                             / (2 * 2.25))).astype('f4')
    rms = np.ones((H, W), dtype='f4')
    mask = np.zeros((H, W), 'i4')
    return img, rms, mask, np.ones((H, W), bool)


def test_union_find_reaches_the_plain_fixed_point():
    """H25's claim: the union-find's labels are label_compact_plain's,
    from the identity (the snake) and from the detect stage's own seeds
    (the busy scene, where lab0 points down)."""
    graph = _compact_graph(_snake())
    assert torch.equal(_union_find(*graph), td.label_compact_plain(*graph))
    diff, rms, mask, wok = (T(a) for a in _scene(5))
    nbr_pos, okb, lab0 = td.detect_taps(diff, rms, mask, wok, max_det=128,
                                        deblend=False)['ccl']
    assert bool((lab0 <= torch.arange(len(lab0))).all())
    assert not torch.equal(lab0, torch.arange(len(lab0)))
    assert torch.equal(_union_find(nbr_pos, okb, lab0),
                       td.label_compact_plain(nbr_pos, okb, lab0))


SCENES = {'busy': (lambda: _scene(5), {}),
          'overflowing': (lambda: _scene(9, nsrc=200, overflow=True),
                          {'max_det': 8, 'det_cap': 4096}),
          'wings': (_wing_scene, {'max_det': 64, 'nsigma': 1.5})}
EXACT = ('n', 'valid', 'npix', 'xmin', 'xmax', 'ymin', 'ymax', 'imaflags',
         'flags', 'pix_overflow', 'deblend_overflow', 'obj_overflow')


@pytest.mark.parametrize('which', list(SCENES))
def test_detect_stats_and_clean_match_the_reference(which):
    make, kw = SCENES[which]
    diff, rms, mask, wok = make()
    kw = {'max_det': 128, **kw}
    j = jd.detect_sources(jnp.asarray(diff), jnp.asarray(rms),
                          jnp.asarray(mask).astype(jnp.uint32),
                          jnp.asarray(wok), return_labels=False,
                          deblend=True, **kw)
    t = td.detect_sources(T(diff), T(rms), T(mask), T(wok),
                          return_labels=False, deblend=True, **kw)
    j = {k: np.asarray(v) for k, v in j.items()}
    t = {k: v.numpy() for k, v in t.items()}
    assert int(j['n']) > 1
    if which == 'wings':
        # three spikes merged into the star: FLAGS bit 2 on one row, its
        # npix the star's and theirs
        assert int(((t['flags'] & 2) != 0).sum()) == 1
    for k in EXACT:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    v = j['valid']
    for k in ('x', 'y'):
        np.testing.assert_allclose(t[k][v], j[k][v], rtol=0, atol=1e-4,
                                   err_msg=k)
    for k in ('flux', 'peak', 'a', 'b', 'thresh'):
        np.testing.assert_allclose(t[k][v], j[k][v], rtol=1e-5, err_msg=k)


def test_wing_scene_cleans_three_rows():
    """CLEAN on the wing scene merges three rows into the star (so the
    kernel's merge order matters there): their flux and npix are the
    star's gain."""
    diff, rms, mask, wok = (T(a) for a in _wing_scene())
    args = td.detect_taps(diff, rms, mask, wok, max_det=64)['clean']
    flux, npix, flags, valid = td._clean_plain(*args)
    cleaned = args[10] & ~valid
    assert int(cleaned.sum()) == 3
    star = int(torch.nonzero((flags & 2) != 0)[0, 0])
    assert float(npix[star] - args[8][star]) == float(args[8][cleaned].sum())


@pytest.mark.parametrize('which', ['snake', 'random'])
def test_label_components_matches_the_reference(which):
    det = _snake() if which == 'snake' else \
        np.random.default_rng(8).random((128, 128)) < 0.5
    want = np.asarray(jd.label_components(jnp.asarray(det), max_rounds=200))
    got = td.label_components(T(det))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_reference_reaches_its_ccl_fixed_point():
    """Rounds that change the labels, per tested scene: the reference's
    loop (the same round) reaches its fixed point when they are at most
    its cap of 64. The snake from the identity takes the most."""
    rounds = {'snake': td.label_compact_rounds(*_compact_graph(_snake()))}
    for which, (make, kw) in SCENES.items():
        diff, rms, mask, wok = (T(a) for a in make())
        kw = {'max_det': 128, **kw}
        rounds[which] = td.label_compact_rounds(
            *td.detect_taps(diff, rms, mask, wok, deblend=False,
                            **kw)['ccl'])
    assert max(rounds.values()) <= 64, rounds
    assert rounds['snake'] >= 3, rounds
