"""The schedules of hand kernels H5 (``kernels/deblend.cu``, the deblend
tree's level labels) and H25 (``kernels/ccl.cu``, the base components'
union-find), emulated in numpy at the kernels' own index arithmetic on the
CPU, held bit for bit to their plain versions and to the JAX package.

H5, per level: the live slots ``[0, min(nedge, ecap))`` read once in
chunks of 32 dealt to the warps in turn (the block's width and the
unroll read from the source), the warps' steps interleaved in a seeded
order (the shared counter's race), an edge that repeats its warp's
previous live edge or the last edge kept from its source (as it stood
before the warp's group of chunks) dropped, the rest packed as two 16-bit
cells and appended, a group of chunks at once, up to the block's shared
capacity (from the source's budget, and smaller capacities so that the
re-read of each warp's remainder from global memory runs), the level's
sources listed in a seeded order; then
the rounds: the copy, the hooks of the stored and the remaining edges,
three synchronous jumps over the sources, at most ``max_rounds`` rounds,
the level stopping at the first round that lowers no label. Held to
``level_labels_plain`` on the 256^2 busy blend field's cell graph (the
recipe of tests/test_detect.py) and on seeded directed graphs, at 1, 6
and 40 rounds, one graph with every slot live at level 0, and slots past
``nedge`` padded as ``cell_graph`` pads them.

H25: ``parent = lab0`` (followed a few steps down the seed pointers),
each undirected edge united once from its larger
end (``okb`` rows 0-3) where the scan mask keeps it (the up neighbour
alone where there is one), an edge whose ends share their ``lab0``
skipped, the entries in a seeded order, each entry's root. Held to
``label_compact_plain`` and, through ``detect_sources(deblend=False)``
and ``label_components`` with the emulation in place of
``label_compact``, to the JAX package's labels: the snake, the busy
scene, scenes whose last pixel is detected (isolated, and joined to its
neighbours) with padding in the list, from the seeds and from the
identity, and the same at overflow. The forward half (rows 4-7) labels
the joined last pixel apart from its neighbours from the identity: the
test guards the kernel's choice of half.
"""
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu.ops import detect as jd
from zuds_tpu_torch.bench_detect import blend_field, corner_mask
from zuds_tpu_torch.ops import deblend as tdb
from zuds_tpu_torch.ops import detect as td

torch.set_num_threads(2)

SRC = (Path(__file__).resolve().parent.parent / 'zuds_tpu_torch'
       / 'kernels' / 'deblend.cu').read_text()
THREADS = int(re.search(r'kThreads = (\d+);', SRC)[1])
UNROLL = int(re.search(r'kUnroll = (\d+);', SRC)[1])
_m = re.search(r'kMaxDynSmem = (\d+) - (\d+);', SRC)
MAX_DYN_SMEM = int(_m[1]) - int(_m[2])
MAX_CELLS = int(re.search(r'kMaxCells = (\d+);', SRC)[1])
HOPS = int(re.search(r'kInitHops = (\d+);', (
    Path(__file__).resolve().parent.parent / 'zuds_tpu_torch' / 'kernels'
    / 'ccl.cu').read_text())[1])
NONE = 0xFFFFFFFF


def T(a):
    return torch.as_tensor(np.array(a))


def shared_capacity(ccap, ecap):
    """deblend.cu's edge slots in shared memory: the budget less the hook
    target (int32), the labels and the source list (uint16 each) and a
    flag byte a cell (in whole words)."""
    fixed = 4 * ccap + 2 * ccap + 2 * ccap + 4 * ((ccap + 3) // 4)
    return min(ecap, (MAX_DYN_SMEM - fixed) // 4)


def _h5_level(lev, src, dst, w, n, ccap, rounds, cap_e, rng, dedupe,
              warps, info):
    """One block of H5: the compaction, then the rounds."""
    a = np.arange(ccap)
    b = np.arange(ccap)
    kept_dst = np.full(ccap, 0xFFFF)      # the list buffer before the list
    is_src = np.zeros(ccap, bool)
    edges = np.zeros(max(cap_e, 1), np.uint32)
    nfill = 0
    nchunks = -(-n // 32)
    # a warp's chunks in its order: warp, warp + warps, ... (kUnroll of
    # them loaded at once, taken in the same order)
    todo = [list(range(wp, nchunks, warps)) for wp in range(warps)]
    stop = [n] * warps
    last = [NONE] * warps
    lanes = np.arange(32)
    while any(todo):
        wp = rng.choice([i for i, t in enumerate(todo) if t])
        take, todo[wp] = todo[wp][:UNROLL], todo[wp][UNROLL:]
        group = []                 # (chunk, packed, keep, cells) per chunk
        for k in take:
            e = k * 32 + lanes
            ok = e < n
            ec = np.where(ok, e, 0)
            live = ok & (lev < w[ec])
            packed = (src[ec].astype(np.uint32) << 16) | dst[ec]
            # each lane's previous live lane (-1: none in this chunk)
            prior = np.r_[-1, np.maximum.accumulate(
                np.where(live, lanes, -1))[:-1]]
            prev = np.where(prior >= 0, packed[prior], last[wp])
            if live.any():
                last[wp] = packed[np.flatnonzero(live)[-1]]
            keep = live & (packed != prev) if dedupe else live
            group.append((k, packed, keep, src[ec], dst[ec]))
        if dedupe:
            # the sources' last kept edges as they stood before the group
            group = [(k, p, keep & (kept_dst[s_] != d_), s_, d_)
                     for k, p, keep, s_, d_ in group]
            for _, _, keep, s_, d_ in group:
                kept_dst[s_[keep]] = d_[keep]
        for _, _, keep, s_, _ in group:
            is_src[s_[keep]] = True
        total = sum(int(keep.sum()) for _, _, keep, _, _ in group)
        if total == 0 or stop[wp] < n:
            continue
        base = nfill
        nfill += total
        for k, packed, keep, _, _ in group:
            rank = base + np.cumsum(keep) - keep
            put = keep & (rank < cap_e)
            edges[rank[put]] = packed[put]
            if stop[wp] == n and keep.any() and \
                    base + int(keep.sum()) > cap_e:
                miss = keep & (rank == max(cap_e, base))
                stop[wp] = k * 32 + int(np.flatnonzero(miss)[0])
            base += int(keep.sum())
    nsh = min(nfill, cap_e)
    # each warp's slots from its stop point on, re-read in every round
    rest = np.array([e for wp in range(warps) if stop[wp] < n
                     for k in range(stop[wp] // 32, nchunks, warps)
                     for e in range(k * 32, k * 32 + 32)
                     if stop[wp] <= e < n], dtype=np.int64)
    rest = rest[lev < w[rest]] if len(rest) else rest
    info['stored'] = max(info.get('stored', 0), nsh)
    info['remainder'] = max(info.get('remainder', 0), len(rest))
    hs = np.r_[edges[:nsh] >> 16, src[rest]].astype(np.int64)
    hd = np.r_[edges[:nsh] & 0xFFFF, dst[rest]].astype(np.int64)
    srcs = rng.permutation(np.flatnonzero(is_src))     # the list's order
    ran = 0
    for r in range(rounds):
        if r > 0:
            b[srcs] = a[srcs]
        old = b.copy()
        np.minimum.at(b, hs, a[hd])                   # the atomicMin hooks
        changed = bool((b < old).any())
        for s_, d_ in ((b, a), (a, b), (b, a)):
            x = s_[srcs]
            y = s_[x]
            d_[srcs] = np.minimum(x, y)
            changed |= bool((y < x).any())
        ran += 1
        if not changed:
            break
    info['rounds'] = max(info.get('rounds', 0), ran)
    return a


def h5_emulate(src, dst, w, ccap, L, max_rounds, nedge=None, cap_e=None,
               seed=0, dedupe=True, threads=THREADS, info=None):
    """H5's (L, ccap) labels as deblend.cu forms them."""
    src, dst, w = (np.asarray(v, np.int64) for v in (src, dst, w))
    ecap = len(src)
    assert 0 < ccap <= MAX_CELLS
    n = ecap if nedge is None else min(max(int(nedge), 0), ecap)
    cap_e = shared_capacity(ccap, ecap) if cap_e is None else cap_e
    rng = np.random.default_rng(seed)
    info = {} if info is None else info
    return np.stack([_h5_level(lev, src, dst, w, n, ccap, max(max_rounds, 1),
                               cap_e, rng, dedupe, threads // 32, info)
                     for lev in range(L)]).astype(np.int32)


def _scene_busy():
    """tests/test_detect.py's busy blend field at 256^2."""
    return blend_field(256, 256, 120)


@pytest.fixture(scope='module')
def busy_graph():
    img = T(_scene_busy())
    load = td.deblend_load(img, torch.full_like(img, 5.0), nsigma=5.0,
                           max_det=256)
    g = load['graph']
    assert int(g['nedge']) < g['e_src'].numel()
    return g


def _random_graph(seed, ccap, ecap, L, nchain, chain_len, lo=0):
    """Random directed edges with weights in [lo, L], and two-way chains
    whose cells run down from near ccap with the smallest cell at one end
    (label 0 crawls a cell a round: the round cap decides)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, ccap, ecap)
    dst = rng.integers(0, ccap, ecap)
    w = rng.integers(lo, L + 1, ecap)
    k = 0
    for c in range(nchain):
        cells = np.r_[c, ccap - 1 - c * chain_len - np.arange(chain_len)]
        for a, b in zip(cells[:-1], cells[1:]):
            src[k:k + 2], dst[k:k + 2], w[k:k + 2] = (a, b), (b, a), L
            k += 2
    # runs of one edge repeated, as a cell boundary gives them
    for s0 in range(0, ecap - 8, 97):
        src[s0:s0 + 5], dst[s0:s0 + 5] = src[s0], dst[s0]
    return src, dst, w


def test_shared_capacity_holds_the_slice_level_zero():
    """The block's edge slots at the reference's 8192 cells: a slice
    frame's level 0 (~28.3k edges) fits whole, the 65,536-slot list does
    not."""
    cap = shared_capacity(MAX_CELLS, 1 << 16)
    assert 28300 < cap < 1 << 16
    assert MAX_CELLS <= 1 << 16 and THREADS % 32 == 0


@pytest.mark.parametrize('cap_e,rounds', [
    (None, 1), (None, 6), (None, 40), (40, 1), (40, 6), (0, 6)])
def test_h5_schedule_on_the_busy_cell_graph(busy_graph, rounds, cap_e):
    g = busy_graph
    L, ccap = g['L'], g['ccap']
    want = tdb.level_labels_plain(g['e_src'], g['e_dst'], g['e_w'], ccap, L,
                                  rounds).numpy()
    info = {}
    got = h5_emulate(g['e_src'].numpy(), g['e_dst'].numpy(),
                     g['e_w'].numpy(), ccap, L, rounds, nedge=g['nedge'],
                     cap_e=cap_e, seed=rounds, info=info)
    np.testing.assert_array_equal(got, want)
    assert (info['remainder'] > 0) == (cap_e is not None)
    if rounds == 1:
        # the dedupe finds the runs of one cell boundary
        dd = h5_emulate(g['e_src'].numpy(), g['e_dst'].numpy(),
                        g['e_w'].numpy(), ccap, L, 1, nedge=g['nedge'],
                        dedupe=False, info=(raw := {}))
        np.testing.assert_array_equal(dd, want)
        if cap_e is None:
            assert info['stored'] < raw['stored'] / 4


@pytest.mark.parametrize('rounds', [1, 6, 40])
@pytest.mark.parametrize('ccap,ecap,cap_e', [(700, 3000, None),
                                             (700, 3000, 257),
                                             (MAX_CELLS, 4096, 1000)])
def test_h5_schedule_on_directed_graphs(rounds, ccap, ecap, cap_e):
    L = 31
    src, dst, w = _random_graph(ccap + ecap + rounds, ccap, ecap, L,
                                min(8, ecap // 200), 25)
    want = tdb.level_labels_plain(T(src), T(dst), T(w), ccap, L,
                                  rounds).numpy()
    info = {}
    got = h5_emulate(src, dst, w, ccap, L, rounds, cap_e=cap_e, seed=rounds,
                     info=info)
    np.testing.assert_array_equal(got, want)
    if rounds == 40:
        assert info['rounds'] > 6           # the chains outlast the cap
    # a level's edges are directed: with the reverses added the labels
    # differ, so no edge may be dropped as the reverse of another
    if rounds == 6 and cap_e is None:
        both = tdb.level_labels_plain(T(np.r_[src, dst]), T(np.r_[dst, src]),
                                      T(np.r_[w, w]), ccap, L, 6).numpy()
        assert not np.array_equal(both, want)


@pytest.mark.parametrize('rounds', [1, 6])
def test_h5_schedule_every_slot_live_at_level_zero(rounds):
    """Every slot live at level 0 (weights 1..L), past a capacity below
    the slot count: the remainder is re-read in every round."""
    ccap, ecap, L = 2048, 6144, 31
    src, dst, w = _random_graph(7, ccap, ecap, L, 6, 20, lo=1)
    assert (w >= 1).all()
    want = tdb.level_labels_plain(T(src), T(dst), T(w), ccap, L,
                                  rounds).numpy()
    info = {}
    got = h5_emulate(src, dst, w, ccap, L, rounds, cap_e=2000, seed=3,
                     info=info)
    np.testing.assert_array_equal(got, want)
    assert info['stored'] == 2000 and info['remainder'] > 3000


@pytest.mark.parametrize('nedge', [0, 1, 1500, 2999])
def test_h5_schedule_reads_only_the_live_count(nedge):
    """Slots past ``nedge`` padded as cell_graph pads them (e_w = 0, cell
    ccap - 1): reading only [0, nedge) gives the labels of all slots."""
    ccap, ecap, L = 900, 3000, 31
    src, dst, w = _random_graph(nedge, ccap, ecap, L, 4, 20)
    src[nedge:] = dst[nedge:] = ccap - 1
    w[nedge:] = 0
    want = tdb.level_labels_plain(T(src), T(dst), T(w), ccap, L, 6).numpy()
    for cap_e in (None, 200):
        got = h5_emulate(src, dst, w, ccap, L, 6, nedge=nedge, cap_e=cap_e)
        np.testing.assert_array_equal(got, want)


# ---- H25 ----------------------------------------------------------------

def h25_emulate(nbr_pos, okb, lab0, rows=range(4), mask=True, skip=True,
                seed=0, hops=HOPS):
    """H25's labels as ccl.cu forms them: parent = lab0 followed down
    the seed pointers for up to ``hops`` steps (a seed that points up is
    united instead); per entry, in a seeded order, the edges
    of ``rows`` that the scan mask keeps (``mask``: with the up neighbour,
    row 1 alone; else rows 2 and 3, or 2 and 0 without a left one), an
    edge whose ends share a lab0 skipped; each entry's root."""
    nbr, ok = np.asarray(nbr_pos), np.asarray(okb)
    lab = np.asarray(lab0).astype(np.int64)
    n = len(lab)
    parent = np.arange(n)
    for i in range(n):
        p, li = i, lab[i]
        for _ in range(hops):
            if li < 0 or li >= p:
                break
            p, li = li, lab[li]
        parent[i] = p

    def root(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]       # path halving
            x = parent[x]
        return x

    def unite(x, y):
        rx, ry = root(x), root(y)
        if rx != ry:
            lo, hi = min(rx, ry), max(rx, ry)
            parent[hi] = lo

    for i in np.random.default_rng(seed).permutation(n):
        li = lab[i]
        if i < li < n:
            unite(i, li)
        use = [k for k in rows if ok[k, i]]
        if mask:
            use = [1] if 1 in use else \
                [k for k in use if k in (2, 3) or (k == 0 and 3 not in use)]
        for k in use:
            j = nbr[k, i]
            if j < 0 or j >= n or j == i:
                continue
            if skip and 0 <= li < n and lab[j] == li:
                continue
            unite(i, j)
    return T(np.array([root(i) for i in range(n)]))


def _snake():
    rng = np.random.default_rng(3)
    det = rng.random((96, 96)) < 0.45
    det[10, 5:90] = True
    det[10:80, 89] = True
    det[79, 20:90] = True
    return det


def _detect_scene(det):
    """A frame whose detection mask is ``det``: flat 1000 counts, rms 1,
    the pixels off ``det`` weighted out (so they are not good, their image
    is 0 and every pixel of ``det`` passes the filtered threshold)."""
    H, W = det.shape
    rng = np.random.default_rng(int(det.sum()))
    diff = (1000.0 + rng.uniform(0, 50, (H, W))).astype('f4')
    return (diff, np.ones((H, W), 'f4'), np.zeros((H, W), 'i4'),
            det.copy())


def _dense_corner(joined, seed=9):
    """corner_mask with more blobs: its list overflows CORNER_CAP."""
    det = corner_mask(joined) | (np.random.default_rng(seed).random(
        (64, 80)) < 0.35)
    det[-3:, -3:] = joined
    det[-1, -1] = True
    det[:2, :] = False
    return det


CORNER = {'isolated': corner_mask(False), 'joined': corner_mask(True)}
DENSE = {'isolated': _dense_corner(False), 'joined': _dense_corner(True)}
# one capacity (one JAX compile): CORNER's lists are padded, DENSE's
# overflow
CORNER_CAP = 2048
# (scene, whether the list overflows)
CORNER_CASES = [(name, over) for over in (False, True) for name in CORNER]


def _ccl_taps(det, det_cap):
    scene = [T(a) for a in _detect_scene(det)]
    return td.detect_taps(*scene, nsigma=5.0, max_det=64, deblend=False,
                          det_cap=det_cap)['ccl']


@pytest.mark.parametrize('name,over', CORNER_CASES)
def test_h25_on_a_detected_last_pixel(name, over):
    det = (DENSE if over else CORNER)[name]
    H, W = det.shape
    nbr_pos, okb, lab0 = _ccl_taps(det, CORNER_CAP)
    n = lab0.numel()
    ndet = int(det.sum())
    padded = ndet < n
    assert padded != over
    if padded:
        # the last pixel is in the list and no neighbour's edge reaches it
        p = ndet - 1
        pok = torch.arange(n) < ndet
        assert bool(pok[p]) and not bool((okb & (nbr_pos == p)).any())
        assert bool(okb[:4, p].any()) == (name == 'joined')
        if name == 'isolated':
            assert int(lab0[p]) == 0        # its own seed maps to entry 0
    for lab in (lab0, torch.arange(n)):
        want = td.label_compact_plain(nbr_pos, okb, lab)
        for seed in (0, 1):
            assert torch.equal(h25_emulate(nbr_pos, okb, lab, seed=seed),
                               want)
        assert torch.equal(h25_emulate(nbr_pos, okb, lab, mask=False), want)
        assert torch.equal(h25_emulate(nbr_pos, okb, lab, hops=1), want)
    if padded and name == 'joined':
        # the forward half leaves the last pixel apart from the identity
        ident = torch.arange(n)
        fwd = h25_emulate(nbr_pos, okb, ident, rows=range(4, 8),
                          mask=False)
        want = td.label_compact_plain(nbr_pos, okb, ident)
        assert int(fwd[ndet - 1]) == ndet - 1 != int(want[ndet - 1])


def _jax_detect(scene, kw):
    diff, rms, mask, wok = scene
    out = jd.detect_sources(jnp.asarray(diff), jnp.asarray(rms),
                            jnp.asarray(mask).astype(jnp.uint32),
                            jnp.asarray(wok), deblend=False, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize('name,over', CORNER_CASES)
def test_h25_detect_labels_match_the_reference(monkeypatch, name, over):
    """detect_sources(deblend=False) with the emulation as its base
    components against the JAX package's, on the CPU."""
    scene = _detect_scene((DENSE if over else CORNER)[name])
    kw = dict(nsigma=5.0, max_det=256, det_cap=CORNER_CAP)
    calls = []

    def emulated(nbr_pos, okb, lab):
        calls.append(lab.numel())
        return h25_emulate(nbr_pos, okb, lab)
    monkeypatch.setattr(td, 'label_compact', emulated)
    t = td.detect_sources(*(T(a) for a in scene), deblend=False, **kw)
    assert len(calls) == 1
    j = _jax_detect(scene, kw)
    assert int(j['n']) > 1
    for k in ('labels', 'n', 'valid', 'npix', 'xmin', 'xmax', 'ymin',
              'ymax', 'pix_overflow', 'obj_overflow'):
        np.testing.assert_array_equal(t[k].numpy(), j[k], err_msg=k)


@pytest.mark.parametrize('scene', ['snake', 'busy'])
def test_h25_snake_matches_label_components(monkeypatch, scene):
    """The snake, and the busy scene's 5-sigma mask, from the identity
    (label_components' lab0 is the seeds; its compact graph from the
    identity too), against label_compact_plain and the JAX package's
    label_components."""
    det = _snake() if scene == 'snake' else _scene_busy() > 25.0
    H, W = det.shape
    flat = np.flatnonzero(det.ravel())
    inv = torch.full((H * W,), -1, dtype=torch.int64)
    inv[T(flat)] = torch.arange(len(flat))
    pok = torch.ones(len(flat), dtype=torch.bool)
    nbr_pos, nbr_ok = td._adjacency(T(flat), pok, inv, (H, W))
    ident = torch.arange(len(flat))
    assert td.label_compact_rounds(nbr_pos, nbr_ok, ident) >= 3
    assert torch.equal(h25_emulate(nbr_pos, nbr_ok, ident),
                       td.label_compact_plain(nbr_pos, nbr_ok, ident))
    monkeypatch.setattr(td, 'label_compact',
                        lambda *a: h25_emulate(*a, seed=5))
    want = np.asarray(jd.label_components(jnp.asarray(det), max_rounds=200))
    np.testing.assert_array_equal(td.label_components(T(det)).numpy(), want)


def test_h25_mask_and_skip_leave_few_unions_on_the_busy_scene():
    """On the busy scene the scan mask and the lab0 skip leave under a
    third of the backward edges to unite; the emulation without either
    gives the same labels."""
    img = T(_scene_busy())
    nbr_pos, okb, lab0 = td.detect_taps(img, torch.full_like(img, 5.0),
                                        nsigma=5.0, max_det=256,
                                        deblend=False)['ccl']
    back = okb[:4]
    use = back.clone()
    use[[0, 2, 3]] &= ~back[1]
    use[0] &= ~back[3]
    united = use & (lab0[nbr_pos[:4]] != lab0[None])
    assert int(back.sum()) > 1000
    assert int(united.sum()) < int(back.sum()) / 3
    want = td.label_compact_plain(nbr_pos, okb, lab0)
    assert torch.equal(h25_emulate(nbr_pos, okb, lab0), want)
    assert torch.equal(h25_emulate(nbr_pos, okb, lab0, mask=False,
                                   skip=False, hops=1), want)
    assert torch.equal(h25_emulate(nbr_pos, okb, lab0, hops=30), want)
