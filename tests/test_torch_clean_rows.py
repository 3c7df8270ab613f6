"""The premises of H27's and H12's designs (``kernels/objects.cu``,
``kernels/cutouts.cu``), emulated on the CPU with the constants read from
the sources.

H27 (CLEAN) visits only the valid rows: a lane folds one non-empty window
(its listed columns in order), the warp folds the windows' partials in
order, block by block, and one block merges the cleaned rows, a chunk at
a time sorted by (target, position), each target's run added in
ascending row order. The numpy float32 emulation of that schedule, fed
the wings ``ops.detect.clean_pass`` forms itself, gives its contributions
and dominant contributors bit for bit on every valid row, and its merged
outputs are ``_clean_plain``'s bit for bit, at 130, 600, 1026, 4098 and
4099 rows (partial last blocks of 130, 88, 2, 2 and 3 columns) with -0,
NaN, negative, zero and equal peaks, NaN positions and angles, and with
no valid row or one. Patched into ``detect_sources`` it gives the JAX
package's CLEAN on the wing scene (three rows merged into the star).

H12 (the triplets) is one block a candidate: three groups of 256 threads,
one a frame, each group's sum of squares in the order a block of the
earlier (candidate, frame) grid took it (the same pixels a thread, in the
same order, the same trees), the raw values staged interleaved in shared
memory and written as the candidate's contiguous floats with 16-byte
stores between scalar ends. The emulation of its staging and store maps
writes every float once, from its own pixel and frame, at every alignment
of a triplet's start; its float32 outputs are within 1e-6 of
``zuds_tpu.filterobjects.make_triplets_batch`` and of the port's plain
version, and exactly 0 on an all-zero frame (the 1e-20 floor).
"""
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zuds_tpu import filterobjects as jfilter
from zuds_tpu.ops import detect as jd
from zuds_tpu_torch.bench_detect import clean_edge_rows
from zuds_tpu_torch.ops import cutouts as tc
from zuds_tpu_torch.ops import detect as td

torch.set_num_threads(2)

KERNELS = Path(td.__file__).resolve().parent.parent / 'kernels'
F4 = np.float32


def _const(src, name):
    text = (KERNELS / src).read_text()
    return int(re.search(rf'constexpr int {name} = (\d+);', text)[1])


CLEAN_BLOCK = _const('objects.cu', 'kCleanBlock')
WIN = _const('objects.cu', 'kWin')
BLOCK_WINS = CLEAN_BLOCK // WIN
MERGE_CHUNK = _const('objects.cu', 'kMergeThreads')
CUT = _const('cutouts.cu', 'kCut')
CUT_THREADS = _const('cutouts.cu', 'kCutThreads')
PIX = CUT * CUT
TRIPLET = 3 * PIX
PER_THREAD = -(-PIX // CUT_THREADS)
STAGE = TRIPLET + int(re.search(r's_val\[kTriplet \+ (\d+)\]', (
    KERNELS / 'cutouts.cu').read_text())[1])

# ---- H27: CLEAN over the listed valid rows --------------------------------


def clean_window(r, nseg):
    """The kernel's window of row r: 16 a 512-column block, the partial
    last block's windows over its centred zero padding."""
    blk, col = divmod(r, CLEAN_BLOCK)
    m = min(CLEAN_BLOCK, nseg - blk * CLEAN_BLOCK)
    if m <= WIN:
        return blk * BLOCK_WINS
    lo = ((WIN - m % WIN) % WIN) // 2
    return blk * BLOCK_WINS + (col + lo) // WIN


def plain_wings(args):
    """The (nseg, nseg) wings as ``clean_pass`` forms them (its 512-column
    blocks, caught on their way into ``sum_last``), and its outputs."""
    x, y, a, b, theta, peak, thr, flux, npix, flags, valid = args
    blocks, real = [], td.sum_last

    def keep(c):
        blocks.append(c.numpy().copy())
        return real(c)

    td.sum_last = keep
    try:
        contrib, best_j = td.clean_pass(x, y, a, b, theta, peak, valid)
    finally:
        td.sum_last = real
    return np.concatenate(blocks, 1), contrib.numpy(), best_j.numpy()


def emulate_rows(wings, valid):
    """H27's row pass: (the listed rows, their contributions, their
    dominant contributors as rows) from the wings of the listed columns
    alone."""
    nseg = valid.shape[0]
    lst = np.flatnonzero(valid)
    nv = lst.size
    cw = wings[np.ix_(lst, lst)]
    wid = np.array([clean_window(int(r), nseg) for r in lst], int)
    opens = np.flatnonzero(np.r_[True, wid[1:] != wid[:-1]]) if nv else []
    ends = np.r_[opens[1:], nv] if nv else []
    contrib = np.zeros(nv, F4)
    best_c = np.zeros(nv, F4)
    best_q = np.full(nv, -1)
    state = None                       # the open block: id, sum, max, arg, nan

    def close(st):
        nonlocal contrib, best_c, best_q
        _, bsum, bmax, barg, bnan = st
        contrib = contrib + bsum
        take = ~bnan & (barg >= 0) & (bmax > best_c)
        best_c = np.where(take, bmax, best_c)
        best_q = np.where(take, barg, best_q)

    with np.errstate(invalid='ignore'):
        for s, e in zip(opens, ends):
            acc = np.zeros(nv, F4)
            best = np.full(nv, -np.inf, F4)
            arg = np.full(nv, -1)
            nan = np.zeros(nv, bool)
            for q in range(s, e):
                c = cw[:, q]
                isn = np.isnan(c)
                nan |= isn
                upd = ~isn & ((arg < 0) | (c > best))
                best = np.where(upd, c, best)
                arg = np.where(upd, q, arg)
                acc = acc + c
            blk = wid[s] // BLOCK_WINS
            if state is None or state[0] != blk:
                if state is not None:
                    close(state)
                state = [blk, acc, best, arg, nan]
            else:
                upd = (arg >= 0) & ((state[3] < 0) | (best > state[2]))
                state = [blk, state[1] + acc, np.where(upd, best, state[2]),
                         np.where(upd, arg, state[3]), state[4] | nan]
        if state is not None:
            close(state)
    best_j = np.where(best_q >= 0, lst[np.maximum(best_q, 0)], 0)
    return lst, contrib, best_j


def emulate_merge(lst, tgt_l, flux, npix, flags, valid, cleaned_l):
    """H27's merge: the cleaned rows in ascending order, MERGE_CHUNK list
    positions at a time, each chunk's cleaned rows in the order of their
    (target, position) keys, each target's run added in that order onto
    its sums from +0."""
    nseg = valid.shape[0]
    accf, accn = np.zeros(nseg, F4), np.zeros(nseg, F4)
    got = np.zeros(nseg, bool)
    for c0 in range(0, lst.size, MERGE_CHUNK):
        ks = np.arange(c0, min(c0 + MERGE_CHUNK, lst.size))
        ks = ks[tgt_l[ks] >= 0]
        mt, ms = tgt_l[ks], lst[ks]
        q = np.arange(mt.size)
        rank = ((mt[None, :] < mt[:, None])
                | ((mt[None, :] == mt[:, None]) & (q[None, :] < q[:, None]))
                ).sum(1)
        assert np.array_equal(np.sort(rank), q)
        st, ss = np.empty_like(mt), np.empty_like(ms)
        st[rank], ss[rank] = mt, ms
        for r, src in zip(st, ss):
            accf[r] = accf[r] + flux[src]
            accn[r] = accn[r] + npix[src]
            got[r] = True
    valid_out = valid.copy()
    valid_out[lst[cleaned_l]] = False
    return (flux + accf, npix + accn, flags | np.where(got, 2, 0).astype(
        flags.dtype), valid_out)


def emulate_clean(args, wings):
    """H27 on CLEAN's row fields (torch CPU tensors, CLEAN_FIELDS) and
    their ``wings``: the merged (flux, npix, flags, valid) and, for the
    listed rows, their contributions and dominant contributors."""
    x, y, a, b, theta, peak, thr, flux, npix, flags, valid = (
        t.numpy() for t in args)
    lst, contrib, best_j = emulate_rows(wings, valid)
    cleaned = (peak[lst] - contrib) <= thr[lst]
    tgt_l = np.where(cleaned, best_j, -1)
    out = emulate_merge(lst, tgt_l, flux, npix, flags, valid, cleaned)
    return out, lst, contrib, best_j


@pytest.mark.parametrize('nseg,nvalid', [(130, None), (600, None),
                                         (1026, None), (4098, None),
                                         (4099, None), (130, 0), (130, 1)])
def test_listed_fold_is_the_plain_clean(nseg, nvalid):
    args = tuple(torch.as_tensor(v)
                 for v in clean_edge_rows(nseg, nseg, nvalid))
    valid = args[10].numpy()
    wings, p_contrib, p_best = plain_wings(args)
    (flux, npix, flags, v_out), lst, contrib, best_j = emulate_clean(args,
                                                                    wings)
    assert lst.size == int(valid.sum())
    # every valid row's sum and dominant contributor, bit for bit
    assert np.array_equal(contrib.view('u4'), p_contrib[lst].view('u4'))
    assert np.array_equal(best_j, p_best[lst])
    pf, pn, pfl, pv = (t.numpy() for t in td._clean_plain(*args))
    assert np.array_equal(flux.view('u4'), pf.view('u4'))
    assert np.array_equal(npix.view('u4'), pn.view('u4'))
    assert np.array_equal(flags, pfl)
    assert np.array_equal(v_out, pv)
    if nvalid is None:
        # the premises hold on this data: some rows merge, some wings are
        # -0 or NaN, some valid rows are skipped between listed ones
        assert (valid & ~pv).sum() > 0
        listed = wings[np.ix_(lst, lst)]
        assert np.isnan(listed).any()
        assert (np.signbit(listed) & (listed == 0)).any()
        assert (~valid[1:-1]).any()


def test_listed_fold_matches_the_reference_on_the_wing_scene():
    """The emulation in place of H27 in ``detect_sources`` on the wing
    scene (three spikes merged into the star) against the JAX package."""
    from test_torch_detect_kernels import EXACT, _wing_scene
    diff, rms, mask, wok = _wing_scene()
    kw = dict(max_det=64, nsigma=1.5)
    calls = []

    def emulated(*args):
        calls.append(1)
        out = emulate_clean(args, plain_wings(args)[0])[0]
        return tuple(torch.as_tensor(v) for v in out)

    real = td._clean
    td._clean = emulated
    try:
        t = td.detect_sources(*(torch.as_tensor(v) for v in
                                (diff, rms, mask, wok)),
                              return_labels=False, deblend=True, **kw)
    finally:
        td._clean = real
    assert calls == [1]
    j = jd.detect_sources(jnp.asarray(diff), jnp.asarray(rms),
                          jnp.asarray(mask).astype(jnp.uint32),
                          jnp.asarray(wok), return_labels=False,
                          deblend=True, **kw)
    j = {k: np.asarray(v) for k, v in j.items()}
    t = {k: v.numpy() for k, v in t.items()}
    assert int(((t['flags'] & 2) != 0).sum()) == 1
    for k in EXACT:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    v = j['valid']
    for k in ('flux', 'peak', 'a', 'b', 'thresh'):
        np.testing.assert_allclose(t[k][v], j[k][v], rtol=1e-5, err_msg=k)


# ---- H12: one block a candidate -------------------------------------------


def thread_pixels(layout):
    """{(frame, thread of its group): the window pixels its sum of squares
    adds, in order} under the earlier (candidate, frame) grid of
    CUT_THREADS threads a block or the candidate's block of three groups."""
    out = {}
    nthreads = CUT_THREADS if layout == 'frame_blocks' else 3 * CUT_THREADS
    for f in range(3):
        for tid in range(nthreads):
            if layout == 'frame_blocks':
                frame, t = f, tid
            else:
                frame, t = divmod(tid, CUT_THREADS)
                if frame != f:
                    continue
            out[frame, t] = [i for i in (t + k * CUT_THREADS
                                         for k in range(PER_THREAD))
                             if i < PIX]
    return out


def store_map(shift):
    """The block's stores at a triplet start ``shift`` floats past a
    16-byte boundary: [(float e, staged index read, frame of the norm)]
    in the order of the head, the 16-byte stores and the tail."""
    head = (4 - shift) & 3
    nvec = (TRIPLET - head) // 4
    tail = head + 4 * nvec
    writes = [(e, shift + e, e % 3) for e in range(head)]
    for q in range(nvec):
        e = head + 4 * q
        assert (shift + e) % 4 == 0           # an aligned float4 both ways
        f0 = e % 3
        frames = (f0, 0 if f0 == 2 else f0 + 1, 2 if f0 == 0 else f0 - 1, f0)
        writes += [(e + u, shift + e + u, frames[u]) for u in range(4)]
    writes += [(e, shift + e, e % 3) for e in range(tail, TRIPLET)]
    return writes


def window_norms(win):
    """(N, 3) f32 norms of (N, 3, PIX) windows in H12's order: a thread's
    fmaf over its pixels (a product and sum in float64 rounded once),
    each warp's xor tree, one warp's xor tree over the eight partials,
    sqrt(max(s, 1e-20))."""
    n = win.shape[0]
    acc = np.zeros((n, 3, CUT_THREADS), F4)
    for t, pixels in thread_pixels('groups').items():
        f, th = t
        for i in pixels:
            v = win[:, f, i].astype('f8')
            acc[:, f, th] = (v * v + acc[:, f, th]).astype(F4)
    lane = np.arange(32)

    def xor_tree(w):
        for o in (16, 8, 4, 2, 1):
            w = w + w[..., lane ^ o]
        return w

    part = xor_tree(acc.reshape(n, 3, CUT_THREADS // 32, 32))[..., 0]
    s = np.zeros((n, 3, 32), F4)
    s[..., :CUT_THREADS // 32] = part
    return np.sqrt(np.maximum(xor_tree(s)[..., 0], F4(1e-20)))


def emulate_triplets(frames, x0, y0, base=0):
    """H12's (N, 63, 63, 3) output: the windows staged at 3 i + f after
    the start's shift, the norms, the store map of each candidate's start
    (candidate n starts ``base + n * TRIPLET`` floats into an allocation)."""
    n = len(x0)
    win = np.stack([np.stack([f[y:y + CUT, x:x + CUT].reshape(-1)
                              for f in frames]) for x, y in zip(x0, y0)])
    norm = window_norms(win)
    out = np.zeros((n, TRIPLET), F4)
    for c in range(n):
        shift = (base + c * TRIPLET) % 4
        stage = np.zeros(STAGE, F4)
        for f in range(3):
            stage[shift + 3 * np.arange(PIX) + f] = win[c, f]
        e, src, f = np.array(store_map(shift)).T
        out[c, e] = stage[src] / norm[c, f]
    return out.reshape(n, CUT, CUT, 3)


def test_triplet_sums_keep_the_per_frame_blocks_order():
    assert thread_pixels('groups') == thread_pixels('frame_blocks')


@pytest.mark.parametrize('shift', [0, 1, 2, 3])
def test_triplet_store_map_writes_each_float_once(shift):
    writes = store_map(shift)
    es = [e for e, _, _ in writes]
    assert sorted(es) == list(range(TRIPLET))
    assert all(src == shift + e and f == e % 3 for e, src, f in writes)
    # the staging map fills [shift, shift + TRIPLET) of the buffer
    staged = sorted(shift + 3 * i + f for i in range(PIX) for f in range(3))
    assert staged == list(range(shift, shift + TRIPLET))
    assert shift + TRIPLET <= STAGE


def _frames_and_corners(H=200, W=180, n=12, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    xs = np.r_[rng.uniform(-3, W + 2, n - 4), 0.4, W - 0.2, 50.7, 90.1]
    ys = np.r_[rng.uniform(-3, H + 2, n - 4), 0.6, H - 1.3, H + 1.0, -2.0]
    frames = []
    for k in range(3):
        img = rng.normal(0, 5.0, (H, W)) + (150.0 if k < 2 else 0.0)
        for x, y in zip(xs, ys):
            img += 3000.0 * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 4.0)
        frames.append(img.astype(F4))
    x0, y0 = tc.clamped_corners(torch.as_tensor(xs.astype(F4)),
                                torch.as_tensor(ys.astype(F4)), CUT, H, W)
    return frames, xs, ys, x0.numpy(), y0.numpy()


def test_triplet_emulation_matches_the_reference():
    frames, xs, ys, x0, y0 = _frames_and_corners()
    assert {0, frames[0].shape[1] - CUT} <= set(x0.tolist())
    assert {0, frames[0].shape[0] - CUT} <= set(y0.tolist())
    got = emulate_triplets(frames, x0, y0, base=1)
    want = jfilter.make_triplets_batch(
        xs, ys, *(SimpleNamespace(data=f) for f in frames))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    plain = tc.triplet_cut_plain(*(torch.as_tensor(f) for f in frames),
                                 torch.as_tensor(x0), torch.as_tensor(y0))
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-6, atol=1e-12)
    zero = np.zeros_like(frames[0])
    assert not emulate_triplets([zero] * 3, x0[:4], y0[:4]).any()
