"""H5, H25, H23, H26, H24, H22, H27, H12, H14, H18, H17 and H16
(``kernels/deblend.cu``, ``kernels/ccl.cu``, ``kernels/measure.cu``,
``kernels/objects.cu``, ``kernels/photometry.cu``, ``kernels/cutouts.cu``,
``kernels/zogy.cu``): the deblend tree's level labels, the base
components' union-find, the windowed and Kron refinement, the per-object
statistics, the label seeds, the aperture photometry, CLEAN, the braai
triplets, the negative-pixel veto, the ZOGY PSF's clipped mean, its star
stamps and the ZOGY score's normalisation, timed at the main path's
shapes and at the shapes the other paths give them.

    python3 zuds_tpu_torch/bench_detect.py [--root DIR] [--tag NAME]
        [--out FILE] [--cases h5,h25,h23,h26,h24,h22,h27,h12,h14,h18,h17,h16]
        [--phot FILE]

``--root`` is the checkout whose ``zuds_tpu_torch`` is imported (by
default the one this file sits in), so that two versions of the kernels
are timed by one script on one card: unpack the other version into a
directory and run the script once against each, in turns. ``--out``
appends the JSON lines to a file as well; ``--cases`` keeps the groups of
cases (``h5``, ``h25``, ``h23``, ``h26``, ``h24``, ``h22``, ``h27``,
``h12``, ``h14``, ``h18``, ``h17``, ``h16``) that start with one of its
prefixes, and builds and reports only their sources.
``--phot`` names the frames and positions ``chip_smoke.py`` saves where
``ZUDS_PHOT_INPUTS`` points (its forced-photometry phase: dophot's 4096
positions on a flagship subtraction), for the case ``h22_forced``.

The inputs: the slice's flagship frame 0 (``inputs.synth_inputs`` seed 0
with three planted sources through ``SubtractDetectPipeline`` at
``night.FLAGSHIP``), its diff and rms, its ``max_det`` detection rows and
``detect.detect_taps``' arguments; a 3080x3072 field of 600 seeded stars
(``bench_warp.star_field``) about its sky of 150 counts, rms 5, whose
valid detections stand for a pair catalog's rows (the pair path measures
only the valid rows); ``chip_smoke.py``'s busy blend field
(:func:`blend_field`, 620 stars). Cases:

- ``h5_slice``, ``h5_blend``: H5 on the tree's own edge list
  (``detect.deblend_load``) of the slice's frame 0 and of the blend field;
  ``h5_full``: on 65,536 seeded edges over 8192 cells, every slot live at
  level 0 (past the shared memory a block holds). Each bit-equal to
  ``level_labels_plain`` at 6 rounds, two calls bit-identical;
  ``graph_ms`` of ``launch.deblend_labels`` alone and ``level_ms`` of
  ``deblend.level_labels`` (the parent's int32 casts included); the
  rounds the levels take (``rounds``: per level, the first round that
  changes nothing, at most 6), the live edges, distinct pairs and sources
  of level 0. ``probes``: the same call at one round (``rounds1``), with
  every edge dead (``dead``: the read of the slots, one round), with no
  slot (``empty``: one round of barriers), and the probe builds below.
- ``h25_slice``: H25 on the slice's frame 0 (``detect_taps``' ``ccl``,
  65,536 entries), bit-equal to ``label_compact_plain``, two calls
  bit-identical; its launches' device times by name from
  ``torch.profiler`` over 20 calls (``split_us``); the edges and those
  whose ends share a seed; ``probes``: the checkout's kernel given the
  backward half of ``okb`` alone (``backward_input``) and the edges whose
  ends differ in ``lab0`` alone (``skip_input``), both still the same
  labels.
- ``h23_slice``: H23 on the slice's 4096 rows (~57 detections, the rest
  the empty rows' fills); ``h23_pairlike``: on the star field's valid
  rows; ``h23_distinct``: on 4096 seeded positions over the slice's
  science frame (sky, stars, noise) with seeded shapes (every row
  distinct). Each checked against the plain version
  (``kernels.checks.refine_check``), two calls bit-identical;
  ``distinct`` counts the rows with distinct inputs, ``sha256`` hashes the
  outputs (equal between two checkouts whose kernels give the same bits).
  ``h23_distinct_diff``: the same rows over the slice's diff, where most
  windows hold noise alone about 0 (its check printed, not gated).
- ``h26_slice``: H26 on the slice's frame 0 (``detect_taps``, 65,536
  entries, 4098 rows), checked by ``kernels.checks.stats_check``; its
  launches' device times by name from ``torch.profiler`` over 20 calls
  (``split_us``).
- ``h24_slice``: H24 on the slice's frame 0 (its detection mask at
  ``det_cap``, the compact list and count); ``h24_blend``: on the blend
  field; ``h24_overflow``: on frame 0's mask with its last pixel detected
  under a cap of half its detected pixels. Each bit-equal to the plain
  full-frame seeds (:func:`seed_frame`) at the listed entries and +inf
  past them, two calls bit-identical, with the live 32x32 tiles counted
  and a sha256 of the seeds. A checkout whose H24 writes the full frame
  (the parent of the listed form) is timed as its callers reach the same
  seeds: the kernel and the gather at the list (``frame_ms`` the kernel
  alone).
- ``h22_slice_r3``, ``h22_slice_r6``: H22 at the slice's 4096 rows at
  r = 3 (diff, rms, submask) and r = 6 (rms and the bad-pixel plane);
  ``h22_distinct``, ``h22_distinct_r6``: at 4096 seeded positions over the
  science frame (every row distinct); ``h22_pairlike``: at the star
  field's valid rows, no mask; ``h22_forced`` (with ``--phot``): dophot's
  positions. Each checked against the plain version
  (``kernels.checks.aperture_check`` at r = 3, the sums within the bound
  of two orders at r = 6), two calls bit-identical, ``distinct`` counting
  the distinct positions and ``sha256`` hashing the outputs (equal between
  two checkouts whose kernels give the same bits).
- ``h27_slice``, ``h27_blend``: H27 on CLEAN's row fields of the slice's
  frame 0 and of the blend field (``detect_taps``' ``clean``);
  ``h27_rows4098``, ``h27_rows50000``: on :func:`clean_rows` (the card
  test's seeded rows, about 80% valid, close together: crowded). Each
  checked against the plain version (``kernels.checks.clean_check``), two
  calls bit-identical, ``sha256`` hashing flux, npix, flags, valid,
  contrib and tgt (equal between two checkouts whose kernels give the
  same bits), the valid and cleaned rows counted.
- ``h12_n256``, ``h12_n2048``: H12 at 256 and 2048 seeded candidates
  (:func:`scoring_corners`, chip_smoke.py's ``scoring_positions``) on the
  night's frame 0, its reference and their difference (written by
  ``inputs.write_night_pairs`` as chip_smoke.py writes them), within
  rtol 1e-6 of the plain version, two calls bit-identical, ``sha256``
  hashing the triplets.
- ``h18_zogy``, ``h18_s300``: H18 on H17's stamps of the night's first
  pair (``zogy_frames``: the science frame less its background at
  ``_select_stamps(sci, 64)``) and on 300 seeded stamps, within 1e-7 of the
  plain version, ``good`` equal, 0-3 passes timed.
- ``h17_zogy``, ``h17_zogy_ref``: H17 at those 64 positions on the
  science frame and on the reference aligned to it (its sky pedestal
  kept); ``h17_zogy_n24``, ``h17_zogy_n32``: the science frame at sizes
  24 and 32; ``h17_s300``: 300 seeded stars on a 3080x3072 sky of 150
  counts (:func:`stamp_field`, four corners clamped). Each against the
  plain version (the good stamps within 1e-7, ``good0`` equal), two calls
  bit-identical, ``sha256`` of the stamps and flags, ``issued_flop``
  (:func:`stamp_flop`) and its time at the fp64 peak.
- ``h16_zogy``: H16 on that pair's ``p_d`` and ``s`` at 3080x3072 (its
  PSFs, H15 and cuFFT's inverses); ``h16_250x197``: seeded planes of that
  shape (n % 4 = 2); ``h16_zogy_offset``: ``p_d`` as a view 4 bytes past
  a 16-byte boundary (the single-float path). Each within 1e-6 relative
  of the plain version, two calls bit-identical, ``sha256``, the device
  activities of one call by name (``events``, from torch.profiler: no
  memset), ``norm_ms`` (``torch.linalg.vector_norm(p_d)`` for scale).
- ``empty``: an empty kernel (one block of 32 threads) under the same
  CUDA graph: the launch floor of a graph's launch.

Probe builds, where the checkout's source has their macros (a probe's
result is not the function's): H5 with no edge read and every round's
barriers run (``-DZUDS_DEBLEND_PROBE_NO_EDGES``: the floor of six
rounds), every level through all six rounds
(``-DZUDS_DEBLEND_PROBE_NO_EXIT``, the same labels), and so without the
hooks (``first_hooks``: ``-DZUDS_DEBLEND_PROBE_FIRST_HOOKS``) and the
jumps too (``first_round``: ``-DZUDS_DEBLEND_PROBE_FIRST_JUMPS``) after
round 1, which price a round's parts; H23 at
other block widths (``-DZUDS_REFINE_THREADS=128/256/512/1024``), H26
stopped after its first one, two and three launches
(``-DZUDS_STATS_PROBE_STOP``) and with a row pass that only sums the whole
windows (``-DZUDS_STATS_PROBE_ROWS=1``). H18 is also timed at 0-3 passes
(``iters_ms``: a pass's cost).

Each prints one JSON line: ``graph_ms`` (device time per call, 20 calls
captured in one CUDA graph and replayed between two CUDA events),
``call_ms`` (CUDA events around 20 calls back to back, the host's cost
included), ``bound_ms`` and ``bound_by`` (H5: 24 B a live slot and
4 B a label written, one edge test a live slot and three jumps a cell and
level; H25: 52 B an entry, rows 0-3 of the positions and edges, lab0 and
the label, 4 operations a valid backward edge; H23: the bytes of
the distinct work, each distinct row's two 33x33 windows, every row's
24 B of inputs and 44 B of outputs, over 3.35 TB/s, and its ~135
operations a window pixel over 67 TFLOP/s fp32, ``all_rows_bound_ms`` the
same for every row; H26: 30 B an entry and 81 B a row, 25 operations an
entry and 40 a row; H24: the mask's 1 B a pixel, 8 + 4 B a listed entry
and 4 B a padded one, 9 operations a detected pixel a sweep; H22: the
distinct rows' windows, every row's position and outputs, the distinct
rows' corner grids by :func:`aperture_ops`; H27: 60 B a row, 3 operations
a pair of valid rows and 14 more a brighter valid neighbour; H12: each
window read and each triplet value written once, 8 B a candidate's
corner; H14: each distinct corner's 13x13 window, 8 B of corner and 1 B
of verdict a row; H18: the stamps, their flags, the PSF and the flags
out; H17: :func:`stamps_bound`, the reference's f32 work; H16: 12 B and
3 operations a pixel). Then the card's name and power limit, ptxas's registers and
spills of the checkout's sources of the cases run, and their kernels'
SASS and local-memory instruction counts. The script exits
non-zero at its end if a check failed.
"""
from __future__ import annotations

import sys
from pathlib import Path

# Run as a file, this directory comes first on sys.path, and it holds
# modules named like the standard library's (profile): drop it.
_HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == _HERE:
    del sys.path[0]

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
CUT = 33
REFINE_OPS_PX = 135
STATS_OPS = (25, 40)
# probe builds: (source, name) -> extra nvcc flags (built where the
# checkout's source knows the macro)
PROBES = {('measure.cu', f't{n}'): [f'-DZUDS_REFINE_THREADS={n}']
          for n in (128, 256, 512, 1024)}
PROBES.update({('objects.cu', f'stop{k}'): [f'-DZUDS_STATS_PROBE_STOP={k}']
               for k in (1, 2, 3)})
PROBES['objects.cu', 'windows_only'] = ['-DZUDS_STATS_PROBE_ROWS=1']
PROBES['deblend.cu', 'no_edges'] = ['-DZUDS_DEBLEND_PROBE_NO_EDGES']
PROBES['deblend.cu', 'no_exit'] = ['-DZUDS_DEBLEND_PROBE_NO_EXIT']
PROBES['deblend.cu', 'first_hooks'] = ['-DZUDS_DEBLEND_PROBE_NO_EXIT',
                                       '-DZUDS_DEBLEND_PROBE_FIRST_HOOKS']
PROBES['deblend.cu', 'first_round'] = ['-DZUDS_DEBLEND_PROBE_NO_EXIT',
                                       '-DZUDS_DEBLEND_PROBE_FIRST_HOOKS',
                                       '-DZUDS_DEBLEND_PROBE_FIRST_JUMPS']
# the blend field's stars (chip_smoke.py BUSY_STARS) and detect_sources'
# keywords there (chip_smoke.py BUSY)
BLEND_STARS = 620
BLEND_KW = dict(nsigma=5.0, max_det=4096, det_cap=1 << 16, deb_cap=1 << 16)
H5_ROUNDS = 6
# H25's operations an edge (chip_smoke.py CCL_OPS)
CCL_OPS = 4
# H24's a detected pixel a sweep: 8 minima and the mask's select
# (chip_smoke.py SEED_OPS)
SEED_OPS = 9
# H22's operations, counted from photometry.cu: a column edge and a row
# edge of the corner grid (each its offset and half 2, |e| and its clamp
# 2, the sign 1, an arc integral 14; the row edge also the circle's x, 4);
# a corner's area from them (7); a pixel's four-term sum and clamp (4);
# its sums (three sums and the test w > 0, the mask's AND and OR at r = 3;
# two sums on two planes)
APERTURE_EDGE_PAIR_OPS = 42
APERTURE_CORNER_OPS = 7
APERTURE_PIXEL_OPS = 4
APERTURE_SUM_OPS = {'photometry': 9, 'sums': 4}
# H27's operations (chip_smoke.py CLEAN_OPS): 3 a (valid row, valid
# column) pair, 14 more a brighter valid neighbour
CLEAN_OPS = (3, 14)
# H27's crowded row sets (rows, about 80% valid); H12's candidates
CLEAN_ROWS = (4098, 50000)
TRIPLET_N = (256, 2048)
# H14's rows: the scoring site's candidates, the distinct case's corners
NEGPIX_N = (256, 4096)
# H18: the ZOGY pair's stamps (chip_smoke.py ZOGY_STAMPS), the seeded set
PSF_STAMPS = (64, 300)
# H17: the stamp sizes timed beside the pair's 25 (an even one, the most)
STAMP_SIZES = (25, 24, 32)
FP64_FLOP_S = 33.5e12
EMPTY_CU = r'''
#include <cuda_runtime.h>
__global__ void zuds_empty_kernel() {}
extern "C" int zuds_empty(cudaStream_t stream) {
  zuds_empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}
'''


def bound(nbytes, flop):
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flop / FP32_FLOP_S * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def blend_field(H, W, nstar, seed=5):
    """tests/test_detect.py's busy blend field (stars of flux 2e3-3e4 and
    sigma 1.5-2.5 px, half with a companion within 6 px, noise 5) at any
    size, in numpy f32 from a seed."""
    rng = np.random.default_rng(seed)
    img = np.zeros((H, W), 'f4')
    yy, xx = np.mgrid[-8:9, -8:9]
    for _ in range(nstar):
        x, y = rng.uniform(20, W - 20), rng.uniform(20, H - 20)
        f = rng.uniform(2000, 30000)
        sig = rng.uniform(1.5, 2.5)
        stars = [(x, y, f)]
        if rng.random() < 0.5:
            stars.append((x + rng.uniform(-6, 6), y + rng.uniform(-6, 6),
                          f * rng.uniform(0.3, 1.0)))
        for sx, sy, sf in stars:
            xi, yi = int(round(sx)), int(round(sy))
            if not (8 < xi < W - 9 and 8 < yi < H - 9):
                continue
            psf = np.exp(-((xx + xi - sx) ** 2 + (yy + yi - sy) ** 2)
                         / (2 * sig * sig)) / (2 * np.pi * sig * sig)
            img[yi - 8:yi + 9, xi - 8:xi + 9] += (sf * psf).astype('f4')
    img += rng.normal(0, 5.0, (H, W)).astype('f4')
    return img


def corner_mask(joined, seed=4):
    """Blobs on a 64x80 frame whose last pixel is detected: alone (its
    three neighbours off), or joined to its neighbours; entry 0 of its
    compact list away from that corner."""
    rng = np.random.default_rng(seed)
    det = rng.random((64, 80)) < 0.35
    det[-3:, -3:] = joined
    det[-1, -1] = True
    det[:2, :] = False
    det[5:9, 5:9] = True
    return det


def full_graph(dev, ccap=8192, ecap=1 << 16, L=31, seed=20):
    """ecap seeded directed edges over ccap cells, every slot live at
    level 0 (weights 1..L), with chains whose smallest cell sits at one
    end (label 0 crawls a cell a round: the round cap decides)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, ccap, ecap)
    dst = rng.integers(0, ccap, ecap)
    w = rng.integers(1, L + 1, ecap)
    k = 0
    for c in range(20):
        cells = np.r_[c, ccap - 1 - c * 25 - np.arange(25)]
        for a, b in zip(cells[:-1], cells[1:]):
            src[k:k + 2], dst[k:k + 2], w[k:k + 2] = (a, b), (b, a), L
            k += 2
    t = [torch.as_tensor(v, device=dev) for v in (src, dst, w)]
    return {'e_src': t[0], 'e_dst': t[1], 'e_w': t[2], 'ccap': ccap,
            'L': L, 'nedge': torch.tensor(ecap, device=dev)}


def refine_bound(n, distinct):
    """H23's bound: the distinct rows' windows and operations, every
    row's inputs and outputs."""
    return bound(distinct * 2 * CUT * CUT * 4 + n * (24 + 44),
                 distinct * CUT * CUT * REFINE_OPS_PX)


def distinct_rows(args):
    """The number of rows with distinct bits in the six inputs."""
    bits = torch.stack([a.contiguous().view(torch.int32) for a in args], 1)
    return int(torch.unique(bits, dim=0).shape[0])


def build_probes(root, out_dir, sources):
    """Compile each probe of ``sources`` whose macro the checkout's source
    knows, and the empty kernel, all at once. Returns ({(source, name):
    library}, the empty kernel's library)."""
    import ctypes
    from zuds_tpu_torch.kernels import build
    kdir = Path(root) / 'zuds_tpu_torch' / 'kernels'
    procs = {}
    for (src, name), extra in PROBES.items():
        macro = extra[0][2:].split('=')[0]
        if src not in sources or macro not in (kdir / src).read_text():
            continue
        out = Path(out_dir) / f'{src[:-3]}_{name}.so'
        procs[src, name] = (out, subprocess.Popen(
            [build._nvcc(), *build.FLAGS, *extra, '-shared', '-o', str(out),
             str(kdir / src)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    empty_src = Path(out_dir) / 'empty.cu'
    empty_src.write_text(EMPTY_CU)
    empty_so = Path(out_dir) / 'empty.so'
    procs['empty'] = (empty_so, subprocess.Popen(
        [build._nvcc(), *build.FLAGS, '-shared', '-o', str(empty_so),
         str(empty_src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True))
    libs = {}
    for key, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on probe {key}:\n{err}')
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        for fn, argtypes in build.SCRATCH_SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_longlong
        libs[key] = lib
    empty = libs.pop('empty')
    empty.zuds_empty.argtypes = [ctypes.c_void_p]
    empty.zuds_empty.restype = ctypes.c_int
    return libs, empty


def variant_refine(lib, img, rms, args):
    """H23 through a probe build of measure.cu."""
    from zuds_tpu_torch.kernels import launch
    n = args[0].numel()
    out = torch.empty((11, n), dtype=torch.float32, device=img.device)
    err = lib.zuds_refine_detections(
        launch._ptr(img), launch._ptr(rms), img.shape[0], img.shape[1],
        *(launch._ptr(a) for a in args), n, CUT, launch._ptr(out),
        launch._stream())
    if err:
        raise RuntimeError(f'probe zuds_refine_detections: CUDA error {err}')
    return out


def variant_stats(lib, args):
    """H26 through a probe build of objects.cu."""
    from zuds_tpu_torch.kernels import launch
    cid, pidx, vals, mask_c, wok_c, thr, deb_ovf, ndet = args[:8]
    (H, W), nseg, minarea, max_det = args[8:]
    n = cid.numel()
    dev = cid.device
    scratch = torch.empty(lib.zuds_object_stats_scratch(n, nseg),
                          dtype=torch.uint8, device=dev)
    outf = torch.empty((18, nseg), dtype=torch.float32, device=dev)
    outi = torch.empty((2, nseg), dtype=torch.int32, device=dev)
    valid = torch.empty(nseg, dtype=torch.uint8, device=dev)
    err = lib.zuds_object_stats(
        *(launch._ptr(t) for t in (cid, pidx, vals, mask_c, wok_c, thr,
                                   deb_ovf, ndet)),
        n, H, W, int(nseg), float(minarea), int(max_det), launch._ptr(scratch),
        launch._ptr(outf), launch._ptr(outi), launch._ptr(valid),
        launch._stream())
    if err:
        raise RuntimeError(f'probe zuds_object_stats: CUDA error {err}')
    return outf


def _h5_takes_nedge():
    import inspect
    from zuds_tpu_torch.kernels import launch
    return 'nedge' in inspect.signature(launch.deblend_labels).parameters


def h5_call(e, g, rounds, nedge):
    """The checkout's H5 wrapper on the edge list ``e`` as it takes it
    (a parent's wrapper takes no ``nedge``: None)."""
    from zuds_tpu_torch.kernels import launch
    extra = () if nedge is None else (nedge,)
    return launch.deblend_labels(*e, g['ccap'], g['L'], rounds, *extra)


def variant_h5(lib, e, g, rounds, nedge):
    """H5 through a probe build of deblend.cu (the new signature)."""
    from zuds_tpu_torch.kernels import launch
    bl = torch.empty((g['L'], g['ccap']), dtype=torch.int32,
                     device=e[0].device)
    err = lib.zuds_deblend_labels(
        *(launch._ptr(t) for t in e), launch._ptr(nedge),
        e[0].numel(), g['ccap'], g['L'], rounds, launch._ptr(bl),
        launch._stream())
    if err:
        raise RuntimeError(f'probe zuds_deblend_labels: CUDA error {err}')
    return bl


def level_stats(g, rounds):
    """Level 0's live edges, distinct (src, dst) pairs and sources, and
    per level the first round that changes nothing (at most ``rounds``)."""
    from zuds_tpu_torch.ops import deblend
    n = min(int(g['nedge']), g['e_src'].numel())
    s, d, w = g['e_src'][:n], g['e_dst'][:n], g['e_w'][:n]
    live = w > 0
    pairs = torch.unique(s[live] * 65536 + d[live])
    args = (g['e_src'], g['e_dst'], g['e_w'], g['ccap'], g['L'])
    # a level runs round r when round r - 1 changed its labels
    prev = deblend.level_labels_plain(*args, 1)
    run = torch.full((g['L'],), rounds, device=s.device)
    found = torch.zeros(g['L'], dtype=torch.bool, device=s.device)
    for r in range(2, rounds + 1):
        cur = deblend.level_labels_plain(*args, r)
        done = (cur == prev).all(1) & ~found
        run = torch.where(done, r, run)
        found |= done
        prev = cur
    return {'level0_edges': int(live.sum()),
            'level0_pairs': int(pairs.numel()),
            'level0_sources': int(torch.unique(s[live]).numel()),
            'rounds': run.tolist()}


def h5_cases(cfg, out, dev, libs):
    from zuds_tpu_torch.bench_compact import call_ms, graph_ms
    from zuds_tpu_torch.constants import BAD_SUM
    from zuds_tpu_torch.ops import deblend, detect
    diff, rms = out['diff'][0], out['rms'][0]
    wok = (out['submask'][0] & BAD_SUM) == 0
    H, W = diff.shape
    graphs = {'h5_slice': detect.deblend_load(
        diff, rms, wok, nsigma=cfg.nsigma, max_det=cfg.max_det,
        det_cap=cfg.det_cap, deb_cap=cfg.deb_cap)['graph']}
    img = torch.as_tensor(blend_field(H, W, BLEND_STARS), device=dev)
    graphs['h5_blend'] = detect.deblend_load(img, torch.full_like(img, 5.0),
                                             **BLEND_KW)['graph']
    graphs['h5_full'] = full_graph(dev)
    new = _h5_takes_nedge()
    for case, g in graphs.items():
        ecap = g['e_src'].numel()
        full = (g['e_src'], g['e_dst'], g['e_w'])
        e = full if new else tuple(t.to(torch.int32).contiguous()
                                   for t in full)
        nedge = g['nedge'] if new else None
        rec = {'case': case, 'ccap': g['ccap'], 'levels': g['L'],
               'slots': ecap, 'nedge': int(g['nedge']),
               'takes_nedge': new, **level_stats(g, H5_ROUNDS)}
        k = h5_call(e, g, H5_ROUNDS, nedge)
        p = deblend.level_labels_plain(*full, g['ccap'], g['L'], H5_ROUNDS)
        rec['bit_equal'] = bool(torch.equal(k, p))
        rec['repeat_equal'] = bool(torch.equal(
            k, h5_call(e, g, H5_ROUNDS, nedge)))
        _timed(rec, lambda: h5_call(e, g, H5_ROUNDS, nedge))
        rec['level_ms'] = graph_ms(lambda: deblend.level_labels(
            *full, g['ccap'], g['L'], H5_ROUNDS,
            **({'nedge': g['nedge']} if new else {})))
        rec['plain_ms'] = call_ms(lambda: deblend.level_labels_plain(
            *full, g['ccap'], g['L'], H5_ROUNDS))
        n = min(rec['nedge'], ecap)
        rec['bound_ms'], rec['bound_by'] = bound(
            24 * n + 8 + 4 * g['L'] * g['ccap'],
            g['L'] * (n + 3 * g['ccap']))
        dead = (e[0], e[1], torch.zeros_like(e[2]))
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        none = tuple(t[:0] for t in e)
        probes = {
            'rounds1': graph_ms(lambda: h5_call(e, g, 1, nedge)),
            'dead': graph_ms(lambda: h5_call(dead, g, H5_ROUNDS, nedge)),
            'empty': graph_ms(lambda: h5_call(e, g, H5_ROUNDS, zero) if new
                              else h5_call(none, g, H5_ROUNDS, None))}
        for (src, name), lib in libs.items():
            if src != 'deblend.cu':
                continue
            pk = variant_h5(lib, e, g, H5_ROUNDS, nedge)
            probes[name] = {'graph_ms': graph_ms(
                lambda: variant_h5(lib, e, g, H5_ROUNDS, nedge)),
                'bit_equal': bool(torch.equal(pk, p))}
        rec['probes'] = probes
        rec['ok'] = rec['bit_equal'] and rec['repeat_equal']
        yield rec


def h25_case(cfg, out):
    from zuds_tpu_torch.bench_compact import graph_ms
    from zuds_tpu_torch.constants import BAD_SUM
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import detect
    diff, rms, mask = out['diff'][0], out['rms'][0], out['submask'][0]
    taps = detect.detect_taps(diff, rms, mask, (mask & BAD_SUM) == 0,
                              nsigma=cfg.nsigma, max_det=cfg.max_det,
                              det_cap=cfg.det_cap, deb_cap=cfg.deb_cap)
    nbr_pos, okb, lab0 = taps['ccl']
    n = lab0.numel()
    same = lab0[nbr_pos] == lab0[None]
    back = torch.zeros_like(okb)
    back[:4] = okb[:4]
    rec = {'case': 'h25_slice', 'entries': n,
           'seeded_elsewhere': int((lab0 != torch.arange(
               n, device=lab0.device)).sum()),
           'edges': int(okb.sum()), 'backward_edges': int(back.sum()),
           'backward_across_seeds': int((back & ~same).sum()),
           'plain_rounds': detect.label_compact_rounds(nbr_pos, okb, lab0)}
    k = launch.ccl_fixpoint(nbr_pos, okb, lab0)
    p = detect.label_compact_plain(nbr_pos, okb, lab0)
    rec['bit_equal'] = bool(torch.equal(k, p))
    rec['repeat_equal'] = bool(torch.equal(
        k, launch.ccl_fixpoint(nbr_pos, okb, lab0)))
    _timed(rec, lambda: launch.ccl_fixpoint(nbr_pos, okb, lab0))
    rec['bound_ms'], rec['bound_by'] = bound(52 * n,
                                             CCL_OPS * int(back.sum()))
    rec['split_us'] = profile_split(
        lambda: launch.ccl_fixpoint(nbr_pos, okb, lab0))
    skip = back & ~same
    probes = {}
    for name, ok in (('backward_input', back), ('skip_input', skip)):
        probes[name] = {
            'graph_ms': graph_ms(lambda: launch.ccl_fixpoint(nbr_pos, ok,
                                                             lab0)),
            'bit_equal': bool(torch.equal(
                launch.ccl_fixpoint(nbr_pos, ok, lab0), p))}
    rec['probes'] = probes
    rec['ok'] = rec['bit_equal'] and rec['repeat_equal']
    return rec


def seed_frame(det):
    """The full-frame seeds of the checkout's plain version (named
    ``seed_labels_plain`` before H24 took the compact list)."""
    from zuds_tpu_torch.ops import detect
    return getattr(detect, 'seed_frame_plain', detect.seed_labels_plain)(det)


def _h24_listed():
    import inspect
    from zuds_tpu_torch.kernels import launch
    return 'pidx' in inspect.signature(launch.seed_sweeps).parameters


def h24_call(det, pidx, count, listed):
    """The checkout's H24 as its callers reach the (cap,) seeds of the
    compact list: the list's own launch, or a parent's full frame and the
    gather after it (+inf past the count)."""
    from zuds_tpu_torch.kernels import launch
    if listed:
        return launch.seed_sweeps(det, pidx, count)
    seeds = launch.seed_sweeps(det).reshape(-1)[pidx]
    keep = torch.arange(pidx.numel(), device=pidx.device) < count
    return torch.where(keep, seeds, float('inf'))


def h24_inputs(cfg, out, dev):
    """{case: (mask, list, count)}: the slice's frame 0 (its detection
    mask at det_cap), the blend field, and frame 0's mask with its last
    pixel detected under a cap of half its detected pixels."""
    from zuds_tpu_torch.constants import BAD_SUM
    from zuds_tpu_torch.ops import detect
    from zuds_tpu_torch.ops.compact import compact_indices
    diff, rms, mask = out['diff'][0], out['rms'][0], out['submask'][0]
    H, W = diff.shape
    det = detect.matched_filter(diff, rms, (mask & BAD_SUM) == 0,
                                cfg.nsigma)[2].contiguous()
    img = torch.as_tensor(blend_field(H, W, BLEND_STARS), device=dev)
    blend = detect.matched_filter(img, torch.full_like(img, 5.0),
                                  torch.ones_like(img, dtype=torch.bool),
                                  BLEND_KW['nsigma'])[2].contiguous()
    over = det.clone()
    over[-1, -1] = True
    cases = {}
    for case, m, cap in (('h24_slice', det, cfg.det_cap),
                         ('h24_blend', blend, BLEND_KW['det_cap']),
                         ('h24_overflow', over, int(over.sum()) // 2)):
        pidx, count = compact_indices(m.reshape(-1), cap, H * W - 1)
        cases[case] = (m, pidx, count)
    return cases


def h24_cases(cfg, out, dev):
    from zuds_tpu_torch.bench_compact import graph_ms
    listed = _h24_listed()
    for case, (det, pidx, count) in h24_inputs(cfg, out, dev).items():
        H, W = det.shape
        cap = pidx.numel()
        nl = min(int(count), cap)
        ref = seed_frame(det).reshape(-1)[pidx]
        ref = torch.where(torch.arange(cap, device=dev) < count, ref,
                          float('inf'))
        k = h24_call(det, pidx, count, listed)
        tiles = torch.nn.functional.max_pool2d(
            det[None, None].float(), 32, 32, ceil_mode=True)
        rec = {'case': case, 'shape': [H, W], 'cap': cap,
               'detected': int(count), 'listed': nl,
               'live_tiles': int((tiles > 0).sum()),
               'tiles': int(tiles.numel()), 'listed_form': listed,
               'bit_equal': bool(torch.equal(k, ref)),
               'repeat_equal': bool(torch.equal(
                   k, h24_call(det, pidx, count, listed))),
               'sha256': hashlib.sha256(k.cpu().numpy().tobytes())
               .hexdigest()}
        _timed(rec, lambda: h24_call(det, pidx, count, listed))
        if not listed:
            from zuds_tpu_torch.kernels import launch
            rec['frame_ms'] = graph_ms(lambda: launch.seed_sweeps(det))
        rec['bound_ms'], rec['bound_by'] = bound(
            H * W + 8 * nl + 4 * cap + 8, SEED_OPS * 12 * int(count))
        rec['ok'] = rec['bit_equal'] and rec['repeat_equal']
        yield rec


def aperture_ops(n, r, sum_ops):
    """Operations of H22's corner grid for ``n`` distinct rows at radius
    ``r``: per window its edges' terms and corner areas, per pixel the
    four-term sum and clamp and its ``sum_ops``."""
    from zuds_tpu_torch.ops import photometry as ph
    cut = ph.aperture_cut(r)
    return n * ((cut + 1) * APERTURE_EDGE_PAIR_OPS
                + (cut + 1) ** 2 * APERTURE_CORNER_OPS
                + cut * cut * (APERTURE_PIXEL_OPS + sum_ops))


def distinct_positions(xs, ys):
    """The indices of one row of each distinct (x, y) bit pattern."""
    bits = torch.stack([xs.view(torch.int32), ys.view(torch.int32)], 1)
    _, inv = torch.unique(bits, dim=0, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), xs.numel(), device=xs.device)
    return first.scatter_reduce(0, inv, torch.arange(xs.numel(),
                                                     device=xs.device),
                                'amin')


def h22_inputs(cfg, sci, out, dev, phot):
    """{case: (mode, planes, xs, ys)}: the slice's 4096 rows at r = 3 and
    r = 6, 4096 seeded positions over the science frame at both, the star
    field's valid rows and, from ``phot`` (a file chip_smoke.py writes),
    dophot's forced positions."""
    from zuds_tpu_torch.bench_warp import star_field
    from zuds_tpu_torch.constants import BAD_SUM
    from zuds_tpu_torch.ops import detect
    diff, rms = out['diff'][0].contiguous(), out['rms'][0].contiguous()
    mask = out['submask'][0].contiguous()
    H, W = diff.shape
    badf = ((mask & BAD_SUM) > 0).to(torch.float32)
    xs, ys = (out[f'det_{k}'][0].contiguous() for k in ('x', 'y'))
    dx, dy = seeded_rows(cfg.max_det, H, W, dev)[:2]
    cases = {'h22_slice_r3': ('photometry', (diff, rms, mask), xs, ys),
             'h22_slice_r6': ('sums', (rms, badf), xs, ys),
             'h22_distinct': ('photometry', (sci, rms, mask), dx, dy),
             'h22_distinct_r6': ('sums', (rms, badf), dx, dy)}
    field = torch.as_tensor(star_field(H, W, 21), device=dev) - 150.0
    frms = torch.full_like(field, 5.0)
    det = detect.detect_sources(field, frms, max_det=cfg.max_det,
                                return_labels=False, det_cap=cfg.det_cap,
                                deb_cap=cfg.deb_cap)
    idx = torch.nonzero(det['valid']).reshape(-1)
    cases['h22_pairlike'] = ('photometry', (field.contiguous(), frms, None),
                             det['x'][idx].contiguous(),
                             det['y'][idx].contiguous())
    if phot:
        t = torch.load(phot)
        cases['h22_forced'] = ('photometry', tuple(
            t[k].to(dev).contiguous() for k in ('img', 'rms', 'mask')),
            t['x'].to(dev).contiguous(), t['y'].to(dev).contiguous())
    return cases


def aperture_call(mode, planes, xs, ys):
    """H22 of the checkout in ``mode`` at r = 3 (photometry) or r = 6
    (sums): its outputs in one list."""
    from zuds_tpu_torch.kernels import launch
    if mode == 'sums':
        return list(launch.aperture_sums(*planes, xs, ys, 6.0, 15))
    k = launch.aperture_photometry(*planes, xs, ys, 3.0, 9)
    return [k[key] for key in ('flux', 'fluxerr', 'area', 'flags', 'oob')]


def _outputs_equal(a, b):
    return all(torch.equal(x.view(torch.uint8) if x.dtype == torch.bool
                           else x.contiguous().view(torch.uint8),
                           y.view(torch.uint8) if y.dtype == torch.bool
                           else y.contiguous().view(torch.uint8))
               for x, y in zip(a, b))


def h22_cases(cfg, sci, out, dev, phot):
    from zuds_tpu_torch.bench_compact import graph_ms
    from zuds_tpu_torch.kernels import checks
    from zuds_tpu_torch.ops import photometry as ph
    for case, (mode, planes, xs, ys) in h22_inputs(cfg, sci, out, dev,
                                                   phot).items():
        H, W = planes[0].shape
        n = xs.numel()
        one = distinct_positions(xs, ys)
        nd = one.numel()
        k = aperture_call(mode, planes, xs, ys)
        rec = {'case': case, 'mode': mode, 'rows': n, 'distinct': nd,
               'repeat_equal': _outputs_equal(
                   k, aperture_call(mode, planes, xs, ys)),
               'sha256': hashlib.sha256(b''.join(
                   v.contiguous().cpu().numpy().tobytes() for v in k))
               .hexdigest()}
        try:
            if mode == 'photometry':
                rec['max_gap'] = checks.aperture_check(
                    *planes, xs, ys, 3.0, case)
            else:
                pa = ph.aperture_sums_plain(planes, xs, ys, 6.0)
                scale = ph.aperture_sums_plain(tuple(p.abs() for p in planes),
                                               xs, ys, 6.0)
                rel = checks.sum_gap_bound(225)
                gap = 0.0
                for kv, pv, sc in zip(k, pa, scale):
                    d = (kv - pv).abs()
                    assert bool((d <= rel * sc).all()), f'{case}: sums'
                    gap = max(gap, float(d.max()))
                rec['max_gap'] = gap
            rec['check_ok'] = True
        except AssertionError as e:
            rec.update(check_ok=False, check_error=str(e)[:300])
        _timed(rec, lambda: aperture_call(mode, planes, xs, ys))
        # a window pixel's bytes: 4 a plane given (img, rms, mask; a, b)
        px = 4 * sum(t is not None for t in planes)
        cut, row, sum_ops = ((9, 25, APERTURE_SUM_OPS['photometry'])
                             if mode == 'photometry'
                             else (15, 16, APERTURE_SUM_OPS['sums']))
        rec['bound_ms'], rec['bound_by'] = bound(
            nd * cut * cut * px + n * row,
            aperture_ops(nd, 3.0 if cut == 9 else 6.0, sum_ops))
        rec['all_rows_bound_ms'] = bound(n * (cut * cut * px + row), 0)[0]
        rec['ok'] = rec['repeat_equal'] and rec['check_ok']
        yield rec


def clean_rows(nseg, dev):
    """CLEAN's row fields (ops.detect.CLEAN_FIELDS) of ``nseg`` seeded rows
    on ``dev``, about 80% valid, bright rows close together so that CLEAN
    merges some, every seventh peak equal (a torch generator seeded with
    ``nseg`` on ``dev``)."""
    g = torch.Generator(device=dev).manual_seed(nseg)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(nseg, generator=g, device=dev)

    a = u(0.5, 3.0)
    peak = u(1.0, 100.0)
    peak[::7] = 50.0                        # equal peaks
    valid = torch.rand(nseg, generator=g, device=dev) < 0.8
    valid[0] = valid[-1] = False
    return (u(0, 40), u(0, 40), a, a * u(0.3, 1.0), u(-1.5, 1.5), peak,
            u(0.5, 60.0), u(10, 1e4), torch.round(u(5, 50)),
            torch.zeros(nseg, dtype=torch.int32, device=dev), valid)


def clean_edge_rows(nseg, seed, nvalid=None):
    """CLEAN's row fields as numpy arrays: :func:`clean_rows`' kind of
    rows from a numpy seed, with equal, negative, zero, -0 and NaN peaks,
    a faint row with a NaN position and one with a NaN angle (NaN wings on
    the rows fainter still) and -0 fluxes; ``nvalid`` 0 or 1 keeps that
    many valid rows."""
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return rng.uniform(lo, hi, nseg).astype('f4')

    a = u(0.5, 3.0)
    peak = u(1.0, 100.0)
    peak[::7] = 50.0
    peak[3::11] = -u(0.0, 5.0)[3::11]
    peak[5::13] = -0.0
    peak[9::17] = 0.0
    peak[10::97] = np.nan
    x, y, theta = u(0, 40), u(0, 40), u(-1.5, 1.5)
    valid = rng.random(nseg) < 0.8
    valid[0] = valid[-1] = False
    x[4], peak[4], theta[6], peak[6] = np.nan, 1.5, np.nan, 2.0
    valid[4] = valid[6] = True
    if nvalid is not None:
        valid[:] = False
        valid[nseg // 3:nseg // 3 + nvalid] = True
    flux = u(10, 1e4)
    flux[8::29] = -0.0
    return (x, y, a, (a * u(0.3, 1.0)).astype('f4'), theta, peak,
            u(0.5, 60.0), flux, np.round(u(5, 50)), np.zeros(nseg, 'i4'),
            valid)


def clean_inv():
    """The f32 reciprocal of 2 CLEAN_PARAM^2 that H27 takes."""
    from zuds_tpu_torch.constants import CLEAN_PARAM
    return float(np.float32(1.0) / np.float32(2.0 * CLEAN_PARAM ** 2))


def clean_inputs(cfg, out, dev):
    """{case: CLEAN's row fields}: the slice's frame 0 and the blend field
    as ``detect_taps`` gives them, and :func:`clean_rows` at CLEAN_ROWS."""
    from zuds_tpu_torch.constants import BAD_SUM
    from zuds_tpu_torch.ops import detect
    diff, rms, mask = out['diff'][0], out['rms'][0], out['submask'][0]
    H, W = diff.shape
    cases = {'h27_slice': detect.detect_taps(
        diff, rms, mask, (mask & BAD_SUM) == 0, nsigma=cfg.nsigma,
        max_det=cfg.max_det, det_cap=cfg.det_cap,
        deb_cap=cfg.deb_cap)['clean']}
    img = torch.as_tensor(blend_field(H, W, BLEND_STARS), device=dev)
    cases['h27_blend'] = detect.detect_taps(
        img, torch.full_like(img, 5.0), torch.zeros_like(img,
                                                         dtype=torch.int32),
        torch.ones_like(img, dtype=torch.bool), **BLEND_KW)['clean']
    for n in CLEAN_ROWS:
        cases[f'h27_rows{n}'] = clean_rows(n, dev)
    return cases


def h27_cases(cfg, out, dev):
    from zuds_tpu_torch.bench_compact import call_ms
    from zuds_tpu_torch.kernels import checks, launch
    from zuds_tpu_torch.ops import detect
    inv = clean_inv()
    for case, args in clean_inputs(cfg, out, dev).items():
        nseg = args[0].numel()
        valid, peak = args[10], args[5]
        pf = peak[valid]
        nv = int(valid.sum())
        k = launch.clean(*args, inv)
        rec = {'case': case, 'rows': nseg, 'valid': nv,
               'repeat_equal': _outputs_equal(k, launch.clean(*args, inv)),
               'sha256': hashlib.sha256(b''.join(
                   v.contiguous().cpu().numpy().tobytes() for v in k))
               .hexdigest()}
        try:
            gap, rel, ncleaned, near = checks.clean_check(args)
            rec.update(check_ok=True, flux_gap=gap, contrib_rel=rel,
                       cleaned=ncleaned, near_threshold=near)
        except AssertionError as e:
            rec.update(check_ok=False, check_error=str(e)[:300])
        _timed(rec, lambda: launch.clean(*args, inv))
        rec['plain_ms'] = call_ms(lambda: detect._clean_plain(*args), 1, 3)
        nok = int((pf[None, :] > pf[:, None]).sum())
        rec['bound_ms'], rec['bound_by'] = bound(
            60 * nseg, CLEAN_OPS[0] * nv * nv + CLEAN_OPS[1] * nok)
        rec['ok'] = rec['repeat_equal'] and rec['check_ok']
        yield rec


def scoring_corners(H, W, n, size, seed=17):
    """int32 corners on the card of n seeded positions, a few past each
    edge (clamped as the filter clamps them)."""
    from zuds_tpu_torch.ops import cutouts
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-3, W + 2, n).astype('f4')
    ys = rng.uniform(-3, H + 2, n).astype('f4')
    return cutouts.clamped_corners(torch.as_tensor(xs, device='cuda'),
                                   torch.as_tensor(ys, device='cuda'), size,
                                   H, W)


def night_frames(cfg, tmp):
    """The night's frame 0 (``inputs.write_night_pairs`` as chip_smoke.py
    writes it), its reference and their difference, on the card."""
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.fits import read_fits
    work, _ = inputs.write_night_pairs(
        tmp, 1, cfg.height, cfg.width,
        header_json=_HERE.parent / 'tests' / 'data' / 'ztf_real_header.json')
    frames = [torch.as_tensor(np.ascontiguousarray(
        next(h for h in read_fits(p) if h.data is not None).data, 'f4'),
        device='cuda') for p in work[0].split()]
    frames.append(frames[0] - frames[1])
    return frames


def h12_cases(cfg, tmp):
    from zuds_tpu_torch.bench_compact import call_ms
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import cutouts
    frames = night_frames(cfg, tmp)
    H, W = frames[0].shape
    for n in TRIPLET_N:
        x0, y0 = scoring_corners(H, W, n, 63)
        k = launch.triplet_cut(*frames, x0, y0)
        p = cutouts.triplet_cut_plain(*frames, x0, y0)
        gap = (k - p).abs()
        rec = {'case': f'h12_n{n}', 'candidates': n, 'shape': [H, W],
               'repeat_equal': bool(torch.equal(
                   k, launch.triplet_cut(*frames, x0, y0))),
               'max_abs_err': float(gap.max()),
               'check_ok': bool((gap <= 1e-6 * p.abs()).all()),
               'sha256': hashlib.sha256(k.cpu().numpy().tobytes())
               .hexdigest()}
        _timed(rec, lambda: launch.triplet_cut(*frames, x0, y0))
        rec['plain_ms'] = call_ms(
            lambda: cutouts.triplet_cut_plain(*frames, x0, y0), 1, 3)
        # each window read once, each triplet written once, the corners
        rec['bound_ms'], rec['bound_by'] = bound(
            8 * n * 3 * 63 * 63 + 8 * n, 3 * n * 3 * 63 * 63)
        rec['ok'] = rec['repeat_equal'] and rec['check_ok']
        yield rec


def negpix_bound(x0, y0):
    """H14's distinct corners and the bound of its distinct work: each
    distinct corner's 13x13 window, 8 B of corner and 1 B of verdict a row
    (bytes); a subtract, a divide, nine maxima and two compares a distinct
    window's pixel (operations)."""
    nd = int(torch.unique(torch.stack([x0, y0], 1), dim=0).shape[0])
    return nd, bound(nd * 13 * 13 * 4 + 9 * x0.numel(), nd * 13 * 13 * 13)


def negpix_inputs(cfg, out, dev, tmp):
    """H14's cases: (image, median, sigma, x0, y0)."""
    from zuds_tpu_torch.ops import background, cutouts
    diff = out['diff'][0].contiguous()
    H, W = diff.shape
    dsub = diff[::4, ::4]
    dmed = background.frame_median(dsub)
    dsig = torch.clamp(1.48 * background.frame_median(dsub, center=dmed),
                       min=1e-12)
    cases = {'h14_slice': (diff, dmed, dsig) + cutouts.clamped_corners(
        out['det_x'][0], out['det_y'][0], cutouts.NEGPIX_BOX, H, W)}
    nd = night_frames(cfg, tmp)[2].contiguous()
    med = cutouts.frame_median_exact(nd)
    sig = 1.48 * cutouts.frame_median_exact((nd - med).abs())
    cases[f'h14_n{NEGPIX_N[0]}'] = (nd, med, sig) + scoring_corners(
        H, W, NEGPIX_N[0], cutouts.NEGPIX_BOX)
    # distinct corners, a -/+ pair at every eighth's centre
    rng = np.random.default_rng(19)
    flat = rng.choice((H - 12) * (W - 12), NEGPIX_N[1], replace=False)
    y0 = torch.as_tensor((flat // (W - 12)).astype('i4'), device=dev)
    x0 = torch.as_tensor((flat % (W - 12)).astype('i4'), device=dev)
    img = diff.clone()
    cy, cx = y0[::8].long() + 6, x0[::8].long() + 6
    img[cy, cx] = dmed - 50 * dsig
    img[cy + 1, cx - 1] = dmed + 50 * dsig
    cases['h14_distinct'] = (img, dmed, dsig, x0, y0)
    return cases


def h14_cases(cfg, out, dev, tmp):
    from zuds_tpu_torch.bench_compact import call_ms
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import cutouts
    for case, args in negpix_inputs(cfg, out, dev, tmp).items():
        k = launch.negpix_veto(*args)
        again = launch.negpix_veto(*args)
        p = cutouts.negpix_veto_plain(*args)
        nd, (bms, by) = negpix_bound(*args[3:])
        rec = {'case': case, 'rows': args[3].numel(), 'distinct': nd,
               'vetoed': int(k.sum()), 'equal': bool(torch.equal(k, p)),
               'repeat_equal': bool(torch.equal(k, again)),
               'sha256': hashlib.sha256(k.cpu().numpy().tobytes())
               .hexdigest(), 'bound_ms': bms, 'bound_by': by}
        _timed(rec, lambda: launch.negpix_veto(*args))
        rec['plain_ms'] = call_ms(lambda: cutouts.negpix_veto_plain(*args),
                                  1, 3)
        rec['ok'] = rec['equal'] and rec['repeat_equal']
        yield rec


def zogy_frames(cfg, dev, tmp):
    """The night's first pair as the ZOGY path takes it (subtraction.py's
    zogy branch): the science frame less its background and the reference
    aligned to it (f32 on the card), the star positions of
    ``_select_stamps(sci, 64)`` (xs, ys, valid on the card) and the
    median rms of each frame."""
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.coadd import ReferenceImage
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.subtraction import _select_stamps
    d = Path(tmp) / 'zogy'
    d.mkdir(exist_ok=True)
    work, _ = inputs.write_night_pairs(
        d, 1, cfg.height, cfg.width,
        header_json=_HERE.parent / 'tests' / 'data' / 'ztf_real_header.json')
    sci_path, ref_path = work[0].split()
    sci = ScienceImage.from_file(sci_path)
    ref = ReferenceImage.from_file(ref_path)
    pos = [torch.as_tensor(a, device=dev)
           for a in _select_stamps(sci, smax=PSF_STAMPS[0])]
    new = torch.as_tensor(np.ascontiguousarray(
        sci.background_subtracted_image.data, 'f4'), device=dev)
    aligned = torch.as_tensor(np.ascontiguousarray(
        ref.aligned_to(sci).data, 'f4'), device=dev)
    sigmas = (float(np.median(sci.rms_image.data)),
              max(float(np.median(ref.rms_image.aligned_to(sci).data)), 1e-3))
    return new, aligned, pos, sigmas


def psf_inputs(frames):
    """H18's cases: (stamps, good0)."""
    from zuds_tpu_torch.kernels import launch
    new, _, pos, _ = frames
    dev = new.device
    cases = {'h18_zogy': launch.psf_stamps(new, *pos, 25)}
    # seeded stamps: a Gaussian of sigma 1.8 px, noise, an outlier in
    # every 23rd, the last eight padding rows
    rng = np.random.default_rng(21)
    n = PSF_STAMPS[1]
    yy, xx = np.mgrid[-12:13, -12:13]
    g = np.exp(-(xx ** 2 + yy ** 2) / (2 * 1.8 ** 2))
    st = g / g.sum() + rng.normal(0, 2e-4, (n, 25, 25))
    st[::23, 12, 13] += 0.05
    good0 = np.arange(n) < n - 8
    cases[f'h18_s{n}'] = (torch.as_tensor(st.astype('f4'), device=dev),
                          torch.as_tensor(good0, device=dev))
    return cases


def stamp_field(H, W, n, seed=22):
    """n stars of 3e4 (sigma 1.8 px) at seeded positions on a sky of 150
    counts, noise 5 (a reference's pedestal, the case that wants the
    transforms in double), four of them within 3 px of an edge (their
    corners clamp): (img f32, xs, ys, valid all True)."""
    rng = np.random.default_rng(seed)
    img = 150.0 + 5.0 * rng.standard_normal((H, W))
    xs = rng.uniform(20, W - 20, n)
    ys = rng.uniform(20, H - 20, n)
    xs[:4], ys[:4] = (2.2, W - 1.4, 700.3, 1500.6), (900.7, 40.2, 1.9, H - 2.6)
    r = 10
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    for x, y in zip(xs, ys):
        ix, iy = int(round(x)), int(round(y))
        y0, y1 = max(iy - r, 0), min(iy + r + 1, H)
        x0, x1 = max(ix - r, 0), min(ix + r + 1, W)
        g = np.exp(-((xx + ix - x) ** 2 + (yy + iy - y) ** 2) / 6.48) \
            * 3e4 / (2 * np.pi * 3.24)
        img[y0:y1, x0:x1] += g[y0 - iy + r:y1 - iy + r, x0 - ix + r:x1 - ix + r]
    return (img.astype('f4'), xs.astype('f4'), ys.astype('f4'),
            np.ones(n, bool))


def stamp_flop(S, n):
    """H17's issued fp64 FLOP (two a fused multiply-add) at S stamps of
    n x n: P1 n m outputs of (n - 1) // 2 paired terms of two FMAs (and a
    Nyquist FMA at even n); P2, P3 m^2 conjugate pairs of n terms of four
    FMAs; P4 n m column pairs of m terms of two FMAs (m = n // 2 + 1)."""
    m = n // 2 + 1
    fma = (n * m * (2 * ((n - 1) // 2) + (1 - n % 2)) + 2 * m * m * n * 4
           + n * m * m * 2)
    return 2 * S * fma


def stamps_bound(S, n):
    """H17's bound, the function's work as the reference does it in f32:
    each stamp's window read and written, its position and flags (9 B);
    fft2 and ifft2 of n^2 points at 5 n^2 log2 n^2 each, 15 operations a
    pixel for the ramp, the median's subtraction, the sum and the scale
    (chip_smoke.py's psf_stamps bound)."""
    import math
    npx = n * n
    return bound(S * (2 * npx * 4 + 9),
                 S * (2 * 5 * npx * math.log2(max(npx, 2)) + 15 * npx))


def h17_cases(dev, frames):
    from zuds_tpu_torch.bench_compact import call_ms
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import zogy
    new, aligned, pos, _ = frames
    H, W = new.shape
    field = [torch.as_tensor(a, device=dev)
             for a in stamp_field(H, W, PSF_STAMPS[1])]
    cases = [('h17_zogy', new, pos, 25), ('h17_zogy_ref', aligned, pos, 25)]
    cases += [(f'h17_zogy_n{n}', new, pos, n) for n in STAMP_SIZES[1:]]
    cases += [(f'h17_s{PSF_STAMPS[1]}', field[0], field[1:], 25)]
    for case, img, (xs, ys, valid), n in cases:
        ks, kg = launch.psf_stamps(img, xs, ys, valid, n)
        ps, pg = zogy.psf_stamps_plain(img, xs, ys, valid, n)
        rs, rg = launch.psf_stamps(img, xs, ys, valid, n)
        S = xs.shape[0]
        err = float((ks[pg] - ps[pg]).abs().max()) if bool(pg.any()) else 0.0
        rec = {'case': case, 'stamps': S, 'size': n,
               'good0': int(pg.sum()), 'good_equal': bool(torch.equal(kg, pg)),
               'max_abs_err': err, 'check_ok': err <= 1e-7,
               'repeat_equal': bool(torch.equal(ks, rs)
                                    and torch.equal(kg, rg)),
               'sha256': hashlib.sha256(
                   ks.cpu().numpy().tobytes() + kg.cpu().numpy().tobytes())
               .hexdigest(),
               'issued_flop': stamp_flop(S, n),
               'issued_fp64_ms': stamp_flop(S, n) / FP64_FLOP_S * 1e3}
        _timed(rec, lambda: launch.psf_stamps(img, xs, ys, valid, n))
        rec['plain_ms'] = call_ms(
            lambda: zogy.psf_stamps_plain(img, xs, ys, valid, n), 1, 3)
        rec['bound_ms'], rec['bound_by'] = stamps_bound(S, n)
        rec['ok'] = (rec['good_equal'] and rec['check_ok']
                     and rec['repeat_equal'])
        yield rec


def device_events(fn, reps=5):
    """The device activities (kernels, memsets, copies) of one call of
    ``fn`` by name, from torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    counts = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            counts[ev.name] = counts.get(ev.name, 0) + 1
    return {k: v / reps for k, v in counts.items()}


def h16_cases(dev, frames):
    from zuds_tpu_torch.bench_compact import call_ms
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import zogy
    new, aligned, pos, (sn, sr) = frames
    H, W = new.shape
    psfs = [zogy.estimate_psf_from_stars(img, *pos) for img in (new, aligned)]
    sc = zogy.zogy_scalars(sn, sr)
    spectra = [torch.fft.rfft2(new), torch.fft.rfft2(aligned),
               zogy._psf_to_otf(psfs[0], (H, W)),
               zogy._psf_to_otf(psfs[1], (H, W))]
    kk = zogy.spectral_pass(*spectra, **sc)
    p_d = torch.fft.irfft2(kk[1], s=(H, W)).contiguous()
    s = torch.fft.irfft2(kk[2], s=(H, W)).contiguous()
    rng = np.random.default_rng(81)
    tail = [torch.as_tensor((rng.normal(size=(250, 197)) * a).astype('f4'),
                            device=dev) for a in (1e-3, 5.0)]
    # a view 4 bytes past a 16-byte boundary: the single-float path
    big = torch.as_tensor((rng.normal(size=H * W + 1) * 1e-3).astype('f4'),
                          device=dev)
    cases = [('h16_zogy', p_d, s, sc['f_d']),
             ('h16_250x197', tail[0], tail[1], 0.7),
             ('h16_zogy_offset', big[1:].view(H, W), s, sc['f_d'])]
    for case, a, b, f_d in cases:
        k = launch.zogy_normalize(a, b, f_d)
        p = zogy.score_normalize_plain(a, b, f_d)
        r = launch.zogy_normalize(a, b, f_d)
        err = float(((k - p).abs() / p.abs().clamp(min=1e-30)).max())
        n = a.numel()
        rec = {'case': case, 'shape': list(a.shape),
               'max_abs_err': float((k - p).abs().max()), 'max_rel_err': err,
               'check_ok': err <= 1e-6,
               'repeat_equal': bool(torch.equal(k, r)),
               'sha256': hashlib.sha256(k.cpu().numpy().tobytes())
               .hexdigest(),
               'events': device_events(
                   lambda: launch.zogy_normalize(a, b, f_d))}
        _timed(rec, lambda: launch.zogy_normalize(a, b, f_d))
        rec['plain_ms'] = call_ms(
            lambda: zogy.score_normalize_plain(a, b, f_d), 1, 3)
        rec['norm_ms'] = call_ms(lambda: torch.linalg.vector_norm(a))
        rec['bound_ms'], rec['bound_by'] = bound(12 * n, 3 * n)
        rec['ok'] = rec['check_ok'] and rec['repeat_equal'] and not any(
            'memset' in e.lower() for e in rec['events'])
        yield rec


def h18_cases(frames):
    from zuds_tpu_torch.bench_compact import call_ms, graph_ms
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import zogy
    for case, (st, g0) in psf_inputs(frames).items():
        kp, kg = launch.psf_clip(st, g0, 2)
        pp, pg = zogy.psf_clip_plain(st, g0, 2)
        rp, rg = launch.psf_clip(st, g0, 2)
        S, k1, k2 = st.shape
        err = float((kp - pp).abs().max())
        rec = {'case': case, 'stamps': S, 'good0': int(g0.sum()),
               'good': int(kg.sum()), 'good_equal': bool(torch.equal(kg, pg)),
               'max_abs_err': err, 'check_ok': err <= 1e-7,
               'repeat_equal': bool(torch.equal(kp, rp)
                                    and torch.equal(kg, rg)),
               'sha256': hashlib.sha256(
                   kp.cpu().numpy().tobytes() + kg.cpu().numpy().tobytes())
               .hexdigest()}
        _timed(rec, lambda: launch.psf_clip(st, g0, 2))
        rec['plain_ms'] = call_ms(lambda: zogy.psf_clip_plain(st, g0, 2), 1,
                                  3)
        rec['bound_ms'], rec['bound_by'] = bound(
            S * k1 * k2 * 4 + 2 * S + k1 * k2 * 4, 3 * 6 * S * k1 * k2)
        # a pass's cost: the same stamps at 0-3 passes
        rec['iters_ms'] = [graph_ms(lambda: launch.psf_clip(st, g0, i))
                           for i in range(4)]
        rec['ok'] = (rec['good_equal'] and rec['check_ok']
                     and rec['repeat_equal'])
        yield rec


def _timed(rec, fn):
    from zuds_tpu_torch.bench_compact import call_ms, graph_ms
    rec['graph_ms'] = graph_ms(fn)
    rec['call_ms'] = call_ms(fn)


def slice_frame(dev):
    """The slice's frame 0 through the pipeline: its configuration, its
    science frame and the pipeline's output."""
    from zuds_tpu_torch import inputs, night
    from zuds_tpu_torch.parallel import SubtractDetectPipeline
    cfg = night.FLAGSHIP
    args, _ = inputs.plant_sources(
        inputs.synth_inputs(1, cfg.height, cfg.width, cfg, seed=0), n=3,
        flux=2e4, seed=1)
    targs = inputs.to_torch(args, dev)
    out = SubtractDetectPipeline(cfg)(*targs)
    return cfg, targs[0][0].contiguous(), out


def seeded_rows(n, H, W, dev, seed=18):
    """n seeded positions over an H x W frame (a few past its edges) and
    seeded shapes: every row distinct."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(v.astype('f4'), device=dev) for v in (
        rng.uniform(-5, W + 5, n), rng.uniform(-5, H + 5, n),
        rng.uniform(0.3, 4.0, n), rng.uniform(0.3, 2.0, n),
        rng.uniform(-1.6, 1.6, n), rng.uniform(1.0, 6.0, n)))


def refine_cases(cfg, sci, out, dev, libs):
    from zuds_tpu_torch.bench_warp import star_field
    from zuds_tpu_torch.kernels import checks, launch
    from zuds_tpu_torch.ops import detect
    from zuds_tpu_torch.ops import measure as ms
    diff, rms = out['diff'][0].contiguous(), out['rms'][0].contiguous()
    H, W = diff.shape
    keys = ('x', 'y', 'a', 'b', 'theta', 'fwhm')
    cases = {'h23_slice': (diff, rms, tuple(
        out[f'det_{k}'][0].contiguous() for k in keys))}
    # a pair catalog's rows: the valid detections of a star field
    field = torch.as_tensor(star_field(H, W, 21), device=dev) - 150.0
    frms = torch.full_like(field, 5.0)
    det = detect.detect_sources(field, frms, max_det=cfg.max_det,
                                return_labels=False, det_cap=cfg.det_cap,
                                deb_cap=cfg.deb_cap)
    idx = torch.nonzero(det['valid']).reshape(-1)
    cases['h23_pairlike'] = (field.contiguous(), frms, tuple(
        det[k][idx].contiguous() for k in keys))
    # every row distinct: seeded positions and shapes over the science
    # frame (sky 150 counts, stars, noise 5), and over the slice's diff,
    # where most windows hold noise alone about 0 (printed, not gated: the
    # centroid of max(noise, 0) moves with the sums' order past the
    # check's tolerance at a few rows, in any order)
    cases['h23_distinct'] = (sci, rms, seeded_rows(cfg.max_det, H, W, dev))
    cases['h23_distinct_diff'] = (diff, rms, seeded_rows(cfg.max_det, H, W,
                                                         dev))
    for case, (img, r, args) in cases.items():
        n = args[0].numel()
        k = launch.refine_detections(img, r, *args, CUT)
        k2 = launch.refine_detections(img, r, *args, CUT)
        rec = {'case': case, 'rows': n, 'distinct': distinct_rows(args),
               'repeat_equal': all(torch.equal(k[key].nan_to_num(7.0),
                                               k2[key].nan_to_num(7.0))
                                   for key in k),
               'sha256': hashlib.sha256(torch.stack(
                   [k[key] for key in launch.REFINE_KEYS]).cpu().numpy()
                   .tobytes()).hexdigest()}
        p = ms.refine_detections_plain(img, r, *args)
        try:
            gaps, near, crossed = checks.refine_check(img, r, args, k, p)
            rec.update(check_ok=True, max_gap=max(gaps.values()),
                       near_edge=near, between_auto_edges=crossed)
        except AssertionError as e:
            rec.update(check_ok=False, check_error=str(e)[:300])
        _timed(rec, lambda: launch.refine_detections(img, r, *args, CUT))
        rec['bound_ms'], rec['bound_by'] = refine_bound(n, rec['distinct'])
        rec['all_rows_bound_ms'] = refine_bound(n, n)[0]
        rec['probes'] = {}
        for (src, name), lib in libs.items():
            if src != 'measure.cu':
                continue
            from zuds_tpu_torch.bench_compact import graph_ms
            pk = variant_refine(lib, img, r, args)
            same = torch.equal(pk.nan_to_num(7.0), torch.stack(
                [k[key] for key in launch.REFINE_KEYS]).nan_to_num(7.0))
            rec['probes'][name] = {'graph_ms': graph_ms(
                lambda: variant_refine(lib, img, r, args)),
                'bit_equal_to_default': same}
        rec['ok'] = rec['repeat_equal'] and (rec['check_ok']
                                             or case == 'h23_distinct_diff')
        yield rec


def profile_split(fn, reps=20):
    """Device microseconds per call of each kernel ``fn`` launches, by
    name, from torch.profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, 'device_time_total', None)
        if us is None:
            us = getattr(ev, 'cuda_time_total', 0.0)
        name = re.search(r'([A-Za-z0-9]+_kernel)', ev.key)
        if us and name:
            split[name.group(1)] = split.get(name.group(1), 0.0) + us / reps
    return split


def stats_case(cfg, out, libs):
    from zuds_tpu_torch.bench_compact import graph_ms
    from zuds_tpu_torch.constants import BAD_SUM
    from zuds_tpu_torch.kernels import checks, launch
    from zuds_tpu_torch.ops import detect
    diff, rms, mask = out['diff'][0], out['rms'][0], out['submask'][0]
    taps = detect.detect_taps(diff, rms, mask, (mask & BAD_SUM) == 0,
                              nsigma=cfg.nsigma, max_det=cfg.max_det,
                              det_cap=cfg.det_cap, deb_cap=cfg.deb_cap)
    args = taps['stats']
    cap, nseg = args[0].numel(), args[9]
    counts = torch.bincount(args[0], minlength=nseg)
    rec = {'case': 'h26_slice', 'entries': cap, 'rows': nseg,
           'live_rows': int((counts > 0).sum()),
           'longest_row': int(counts.max()),
           'discard_row': int(counts[-1])}
    try:
        rec['max_gap'] = checks.stats_check(args)
        rec['check_ok'] = True
    except AssertionError as e:
        rec.update(check_ok=False, check_error=str(e)[:300])
    first = launch.object_stats(*args)
    again = launch.object_stats(*args)
    rec['repeat_equal'] = all(
        torch.equal(first[k].nan_to_num(7.0), again[k].nan_to_num(7.0))
        for k in first)
    _timed(rec, lambda: launch.object_stats(*args))
    rec['bound_ms'], rec['bound_by'] = bound(
        30 * cap + 8 + 81 * nseg, STATS_OPS[0] * cap + STATS_OPS[1] * nseg)
    rec['split_us'] = profile_split(lambda: launch.object_stats(*args))
    rec['probes'] = {name: graph_ms(lambda: variant_stats(lib, args))
                     for (src, name), lib in libs.items()
                     if src == 'objects.cu'}
    rec['ok'] = rec['check_ok'] and rec['repeat_equal']
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=str(_HERE.parent))
    ap.add_argument('--tag', default='')
    ap.add_argument('--out', default=None)
    ap.add_argument('--cases',
                    default='h5,h25,h23,h26,h24,h22,h27,h12,h14,h18,h17,h16',
                    help='comma-separated prefixes of the case groups to '
                    'run (h5, h25, h23, h26, h24, h22, h27, h12, h14, h18, '
                    'h17, h16)')
    ap.add_argument('--phot', default=None,
                    help='the forced positions and frames chip_smoke.py '
                    'saves where ZUDS_PHOT_INPUTS points (case h22_forced)')
    args = ap.parse_args(argv)
    wanted = tuple(args.cases.split(','))
    # the sources of the case groups asked for
    sources = sorted({src for group, src in (
        ('h5', 'deblend.cu'), ('h25', 'ccl.cu'), ('h23', 'measure.cu'),
        ('h26', 'objects.cu'), ('h24', 'ccl.cu'), ('h22', 'photometry.cu'),
        ('h27', 'objects.cu'), ('h12', 'cutouts.cu'), ('h14', 'cutouts.cu'),
        ('h18', 'zogy.cu'), ('h17', 'zogy.cu'), ('h16', 'zogy.cu'))
        if group.startswith(wanted)})
    if not torch.cuda.is_available():
        sys.exit('bench_detect: no CUDA device')
    sys.path.insert(0, args.root)
    from zuds_tpu_torch.bench_compact import graph_ms
    from zuds_tpu_torch.bench_stats import sass_counts
    from zuds_tpu_torch.kernels import build
    from zuds_tpu_torch.kernels.launch import _stream
    t0 = time.perf_counter()
    build.library()
    print(f'{args.tag}: library built and loaded in '
          f'{time.perf_counter() - t0:.1f} s from {args.root}', flush=True)
    dev = torch.device('cuda')
    sink = open(args.out, 'a') if args.out else None
    failed = []

    def emit(rec):
        rec['tag'] = args.tag
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + '\n')
            sink.flush()
        if not rec.get('ok', True):
            failed.append(rec['case'])

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        libs, empty = build_probes(args.root, tmp, sources)
        print(f'{args.tag}: {len(libs)} probe builds in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)

        def empty_launch():
            err = empty.zuds_empty(_stream())
            if err:
                raise RuntimeError(f'empty kernel: CUDA error {err}')
        emit({'case': 'empty', 'graph_ms': graph_ms(empty_launch)})
        t0 = time.perf_counter()
        cfg, sci, out = slice_frame(dev)
        torch.cuda.synchronize()
        print(f'{args.tag}: slice frame in {time.perf_counter() - t0:.1f} s',
              flush=True)
        if 'h5'.startswith(wanted):
            for rec in h5_cases(cfg, out, dev, libs):
                emit(rec)
        if 'h25'.startswith(wanted):
            emit(h25_case(cfg, out))
        if 'h23'.startswith(wanted):
            for rec in refine_cases(cfg, sci, out, dev, libs):
                emit(rec)
        if 'h26'.startswith(wanted):
            emit(stats_case(cfg, out, libs))
        if 'h24'.startswith(wanted):
            for rec in h24_cases(cfg, out, dev):
                emit(rec)
        if 'h22'.startswith(wanted):
            for rec in h22_cases(cfg, sci, out, dev, args.phot):
                emit(rec)
        if 'h27'.startswith(wanted):
            for rec in h27_cases(cfg, out, dev):
                emit(rec)
        if 'h12'.startswith(wanted):
            for rec in h12_cases(cfg, tmp):
                emit(rec)
        if 'h14'.startswith(wanted):
            for rec in h14_cases(cfg, out, dev, tmp):
                emit(rec)
        frames = None
        if any(g.startswith(wanted) for g in ('h18', 'h17', 'h16')):
            frames = zogy_frames(cfg, dev, tmp)
        if 'h18'.startswith(wanted):
            for rec in h18_cases(frames):
                emit(rec)
        if 'h17'.startswith(wanted):
            for rec in h17_cases(dev, frames):
                emit(rec)
        if 'h16'.startswith(wanted):
            for rec in h16_cases(dev, frames):
                emit(rec)
    lib_path = Path(build.library()._name)
    emit({'case': 'sass', 'sass': sass_counts(
        lib_path, r'refine|rank_kernel|offsets|place|tree|rows_kernel'
        r'|deblend_labels|ccl_|seed_kernel|aperture_kernel|clean_'
        r'|triplet_cut|negpix_veto|psf_clip|psf_stamps|normalize')})
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    emit({'case': 'card', 'card': card})
    for src in sources:
        report = build.ptxas_report(src)
        emit({'case': f'ptxas_{src}', 'report': [
            line.strip() for line in report.splitlines()
            if 'Compiling' in line or 'registers' in line
            or 'spill' in line]})
    if sink:
        sink.close()
    if failed:
        sys.exit(f'bench_detect: checks failed: {failed}')


if __name__ == '__main__':
    main()
