#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from the sources in this checkout,
drives the port's main path (``SubtractDetectPipeline``, the quadrant
subtract -> detect slice with the reference's default ``deblend=True``) on
two 3080x3072 ZTF-sized frames from a seed, then the same path with
``deblend=False``, both timed in turns, and the slice with its frame
medians in H8 against the plain medians, in turns. Then the night: four
flagship FITS pairs written to a temporary directory with the port's own
writer (``bench.py``'s recipe: 700 stars, seeing 2.0/2.8 px, noise 5, the
real ZTF TPV header on the science frames, a linear reference WCS
dithered by (+1.6, -2.2) px, uint16 mask siblings, one transient of flux
3e4 per frame, one frame without SEEING) through
``zuds_tpu_torch.night.run_night`` once to warm up and once timed, with
the files -> catalog rate, the host seconds per phase, the reference-cache
hits and the detections per frame; a fifth pair, whose reference is rotated
by 0.1 degrees, is refused by the batched feed and takes the night's
per-pair fallback (``sub.do_one``), and the night records its count. Then
the db phase on the same pairs: a temporary sqlite file and config,
``run_night`` at its default ``db=True`` (counted), the ``sesub`` records,
``Detection`` rows and three thumbnails a detection checked against the
catalogs and the frames, one ``Source`` a detection and 4096 forced
positions, and ``phot.main`` (dophot's worker, counted: one H22 launch a
subtraction) checked against the anti-join, with the host seconds of the
commits, the thumbnails and each ``phot.do_one``. Then the coadd: eight
dithered epochs
of one quadrant (``inputs.write_coadd_epochs``, ``bench.py``'s coadd
recipe, one cosmic ray planted in one epoch) through
``ScienceCoadd.from_images`` once to warm up, once counted and timed
(epochs/s, files -> stack, and the host seconds per phase) and once with
the seeing estimate, and once more with a database bound (one
``scicoadd`` record, one ``CoaddImage`` join an epoch); the product's
header, noise, no-data bit and the clipped cosmic ray are checked, H9 and the two-plane H1 are held against
their plain versions on the phase's own stack, and a 4-epoch 512^2 stack
runs on the card and on the CPU. Then the reference build: sixteen epochs
of the same scene with SEEING, MAGLIM and INFOBITS cards registered in a
fresh sqlite file, ``queryref`` (one line) and ``makeref.do_one`` on it
(14 pass the cut; counted; the ``ref`` record and its version); the 14
again with seeded header WCS errors through
``ReferenceImage.from_images`` unsolved and with ``solve_astrometry=True``
against a Gaia-like cache of the scene's stars and without one, counted
(a catalog chain an epoch), each refit WCS held to the true star positions
and each stack's SEEING and star flux to the true-WCS stack's, with the
host seconds of the load, the catalogs, the fit, the stack and the write.
Then the per-pair path: ``sub.do_one`` on
a pair whose reference is rotated by 0.5 degrees (the gather warp H10, H3
for the model and for the variance, the epilogue H11), once to warm up and
once timed on a fresh copy, and once on an unrotated pair (the planned
warp, H1), with the host seconds of each step beside the fused pair's;
H10, H3 at one term and H11 against their plain versions on that pair's
tensors; a 256^2 rotated pair on the card and on the CPU. Holds each
kernel against its plain
PyTorch version on the card at the shapes the main path gives it (H3 also
at K = 21, order 5, 2x2 regions, and its bare launch timed with its
tensor-core rate; H5 bit-equal on slice frames 0 and 1, a quadrant-size
busy blend field and an all-live 65,536-slot graph, timed by CUDA graph
and per call, its floor beside; H6 also on the blend field, timed by CUDA
graph beside ``torch.nonzero_static`` at the slice's four
call sites and at ``label_components``' size; H8 also on ::4 views and a
mask with holes, timed by CUDA graph and per call, the view's bound from
the sectors it reads; H2 bit-equal on the slice's frame and on an epoch
of the coadd's canvas, timed by CUDA graph and per call; H1, its
two-plane mode and H10 also timed by CUDA graph
and held no further from their plain versions run in float64 than the f32
plain versions, two calls bit-equal). Small inputs run on the card and
on the CPU for each deblend mode (the CPU also fed the card's H1 output,
against which the detection count is held), a 1024^2 crop of the blend
field through
``detect_sources`` on both, and the stamp selection and stamp-moment
SEEING of the night's frame without SEEING on both. Then braai training:
``make_train_state(0)`` on the card and 256 triplets of
``inputs.labelled_triplets``; ``ptxas -v`` of H13, H19 and H20 and the
launch resources of H19 and H20; one step's own tensors hold H13t, H19,
H20 and H21 against their plain versions (times, bounds, cuDNN's and
fused Adam's times beside them; H13t, H19 and H20 two calls bit-equal
and, against float64, no further than cuDNN with TF32 off); one step
against ``train_step_plain`` with the same masks; 50 counted, timed steps
with a loss gate, ten more under the profiler (the device's busy share);
the trained weights through ``save_braai``, ``load_braai`` and
``rb_scores`` on the card; one step at the dry run's batch of 2. The
measure stage's kernels are held to their plain versions on the slice's
frame 0 at its 4096 detection rows (H22 at
r = 3 with the submask and at r = 6 on two planes, H23, H14 at the
pipeline's H8 medians); H22 and H23 also at 4096 seeded positions over
the science frame, every row distinct. Forced photometry: one flagship pair through
``sub.do_one``, the product read back by ``ScienceImage.from_file``, 4096
seeded positions (``inputs.forced_positions``), dophot's
``aperture_photometry`` call, ``raw_aperture_photometry`` on the three
product files and the call again with the background mesh, counted and
timed; the transient's forced flux, the off-frame rows and the masked rows
checked, the blank-sky pulls printed, H22 held to its plain version at
those positions and the sha256 of its outputs there printed (with
``ZUDS_PHOT_INPUTS=FILE`` in the environment, the frames and positions
are saved to FILE for ``bench_detect.py --phot``). The alert phase, in
a directory and sqlite files of its own: two flagship pairs registered as
``sci``/``ref`` records, ``control.controller.run_once`` with its local
launcher (the ``nightly`` worker as a process on the card, ml=True, in
the frames' directory: the work list holds basenames), its ``sesub``
records and detections checked; then copies of the pairs through
``sub.do_one`` (ml=False) in this process, a known source and a local PS1
and DR8 row 1 arcsec from each transient, ``makesources.associate``,
``phot_controller.main`` (the ``phot`` worker as a process on the card),
``makealert.main`` and ``doalert.main`` (the thin alerts of detections
read from the database), and ``Alert.from_detection`` of the detections
with their subtraction attached, ``send_alert`` to the spool and
``read_avro``: the crossmatch blocks, the three cutouts, the light curve
and each spooled file held to ``alert_to_record``; host seconds per
step. The detect stage: ``detect_sources`` on the slice's two
frames through H24-H27 (the seeds, the base components, the per-object
statistics, CLEAN) against the same call with their plain versions, at
the three deblend modes; each of the four against its plain version on
frame 0's own inputs (H24 on its mask and compact list), timed (H27 also
on 4098 crowded seeded rows, ``bench_detect.clean_rows``, two calls
bit-equal), H24 and
H25 also on scenes whose last pixel is detected (alone and joined, the list padded and overflowing, from the
seeds and the identity); the profiler's count of host copies and
waits inside the ``ccl``, ``stats`` and ``clean`` ranges (0). The
surface phase: ``run_sextractor`` on a flagship frame with every check
image, the archive daemon's round trip of two flagship frames (bytes
unchanged), ``tracing.device_profile`` over one slice frame (its trace
names H1's and H3's launches) and the demo twin at 512^2; dothumb's twin
persists the db phase's thumbnails there (each PNG its stamp's zscale
levels). The mesh phase: the slice's batch through a world of one over
NCCL, then two ranks over gloo sharing the card (one ``spawn``): a
flagship frame each, the coadd's rows over 'space' at both
``subtract_back``, braai's step at 256, each against the single-process
run (bit-equal but the step). Prints the
card,
per-kernel errors and times, the slice's ms/frame and the deblend's
load, then one JSON line of kernel records
and, last, ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero; a machine without a CUDA card fails at once.
"""
import dataclasses
import filecmp
import hashlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

# the CPU parity tests' configuration (tests/test_torch_pipeline.py)
SMALL = dict(height=256, width=256, ksize=9, stamp=25, smax=32, order=2,
             nreg=2, max_det=128, box=64)
# the busy blend field: tests/test_detect.py's recipe at quadrant size,
# with as many stars as keep the detected pixels under det_cap
BUSY = dict(nsigma=5.0, max_det=4096, det_cap=1 << 16, deb_cap=1 << 16)
BUSY_STARS = 620
SOURCES = {
    'warp': ('cuda', 'zuds_tpu_torch/kernels/warp.cu',
             'zuds_tpu/ops/resample.py:275'),
    'background_cells': ('cuda', 'zuds_tpu_torch/kernels/background.cu',
                         'zuds_tpu/ops/background.py:108'),
    'apply_model': ('cuda', 'zuds_tpu_torch/kernels/apply.cu',
                    'tools/bench_apply.py:218'),
    'detect_filter': ('cuda', 'zuds_tpu_torch/kernels/detect_filter.cu',
                      'zuds_tpu/ops/detect.py:607'),
    'deblend_labels': ('cuda', 'zuds_tpu_torch/kernels/deblend.cu',
                       'zuds_tpu/ops/detect.py:487'),
    'compact': ('cuda', 'zuds_tpu_torch/kernels/compact.cu',
                'zuds_tpu/ops/detect.py:86'),
    'stamp_candidates': ('cuda', 'zuds_tpu_torch/kernels/stamps.cu',
                         'zuds_tpu/ops/measure.py:37'),
    'frame_median': ('cuda', 'zuds_tpu_torch/kernels/median.cu',
                     'zuds_tpu/ops/background.py:48'),
    'warp_two_planes': ('cuda', 'zuds_tpu_torch/kernels/warp.cu',
                        'zuds_tpu/parallel/pipeline.py:482'),
    'clipped_combine': ('cuda', 'zuds_tpu_torch/kernels/coadd.cu',
                        'zuds_tpu/ops/coadd.py:42'),
    'warp_gather': ('cuda', 'zuds_tpu_torch/kernels/warp.cu',
                    'zuds_tpu/ops/resample.py:484'),
    'apply_model_variance': ('cuda', 'zuds_tpu_torch/kernels/apply.cu',
                             'zuds_tpu/ops/subtract.py:692'),
    'apply_model_one_term': ('cuda', 'zuds_tpu_torch/kernels/apply.cu',
                             'zuds_tpu/ops/subtract.py:380'),
    'subtract_epilogue': ('cuda', 'zuds_tpu_torch/kernels/subtract.cu',
                          'zuds_tpu/ops/subtract.py:652'),
    'triplet_cut': ('cuda', 'zuds_tpu_torch/kernels/cutouts.cu',
                    'zuds_tpu/filterobjects.py:64'),
    'braai_conv3x3': ('cuda', 'zuds_tpu_torch/kernels/braai.cu',
                      'zuds_tpu/models/braai.py:27'),
    'negpix_veto': ('cuda', 'zuds_tpu_torch/kernels/cutouts.cu',
                    'zuds_tpu/filterobjects.py:37'),
    'zogy_spectral': ('cuda', 'zuds_tpu_torch/kernels/zogy.cu',
                      'zuds_tpu/ops/zogy.py:56'),
    'zogy_normalize': ('cuda', 'zuds_tpu_torch/kernels/zogy.cu',
                       'zuds_tpu/ops/zogy.py:74'),
    'psf_stamps': ('cuda', 'zuds_tpu_torch/kernels/zogy.cu',
                   'zuds_tpu/ops/zogy.py:89'),
    'psf_clip': ('cuda', 'zuds_tpu_torch/kernels/zogy.cu',
                 'zuds_tpu/ops/zogy.py:116'),
    'braai_conv3x3_train': ('cuda', 'zuds_tpu_torch/kernels/braai.cu',
                            'zuds_tpu/models/braai.py:96'),
    'braai_conv3x3_dgrad': ('cuda', 'zuds_tpu_torch/kernels/braai.cu',
                            'zuds_tpu/models/braai.py:102'),
    'braai_conv3x3_wgrad': ('cuda', 'zuds_tpu_torch/kernels/braai.cu',
                            'zuds_tpu/models/braai.py:102'),
    'adam_step': ('cuda', 'zuds_tpu_torch/kernels/adam.cu',
                  'zuds_tpu/models/braai.py:103'),
    'aperture_photometry': ('cuda', 'zuds_tpu_torch/kernels/photometry.cu',
                            'zuds_tpu/ops/photometry.py:64'),
    'aperture_photometry_distinct': ('cuda',
                                     'zuds_tpu_torch/kernels/photometry.cu',
                                     'zuds_tpu/ops/photometry.py:64'),
    'aperture_sums': ('cuda', 'zuds_tpu_torch/kernels/photometry.cu',
                      'zuds_tpu/parallel/pipeline.py:306'),
    'refine_detections': ('cuda', 'zuds_tpu_torch/kernels/measure.cu',
                          'zuds_tpu/ops/measure.py:139'),
    'seed_sweeps': ('cuda', 'zuds_tpu_torch/kernels/ccl.cu',
                    'zuds_tpu/ops/detect.py:657'),
    'ccl_fixpoint': ('cuda', 'zuds_tpu_torch/kernels/ccl.cu',
                     'zuds_tpu/ops/detect.py:667'),
    'object_stats': ('cuda', 'zuds_tpu_torch/kernels/objects.cu',
                     'zuds_tpu/ops/detect.py:840'),
    'clean': ('cuda', 'zuds_tpu_torch/kernels/objects.cu',
              'zuds_tpu/ops/detect.py:954'),
}
# the kernels only the coadd path launches (the second plane of H1 is a
# mode of the 'warp' wrapper, recorded under its own name)
COADD_ONLY = ('clipped_combine',)
# the kernels only the per-pair path launches (sub.do_one: the night's
# fallback pair and the per-pair phase)
PAIR_ONLY = ('warp_gather', 'apply_model_variance', 'subtract_epilogue')
# the kernels of the scoring path: H12 and H13 run only at ml=True
ML_ONLY = ('triplet_cut', 'braai_conv3x3')
# the measure stage's launches per slice frame: H22 in both modes, H23,
# H14 (besides H8's medians)
MEASURE_LAUNCHES = {'aperture_photometry': 1, 'aperture_sums': 1,
                    'refine_detections': 1, 'negpix_veto': 1}
# operations, counted from the sources (a transcendental as one), by the
# branch each pixel takes in this run's data. H22 (photometry.cu): its
# distinct rows' corner grids and pixels (bench_detect.aperture_ops). H23
# (measure.cu), per window pixel: four
# centroid iterations of 15, the moments 36, the Kron pass 21 and the AUTO
# pass 18 (REFINE_OPS_PX), and two sums and a square for a pixel inside
# the AUTO ellipse (REFINE_AUTO_OPS).
# the detect stage's launches per slice frame: H24, H25, H26, H27 (at
# every deblend mode)
DETECT_LAUNCHES = {'seed_sweeps': 1, 'ccl_fixpoint': 1, 'object_stats': 1,
                   'clean': 1}
# operations, counted from the sources: H24 9 a detected pixel a sweep (8
# minima and the mask's select); H25 4 a backward edge (two finds' first
# steps, the compare, the hook); H26 25 an entry (its 6 products, 8 tree
# adds, 9 maxima, minima and ORs, 2 conversions) and 40 a row (the
# epilogue); H27 3 a pair of valid rows (the tests and the sum's add) and
# 14 more for each brighter valid neighbour (the wing: 11 for r2, its
# scale, the add, powf as one, the product)
SEED_OPS = 9
CCL_OPS = 4
STATS_OPS = (25, 40)
CLEAN_OPS = (3, 14)
CLEAN_CROWDED = 4098    # H27 also timed on as many seeded rows
REFINE_OPS_PX = 135
REFINE_AUTO_OPS = 3
# the forced-photometry phase: dophot's call on a flagship subtraction at
# PHOT_N positions (inputs.forced_positions); the transient's forced flux
# within PHOT_FLUX_TOL of its planted flux times the Gaussian's enclosed
# fraction at r = 3 px
PHOT_N = 4096
PHOT_FLUX_TOL = 0.15
# the db phase: the night's pairs again through run_night at its default
# db=True into a temporary sqlite file, one Source per detection and
# PHOT_N forced positions (seed 13) on subtraction 0's WCS, DB_MEASURED of
# them given a forcedphotometry row on subtraction 0 before phot.main;
# each transient's forced flux (but on the frame without SEEING, which
# keeps no detection) within PHOT_FLUX_TOL of the phot phase's measured one
DB_MEASURED = 64
# the alert phase: ALERT_PAIRS flagship pairs of the night's scene; a
# worker process the controller starts must end within ALERT_WAIT_S
ALERT_PAIRS = 2
ALERT_WAIT_S = 600
# the kernels only the ZOGY subtraction launches (from_images at
# method='zogy'), and how often per pair: two PSFs, one spectral pass
ZOGY_LAUNCHES = {'zogy_spectral': 1, 'zogy_normalize': 1, 'psf_stamps': 2,
                 'psf_clip': 2}
ZOGY_ONLY = tuple(ZOGY_LAUNCHES)
ZOGY_STAMPS = 64        # _select_stamps(sci, smax=64)
ZOGY_EVEN_STAMP = 24    # H17 at an even size beside the path's 25
# braai training (make_train_state, train_step): the kernels only it
# launches and how often per step (H13t on the four layers, H19 on layers
# 2-4, H20 on the four, H21 once); TRAIN_N triplets a step at full width,
# TRAIN_STEPS counted steps; the mean loss of the last 10 steps must lie
# TRAIN_LOSS_DROP below the first 10's (a CPU rehearsal of the same set:
# 0.608 -> 0.018, PERF.md); the dry run's batch (__graft_entry__.py:195)
TRAIN_LAUNCHES = {'braai_conv3x3_train': 4, 'braai_conv3x3_dgrad': 3,
                  'braai_conv3x3_wgrad': 4, 'adam_step': 1}
TRAIN_ONLY = tuple(TRAIN_LAUNCHES)
TRAIN_N = 256
TRAIN_STEPS = 50
TRAIN_LR = 3e-4
TRAIN_LOSS_DROP = 0.25
TRAIN_DRYRUN_N = 2
# the mesh phase's coadd: epochs (and one padded) with rows over 2 ranks
MESH_EPOCHS = 4
MESH_TIMEOUT_S = 300     # the two ranks' start-up and legs
# the scoring phase: N candidates and triplets for the kernels' records;
# the night's filter (FILTERID 2) cuts at RB_CUT[2]
SCORE_N = 256
TRIPLET_MORE = 2048     # H12 also timed at as many candidates
RB_CUT_ZR = 0.3
# seconds of the 0.5 deg pair's filter step when its frames branch ran on
# the host (PERF.md, section 6)
HOST_FILTER_S = 3.098
# the night phase: bench.py's files leg recipe at the flagship size, and
# one more pair whose reference is rotated past the max_shift bucket
NIGHT_PAIRS = 4
NIGHT_BATCH = 2
NO_SEEING = 3           # the science frame written without SEEING
FALLBACK = 4            # the pair that takes the per-pair fallback
FALLBACK_ROT = 0.1      # degrees: residual ~3 px after the pre-roll
PAIR_ROT = 0.5          # degrees, the per-pair phase: residual ~14 px
# the coadd phase: bench.py's coadd leg (8 epochs of one quadrant); the
# cosmic ray is (epoch, x, y, counts) in that epoch's frame
COADD_EPOCHS = 8
COSMIC = (3, 1500, 1600, 500.0)
COADD_NOISE = 5.0
# the reference build: REF_EPOCHS epochs of the coadd scene with SEEING,
# MAGLIM and INFOBITS cards; REF_BAD_SEEING is written at 3.0 arcsec and
# REF_BAD_INFOBITS with INFOBITS 4, so makeref's quality cut keeps 14. The
# same 14 epochs then carry header WCS errors (inputs.WCS_ERR_*: CRPIX up
# to 1.2 px, rotation up to 0.01 deg, a degree-3 distortion of 0.3 px at
# the corners in every second epoch) and are solved twice. Each refit WCS
# maps the true star positions within REF_SOLVE_RMS_PX (rms) and
# REF_SOLVE_MAX_PX (max); each solved stack's SEEING lies within
# REF_FWHM_SHARE of the true-WCS stack's and its stars' median r = 3 px
# flux within REF_FLUX_SHARE. The unsolved stack's FWHM does not show its
# error (the CLIPPED combine clips the misaligned cores: its SEEING read
# 1.9% narrower on the H100, PERF.md); its stars' flux, 43% low there,
# must lie beyond REF_FLUX_SHARE
REF_EPOCHS = 16
REF_BAD_SEEING = 5
REF_BAD_INFOBITS = 11
REF_SOLVE_RMS_PX = 0.05
REF_SOLVE_MAX_PX = 0.25
REF_FWHM_SHARE = 0.03
REF_FLUX_SHARE = 0.02
# the detect-and-measure chain's launches per catalog
# (PipelineFITSCatalog.from_image: H4, H24-H27, H22 at r = 3 px, H23)
CATALOG_LAUNCHES = {'detect_filter': 1, 'seed_sweeps': 1, 'ccl_fixpoint': 1,
                    'object_stats': 1, 'clean': 1, 'aperture_photometry': 1,
                    'refine_detections': 1}
# deeper stacks for H9 (a reference takes up to ~50 epochs), held to the
# plain version on their first DEEP_BAND rows
DEEP_EPOCHS = (33, 50, 64)
DEEP_BAND = 512
# f32 operations a pixel of H1's and H10's function (kernels/warp.cu) as
# the plain versions define it, whatever the kernel does, an FMA as two:
# the 12 weights lanczos3(t) = sinc(t) sinc(t / 3) (t, t / 3, the two
# pi x and the product: 60), the 36 weight products wx wy and their sum,
# the normaliser (36), and each plane's 36 multiply-adds (72). Their 24
# sines and 24 divisions (and a plane's normalising division) are not
# f32 multiply-adds, and the data sheet gives no peak for them: they enter
# no bound.
# WARP_FLOP_PX: (one plane, each more plane).
WARP_FLOP_PX = (60 + 36 + 72 + 36, 72)
# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
TF32_FLOP_S = 495e12


def card():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=2, reps=10):
    """Mean device time of ``fn()`` in ms, from CUDA events after warmup."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20):
    """Mean device time of ``fn()`` in ms without the host's cost per call:
    ``reps`` calls captured once in a CUDA graph (after a warm-up call on a
    side stream), the graph replayed once to warm up and once between two
    CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def close(name, got, want, rtol, atol):
    """Max abs error of ``got`` against ``want``; fail past rtol/atol."""
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    check(bad == 0, f'{name}: {bad} elements past rtol={rtol} atol={atol}'
          f' (max abs err {float(err.max()):.3g})')
    return float(err.max())


def bound(nbytes, flop, flop_rate=FP32_FLOP_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flop / flop_rate * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def warp_f64(name, got, plain, want64, covered):
    """The largest errors of a warp kernel's pixels and of its f32 plain
    version's against the plain version run in float64, on the covered
    pixels; fails if the kernel's is the larger."""
    ek = float((got.double() - want64).abs()[covered].max())
    ep = float((plain.double() - want64).abs()[covered].max())
    check(ek <= ep, f'{name}: {ek:.4g} from the float64 plain version, '
          f'further than the f32 plain version ({ep:.4g})')
    return ek, ep


def warp_bound(npx, planes):
    """H1's or H10's bound on ``npx`` output pixels: 28 bytes a pixel
    with one plane and a mask, 8 more a plane; WARP_FLOP_PX operations."""
    one, more = WARP_FLOP_PX
    return bound((28 + 8 * (planes - 1)) * npx,
                 (one + more * (planes - 1)) * npx)


def aperture_bound(xs, ys, mode, px):
    """The bound of one H22 launch at (xs, ys) in ``mode`` ('photometry',
    r = 3, or 'sums', r = 6) with ``px`` bytes a window pixel: the distinct
    rows' windows and every row's position and outputs (25 B; 16 B),
    beside the distinct rows' operations (bench_detect.aperture_ops).
    Returns (distinct rows, bound)."""
    from zuds_tpu_torch.bench_detect import APERTURE_SUM_OPS, aperture_ops
    nd = distinct_rows((xs, ys)).numel()
    cut, row, r = (9, 25, 3.0) if mode == 'photometry' else (15, 16, 6.0)
    return nd, bound(nd * cut * cut * px + xs.numel() * row,
                     aperture_ops(nd, r, APERTURE_SUM_OPS[mode]))


def refine_flop(img, rms, args, k, cut=33):
    """Operations of one H23 launch on detections ``args`` with outputs
    ``k``: REFINE_OPS_PX a window pixel and REFINE_AUTO_OPS for each pixel
    inside its AUTO ellipse (r_ell at H23's centroid)."""
    from zuds_tpu_torch.ops import measure as ms
    xs, ys, a, b, theta, _ = args
    _, _, xx, yy = ms.refine_windows(img, rms, xs, ys, cut)
    r_ell = ms.ellipse_radius(xx, yy, k['xwin'], k['ywin'], a, b, theta)
    inside = int((r_ell <= (ms.KRON_FACT * k['kron_radius'])[:, None, None])
                 .sum())
    return xs.numel() * cut * cut * REFINE_OPS_PX + inside * REFINE_AUTO_OPS


def measure_records(out, record, name, sci):
    """The measure stage's kernels on the slice's frame 0, at its max_det
    detection rows: H22 at r = 3 with the submask and at r = 6 on the two
    planes, H23, and H14 at the pipeline's own H8 medians, each against
    its plain version (and H22 and H23 at N = 0), timed (device time: a
    CUDA graph of 20 launches) beside the plain version and the bound of
    the distinct work; H22 (r = 3) and H23 also on as many seeded rows,
    all distinct, over the science frame
    ``sci`` (sky, stars, noise: on the diff's windows of noise alone the
    centroid of max(noise, 0) is too ill-conditioned for refine_check's
    tolerance in any order of the sums)."""
    import numpy as np
    import torch
    from zuds_tpu_torch.bench_detect import negpix_bound
    from zuds_tpu_torch.constants import BAD_SUM
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.kernels.checks import (aperture_check, refine_check,
                                               sum_gap_bound)
    from zuds_tpu_torch.ops import background, cutouts
    from zuds_tpu_torch.ops import measure as ms
    from zuds_tpu_torch.ops import photometry as ph
    diff, rms, mask = out['diff'][0], out['rms'][0], out['submask'][0]
    H, W = diff.shape
    args = tuple(out[f'det_{k}'][0].contiguous()
                 for k in ('x', 'y', 'a', 'b', 'theta', 'fwhm'))
    xs, ys = args[:2]
    n = xs.numel()
    badf = ((mask & BAD_SUM) > 0).to(torch.float32)
    e = xs[:0]
    check(all(v.numel() == 0 for v in launch.aperture_photometry(
        diff, rms, mask, e, e, 3.0, 9).values())
        and all(v.numel() == 0 for v in launch.aperture_sums(
            rms, badf, e, e, 6.0, 15))
        and all(v.numel() == 0 for v in launch.refine_detections(
            diff, rms, e, e, e, e, e, e, 33).values()),
        'H22 or H23 at N = 0')

    # H22 at r = 3: reads img, rms and mask in each distinct row's 9x9
    # window, every row's position, writes four outputs and oob
    err = aperture_check(diff, rms, mask, xs, ys, 3.0, 'slice r=3')
    nd, bnd = aperture_bound(xs, ys, 'photometry', 12)
    print(f'aperture_photometry: {nd} distinct positions of {n} on the '
          f'slice\'s frame 0', flush=True)
    record('aperture_photometry', err,
           graph_ms(lambda: launch.aperture_photometry(diff, rms, mask, xs,
                                                       ys, 3.0, 9)),
           cuda_ms(lambda: ph.aperture_photometry_batched_plain(
               diff, rms, mask, xs, ys, 3.0), 1, 3), bnd)
    # the same at as many seeded positions over the science frame, every
    # row distinct (dophot's kind of call)
    rng = np.random.default_rng(18)
    dx, dy = (torch.as_tensor(v.astype('f4'), device=diff.device)
              for v in (rng.uniform(-5, W + 5, n), rng.uniform(-5, H + 5, n)))
    err = aperture_check(sci, rms, mask, dx, dy, 3.0, 'distinct r=3')
    record('aperture_photometry_distinct', err,
           graph_ms(lambda: launch.aperture_photometry(sci, rms, mask, dx,
                                                       dy, 3.0, 9)),
           cuda_ms(lambda: ph.aperture_photometry_batched_plain(
               sci, rms, mask, dx, dy, 3.0), 1, 3),
           aperture_bound(dx, dy, 'photometry', 12)[1],
           count_as='aperture_photometry')
    # H22 at r = 6 on two planes against the plain two-plane sums, each
    # within the order bound of its sum of |plane| w
    ka = launch.aperture_sums(rms, badf, xs, ys, 6.0, 15)
    pa = ph.aperture_sums_plain((rms, badf), xs, ys, 6.0)
    rel = sum_gap_bound(225)
    err = 0.0
    for tag, kv, pv in (('rms', ka[0], pa[0]), ('bad', ka[1], pa[1])):
        err = max(err, close(f'slice r=6 {tag} sums', kv, pv, rel, 0.0))
    record('aperture_sums', err,
           graph_ms(lambda: launch.aperture_sums(rms, badf, xs, ys, 6.0,
                                                 15)),
           cuda_ms(lambda: ph.aperture_sums_plain((rms, badf), xs, ys, 6.0),
                   1, 3), aperture_bound(xs, ys, 'sums', 8)[1])

    # H23: two calls bit-identical, then against the plain version
    k1 = launch.refine_detections(diff, rms, *args, 33)
    k2 = launch.refine_detections(diff, rms, *args, 33)
    check(all(torch.equal(k1[key].nan_to_num(7.0), k2[key].nan_to_num(7.0))
              for key in k1), 'H23: two calls differ')
    p = ms.refine_detections_plain(diff, rms, *args)
    gaps, near, crossed = refine_check(diff, rms, args, k1, p)
    print('refine_detections against the plain version (max abs gap, '
          'angles mod pi): '
          + ', '.join(f'{key} {g:.3g}' for key, g in gaps.items()),
          flush=True)
    print(f'refine_detections: {n} rows, {near} with a pixel within 1e-5 '
          f'of an ellipse edge, {crossed} with a pixel between its two '
          f'AUTO edges (H23\'s and the plain formulas\' at H23\'s '
          f'centroid); two calls bit-identical', flush=True)
    # the bound of the distinct work that gives the same outputs: the
    # distinct rows' windows and operations, every row's six inputs and
    # eleven outputs (the rows past the frame's objects share one input)
    one = distinct_rows(args)
    nd = one.numel()
    sub = tuple(a[one] for a in args)
    bnd = bound(nd * 2 * 33 * 33 * 4 + n * (24 + 44),
                refine_flop(diff, rms, sub, {key: v[one]
                                             for key, v in k1.items()}))
    every = bound(n * (2 * 33 * 33 * 4 + 17 * 4),
                  refine_flop(diff, rms, args, k1))
    print(f'refine_detections: {nd} distinct rows of {n}; the bound of '
          f'measuring every row {every[0]:.5f} ms ({every[1]})', flush=True)
    record('refine_detections', max(gaps.values()),
           graph_ms(lambda: launch.refine_detections(diff, rms, *args, 33)),
           cuda_ms(lambda: ms.refine_detections_plain(diff, rms, *args),
                   1, 3), bnd)
    # every row distinct: seeded positions and shapes over the science frame
    rng = np.random.default_rng(18)
    dargs = tuple(torch.as_tensor(v.astype('f4'), device=diff.device)
                  for v in (rng.uniform(-5, W + 5, n),
                            rng.uniform(-5, H + 5, n),
                            rng.uniform(0.3, 4.0, n), rng.uniform(0.3, 2.0, n),
                            rng.uniform(-1.6, 1.6, n),
                            rng.uniform(1.0, 6.0, n)))
    refine_case(sci, rms, dargs, f'{n} seeded distinct rows', name)

    # H14 at the pipeline's medians: the ::4 subsample's H8 median and
    # 1.48 MAD
    dsub = diff[::4, ::4]
    dmed = background.frame_median(dsub)
    dsig = torch.clamp(1.48 * background.frame_median(dsub, center=dmed),
                       min=1e-12)
    x0, y0 = cutouts.clamped_corners(xs, ys, cutouts.NEGPIX_BOX,
                                     *diff.shape)
    kv = launch.negpix_veto(diff, dmed, dsig, x0, y0)
    check(torch.equal(kv, cutouts.negpix_veto_plain(diff, dmed, dsig, x0,
                                                    y0))
          and torch.equal(kv, out['det_negpix'][0]),
          'negpix_veto differs from its plain version or the slice')
    # the bound of the distinct work (the rows past the frame's objects
    # repeat one corner)
    nd, bnd = negpix_bound(x0, y0)
    every = bound(n * (13 * 13 * 4 + 9), n * 13 * 13 * 13)
    ms = graph_ms(lambda: launch.negpix_veto(diff, dmed, dsig, x0, y0))
    call_ms = cuda_ms(lambda: launch.negpix_veto(diff, dmed, dsig, x0, y0))
    print(f'negpix_veto: {nd} distinct corners of {n} rows: {ms:.5f} ms on '
          f'the card (graph replay), {call_ms:.4f} ms per wrapper call with '
          f'its host cost; bound {bnd[0]:.6f} ms ({bnd[1]}; every row\'s '
          f'window read: {every[0]:.5f} ms)', flush=True)
    record('negpix_veto', 0.0, ms,
           cuda_ms(lambda: cutouts.negpix_veto_plain(diff, dmed, dsig, x0,
                                                     y0), 1, 3), bnd)
    print(f'measure stage on {name}: H22 flags, oob and overlaps bit-equal '
          f'to the plain version at {n} rows (r = 3), the r = 6 sums and '
          f'H23 within their bounds, H14 bit-equal ({int(kv.sum())} vetoed)',
          flush=True)


def distinct_rows(args):
    """The index of one row of each distinct bit pattern of the six
    inputs ``args``."""
    import torch
    bits = torch.stack([a.contiguous().view(torch.int32) for a in args], 1)
    _, inv = torch.unique(bits, dim=0, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), bits.shape[0],
                       dtype=torch.int64, device=bits.device)
    return first.scatter_reduce(0, inv, torch.arange(
        bits.shape[0], device=bits.device), 'amin')


def refine_case(img, rms, args, tag, name):
    """H23 on ``args`` beside the slice's: two calls bit-identical, within
    refine_check of the plain version, timed by CUDA graph with its
    distinct-work bound."""
    import torch
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.kernels.checks import refine_check
    from zuds_tpu_torch.ops import measure as ms
    n = args[0].numel()
    k1 = launch.refine_detections(img, rms, *args, 33)
    k2 = launch.refine_detections(img, rms, *args, 33)
    check(all(torch.equal(k1[key].nan_to_num(7.0), k2[key].nan_to_num(7.0))
              for key in k1), f'H23 ({tag}): two calls differ')
    p = ms.refine_detections_plain(img, rms, *args)
    gaps, near, crossed = refine_check(img, rms, args, k1, p)
    one = distinct_rows(args)
    nd = one.numel()
    bnd = bound(nd * 2 * 33 * 33 * 4 + n * (24 + 44),
                refine_flop(img, rms, tuple(a[one] for a in args),
                            {key: v[one] for key, v in k1.items()}))
    ms_k = graph_ms(lambda: launch.refine_detections(img, rms, *args, 33))
    print(f'refine_detections ({tag}): N = {n}, {nd} distinct rows, within '
          f'refine_check of the plain version (largest gap '
          f'{max(gaps.values()):.3g}; {near} rows near an ellipse edge, '
          f'{crossed} between the AUTO edges), two calls bit-identical; '
          f'kernel {ms_k:.4f} ms (a CUDA graph of 20), bound {bnd[0]:.5f} '
          f'ms ({bnd[1]}, share {bnd[0] / ms_k:.1%}) on {name}', flush=True)


def detect_phase(out, cfg, record, name):
    """The detect stage on the slice's flagship frames (the pipeline's
    diff, rms and mask): detect_sources through H24-H27 against the same
    call with their plain versions forced (kernels.checks.plain_detect),
    at each deblend mode, held by kernels.checks.detect_check; the plain
    CCL's rounds per frame; each kernel against its plain version on frame
    0's own inputs (detect_taps), timed (device time: a CUDA graph of 20
    launches) beside its plain version, its bound and a library call; H25
    on the corner-pixel scenes (corner_ccl_checks); the
    host copies and waits the profiler sees in the ccl, stats and clean
    ranges (0 each)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from zuds_tpu_torch.constants import BAD_SUM, CLEAN_PARAM
    from zuds_tpu_torch.kernels import checks, launch
    from zuds_tpu_torch.ops import detect
    from zuds_tpu_torch.profile import host_waits
    kw = dict(nsigma=cfg.nsigma, max_det=cfg.max_det, det_cap=cfg.det_cap,
              deb_cap=cfg.deb_cap)
    frames = [(out['diff'][b], out['rms'][b], out['submask'][b],
               (out['submask'][b] & BAD_SUM) == 0)
              for b in range(out['diff'].shape[0])]
    for mode in (True, 'watershed', False):
        gaps, ns, ms_k, ms_p = [], [], [], []
        for b, fr in enumerate(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k = detect.detect_sources(*fr, deblend=mode, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with checks.plain_detect():
                p = detect.detect_sources(*fr, deblend=mode, **kw)
            torch.cuda.synchronize()
            ms_k.append((t1 - t0) * 1e3)
            ms_p.append((time.perf_counter() - t1) * 1e3)
            taps = detect.detect_taps(*fr, deblend=mode, **kw)
            gaps.append(checks.detect_check(k, p, taps['clean']))
            ns.append(int(k['n']))
            if mode is True:
                print(f'detect, slice frame {b}: the plain CCL takes '
                      f'{detect.label_compact_rounds(*taps["ccl"])} rounds '
                      f'that change the labels (the reference stops at 64)',
                      flush=True)
        print(f'detect_sources (deblend={mode!r}) on the slice frames, '
              f'H24-H27 against their plain versions: labels, n {ns}, '
              f'valid, npix, boxes, imaflags, flags and overflow counters '
              f'bit-equal, the float fields within detect_check\'s '
              f'tolerances (largest float gap {max(gaps):.3g}); host clock '
              f'{[round(t, 2) for t in ms_k]} ms, plain '
              f'{[round(t, 2) for t in ms_p]} ms on {name}', flush=True)

    diff, rms, mask, wok = frames[0]
    taps = detect.detect_taps(diff, rms, mask, wok, **kw)
    # H24 on the detection mask and its compact list: reads the mask (1 B
    # a pixel) and the listed entries' positions (8 B), writes the list's
    # seeds (4 B an entry)
    det, pidx, count = taps['seeds']
    checks.seeds_check(det, pidx, count)
    H, W = det.shape
    cap = pidx.numel()
    ndet = int(count)
    lab = torch.where(det, torch.arange(H * W, device=det.device,
                                        dtype=torch.float32).reshape(H, W),
                      float('inf'))[None, None]
    record('seed_sweeps', 0.0,
           graph_ms(lambda: launch.seed_sweeps(det, pidx, count)),
           cuda_ms(lambda: detect.seed_labels_plain(det, pidx, count), 1, 3),
           bound(H * W + 8 * min(ndet, cap) + 4 * cap + 8,
                 12 * SEED_OPS * ndet),
           cuda_ms(lambda: [F.max_pool2d(lab, 3, 1, 1) for _ in range(12)]))
    # H25 on the compact list: rows 0-3 (the backward half, all the kernel
    # reads) of the (8, n) int64 positions and bool edges, lab0, the
    # labels: 52 B an entry; operations over the backward edges
    nbr_pos, okb, lab0 = taps['ccl']
    checks.ccl_check(nbr_pos, okb, lab0)
    check(torch.equal(launch.ccl_fixpoint(nbr_pos, okb, lab0),
                      launch.ccl_fixpoint(nbr_pos, okb, lab0)),
          'two ccl_fixpoint calls differ on slice frame 0')
    corner_ccl_checks(lab0.device)
    n = lab0.numel()
    record('ccl_fixpoint', 0.0,
           graph_ms(lambda: launch.ccl_fixpoint(nbr_pos, okb, lab0)),
           cuda_ms(lambda: detect.label_compact_plain(nbr_pos, okb, lab0),
                   1, 3),
           bound(52 * n, CCL_OPS * int(okb[:4].sum())))
    # H26: reads 30 B an entry and ndet_pix, writes 81 B a row
    sargs = taps['stats']
    err = checks.stats_check(sargs)
    cap, nseg = sargs[0].numel(), sargs[9]
    record('object_stats', err, graph_ms(lambda: launch.object_stats(*sargs)),
           cuda_ms(lambda: detect.object_stats_plain(*sargs), 1, 3),
           bound(30 * cap + 8 + 81 * nseg,
                 STATS_OPS[0] * cap + STATS_OPS[1] * nseg),
           cuda_ms(lambda: torch.sort(sargs[0], stable=True)))
    # H27: reads 11 row fields, writes 4; on slice frame 0 (recorded) and
    # on a crowded row set (CLEAN_CROWDED rows, about 80% valid)
    from zuds_tpu_torch.bench_detect import clean_rows
    inv = float(np.float32(1.0) / np.float32(2.0 * CLEAN_PARAM ** 2))
    for what, cargs in (('slice frame 0', taps['clean']),
                        (f'{CLEAN_CROWDED} crowded rows',
                         clean_rows(CLEAN_CROWDED, diff.device))):
        flux_gap, rel, ncleaned, near = checks.clean_check(cargs)
        check(all(torch.equal(u, v) for u, v in zip(
            launch.clean(*cargs, inv), launch.clean(*cargs, inv))),
            f'two clean calls differ on {what}')
        valid, peak = cargs[10], cargs[5]
        pf = peak[valid]
        nv, nrows = int(valid.sum()), valid.numel()
        nok = int((pf[None, :] > pf[:, None]).sum())
        ms = graph_ms(lambda: launch.clean(*cargs, inv))
        bnd = bound(60 * nrows, CLEAN_OPS[0] * nv * nv + CLEAN_OPS[1] * nok)
        print(f'clean on {what}: {nv} valid rows, {ncleaned} cleaned, '
              f'{near} within one ulp of the threshold; the contributions '
              f'(powf, cosf, sinf of the toolkit against PyTorch\'s) within '
              f'{rel:.3g} of the row\'s peak; merged flux gap {flux_gap:.3g}; '
              f'{ms:.5f} ms on the card (graph replay; bound {bnd[0]:.6f} ms '
              f'by {bnd[1]}, share {bnd[0] / ms:.2%}) on {card()}',
              flush=True)
        if what == 'slice frame 0':
            record('clean', flux_gap, ms,
                   cuda_ms(lambda: detect._clean_plain(*cargs), 1, 3), bnd)

    # the profiler's host copies and waits inside the detect ranges
    detect.detect_sources(diff, rms, mask, wok, return_labels=False, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        detect.detect_sources(diff, rms, mask, wok, return_labels=False, **kw)
        torch.cuda.synchronize()
    waits = host_waits(prof)
    print('detect on slice frame 0, host copies and waits inside the '
          'ranges: ' + ', '.join(f'{r}: {c["copies"]} copies, {c["syncs"]} '
                                 f'waits' for r, c in waits.items()),
          flush=True)
    check(all(c['copies'] == 0 and c['syncs'] == 0 for c in waits.values()),
          f'the detect stage reads back to the host in a range: {waits}')


def corner_ccl_checks(dev):
    """H24 and H25 where the frame's last pixel is detected, alone and
    joined to its neighbours, with padding in the list (no neighbour's edge
    reaches that pixel, and _extract's inverse map drops its entry) and at
    overflow: the seeds bit-equal to seed_labels_plain
    (kernels.checks.seeds_check), the labels, from the seeds and from the
    identity, to label_compact_plain (kernels.checks.ccl_check)."""
    import torch
    from zuds_tpu_torch.bench_detect import corner_mask
    from zuds_tpu_torch.kernels import checks
    from zuds_tpu_torch.ops import detect
    for joined in (False, True):
        det = torch.as_tensor(corner_mask(joined), device=dev)
        H, W = det.shape
        for det_cap in (4096, 512):
            taps = detect.detect_taps(
                torch.full((H, W), 1000.0, device=dev),
                torch.ones((H, W), device=dev),
                torch.zeros((H, W), dtype=torch.int32, device=dev), det,
                nsigma=5.0, max_det=64, deblend=False, det_cap=det_cap)
            nbr_pos, okb, lab0 = taps['ccl']
            check((int(det.sum()) < lab0.numel()) == (det_cap == 4096),
                  'the corner scene neither pads nor overflows its list')
            checks.seeds_check(*taps['seeds'])
            for lab in (lab0, torch.arange(lab0.numel(), device=dev)):
                checks.ccl_check(nbr_pos, okb, lab)
    print('seed_sweeps and ccl_fixpoint on the corner-pixel scenes (the '
          'last pixel alone and joined, the list padded and overflowing; '
          'H25 from the seeds and the identity): bit-equal to the plain '
          'versions', flush=True)


def apply_flops(ye, xe, K, Nm):
    """(issued, useful) FLOP of one H3 model over regions with row edges
    ``ye`` and column edges ``xe``: issued counts the tensor cores'
    m16n8k8 work as apply.cu schedules it (3 passes, terms padded to 16,
    taps to K x KP, pixels to 64x32 tiles per region); useful is
    2 K^2 Nm H W."""
    kp = -(-K // 8) * 8
    pix = sum(-(-(y1 - y0) // 32) * 32 * -(-(x1 - x0) // 64) * 64
              for y0, y1 in zip(ye, ye[1:]) for x0, x1 in zip(xe, xe[1:]))
    return (3 * 2 * 16 * -(-Nm // 16) * K * kp * pix,
            2 * K * K * Nm * ye[-1] * xe[-1])


def smooth_field(H, W, amp, phase, device):
    import torch
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    return amp * torch.sin(xx / 410.0 + phase) * torch.cos(yy / 530.0 - phase)


def run_counted(pipe, targs, wrappers):
    """One run of the main path with every launch count set to 0 just
    before it; returns (outputs, launches, seconds)."""
    import torch
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe(*targs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, {k: w.launches for k, w in wrappers.items()}, secs


def check_planted(out, planted, tag):
    import torch
    for b in range(len(planted)):
        v = out['det_valid'][b]
        xy = torch.stack([out['det_x'][b][v], out['det_y'][b][v]], 1).cpu()
        for px, py in planted[b]:
            dist = float((xy - torch.tensor([px, py])).norm(dim=1).min()) \
                if len(xy) else float('inf')
            check(dist <= 1.0, f'{tag} frame {b}: planted source at '
                  f'({px:.2f}, {py:.2f}) not recovered (nearest '
                  f'{dist:.2f} px)')
        print(f'{tag} frame {b}: {int(out["det_n"][b])} detections, '
              f'{int(out["fit_stamps_ok"][b])} stamps kept, 3/3 planted '
              f'sources within 1 px', flush=True)


def small_card_vs_cpu(mode, dev):
    """The slice on a small input, card (kernels) against CPU (plain
    versions): submask equal and the planted sources within 0.01 px. det_n
    within 1 plus twice the CPU's own spread under 1e-7 relative
    perturbations of ``sci`` (none with deblend=False), against the CPU
    run whose first stage is the card's H1 (its warped reference, mask and
    coverage fed to the CPU's remaining stages): H1 rounds its weights
    otherwise than the plain warp (held to it, and to float64, at the warp
    record), which moves the warped reference by a few ulp, and the tree's
    splits in noise follow that as they follow any such change. With
    deblend=False det_n is also within 1 of the all-plain CPU run. Printed
    beside: det_n against the all-plain CPU run, and where and how far the
    two warped references differ."""
    from unittest import mock
    import numpy as np
    import torch
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.ops import resample
    from zuds_tpu_torch.parallel import (PipelineConfig,
                                         SubtractDetectPipeline, pipeline)
    small = PipelineConfig(**SMALL, deblend=mode)
    sargs, splanted = inputs.plant_sources(
        inputs.synth_inputs(2, small.height, small.width, small, seed=0),
        n=3, flux=2e4, seed=1)
    spipe = SubtractDetectPipeline(small)
    on_card = spipe(*inputs.to_torch(sargs, dev))
    on_cpu = spipe(*inputs.to_torch(sargs, 'cpu'))
    diff = []

    def card_warp(ref, ref_mask, u, v, covb, window):
        k = tuple(t.cpu() for t in resample.warp_reference(
            *(t.to(dev) for t in (ref, ref_mask, u, v, covb)), window))
        p = resample.warp_reference_plain(ref, ref_mask, u, v, covb, window)
        gap = (k[0] - p[0]).abs()
        diff.append((float(gap.max()), int((gap > 0).sum()), gap.numel()))
        return k

    spread = np.zeros(2, int)
    with mock.patch.object(pipeline, 'warp_reference', card_warp):
        fed = spipe(*inputs.to_torch(sargs, 'cpu'))
        if mode is not False:
            for e in (1e-7, -1e-7, 2e-7):
                pert = ((sargs[0] * np.float32(1 + e)).astype('f4'),) \
                    + sargs[1:]
                n = spipe(*inputs.to_torch(pert, 'cpu'))['det_n'].numpy()
                spread = np.maximum(spread, np.abs(n - fed['det_n'].numpy()))
    for k, v in on_cpu.items():
        check(tuple(on_card[k].shape) == tuple(v.shape), f'{k}: shape')
    check(torch.equal(on_card['submask'].cpu(), on_cpu['submask']),
          f'small input, deblend={mode!r}: submask differs')
    dn, dp = [], []
    for b in range(2):
        dn.append(int(on_card['det_n'][b]) - int(fed['det_n'][b]))
        dp.append(int(on_card['det_n'][b]) - int(on_cpu['det_n'][b]))
        check(abs(dn[-1]) <= 1 + 2 * int(spread[b]),
              f'small input, deblend={mode!r}: detection counts differ by '
              f'{dn[-1]} from the CPU fed the card\'s warp (CPU spread '
              f'{int(spread[b])})')
        if mode is False:
            check(abs(dp[-1]) <= 1, f'small input, deblend=False: detection '
                  f'counts differ by {dp[-1]} from the CPU')
        for px, py in splanted[b]:
            near = []
            for o in (on_card, on_cpu):
                v = o['det_valid'][b].cpu()
                x, y = o['det_x'][b].cpu()[v], o['det_y'][b].cpu()[v]
                d = (x - px) ** 2 + (y - py) ** 2
                check(len(d) > 0 and float(d.min()) <= 1.0,
                      'small input: planted source missed')
                near.append((float(x[d.argmin()]), float(y[d.argmin()])))
            shift = max(abs(near[0][0] - near[1][0]),
                        abs(near[0][1] - near[1][1]))
            check(shift <= 0.01, f'small input: planted source moved '
                  f'{shift:.4f} px between card and CPU')
    print(f'small input (256x256, order 2, 2x2 regions, deblend={mode!r}): '
          f'card and CPU agree on submask and the 6 planted sources '
          f'(<= 0.01 px); det_n card - CPU fed the card\'s warp {dn}, CPU '
          f'own spread {spread.tolist()}; card - all-plain CPU {dp}; the '
          f'card\'s and the plain warped references differ at '
          f'{[d[1] for d in diff[:2]]} of {diff[0][2]} pixels, by at most '
          f'{max(d[0] for d in diff[:2]):.3g}', flush=True)


def crop_card_vs_cpu(img, dev):
    """detect_sources with the tree on a 1024^2 crop, card against CPU:
    equal, except through split decisions within 1e-5 of their threshold
    (atomic float sums on the card) or pixels within 1e-6 of the detection
    threshold (H4); counts both."""
    import torch
    from zuds_tpu_torch.ops import detect
    crop = torch.as_tensor(img[:1024, :1024].copy())
    rms = torch.full_like(crop, 5.0)
    res, near = {}, 0
    for d in (dev, 'cpu'):
        c, r = crop.to(d), rms.to(d)
        res[d] = {k: v.cpu() for k, v in
                  detect.detect_sources(c, r, **BUSY).items()}
        m = detect.deblend_load(c, r, **BUSY)['margins']
        near += int(((m - 1).abs() <= 1e-5).sum())
    _, filt, _ = detect.matched_filter_plain(crop, rms, crop == crop, 5.0)
    edge = int(((filt - 5.0 * rms).abs() <= 1e-6 * 5.0 * rms).sum())
    a, b = res[dev], res['cpu']
    exact = ('n', 'valid', 'npix', 'xmin', 'xmax', 'ymin', 'ymax', 'flags',
             'imaflags', 'pix_overflow', 'deblend_overflow', 'obj_overflow',
             'labels')
    same = all(torch.equal(a[k], b[k]) for k in exact)
    if same:
        v = b['valid']
        close('crop x', a['x'][v], b['x'][v], 0.0, 1e-4)
        close('crop y', a['y'][v], b['y'][v], 0.0, 1e-4)
        for k in ('flux', 'peak', 'a', 'b', 'thresh'):
            close(f'crop {k}', a[k][v], b[k][v], 1e-5, 0.0)
    print(f'blend crop 1024x1024: card and CPU '
          f'{"equal" if same else "DIFFER"} ({int(b["n"])} objects); split '
          f'decisions within 1e-5 of threshold: {near} (card + CPU); '
          f'pixels within 1e-6 of the detection threshold: {edge}',
          flush=True)
    check(same or near + edge > 0, 'blend crop: card and CPU differ with no '
          'decision near a threshold')


def seeing_card_vs_cpu(path, cfg, night_see):
    """The stamp selection and stamp-moment SEEING of the science frame at
    ``path``, on the card and on the CPU: stamps equal, SEEING within 1e-6
    relative of each other and of the SEEING the night used."""
    import numpy as np
    import torch
    from zuds_tpu_torch.fits import read_fits
    from zuds_tpu_torch.ops import measure
    hdu = next(h for h in read_fits(path) if h.data is not None)
    img = torch.as_tensor(np.ascontiguousarray(hdu.data, 'f4'))
    sat = float(hdu.header.get('SATURATE', 5e4) or 5e4)
    res = []
    for t in (img.cuda(), img):
        st = measure.select_stamps_device(t, smax=cfg.smax, nreg=cfg.nreg,
                                          sat_level=sat,
                                          margin=cfg.stamp // 2 + 1)
        res.append((st, float(measure.seeing_from_stamps(t, *st))))
    (kst, ksee), (pst, psee) = res
    check(all(torch.equal(a.cpu(), b) for a, b in zip(kst, pst)),
          'stamp selection differs between the card and the CPU')
    check(abs(ksee - psee) <= 1e-6 * psee and
          abs(ksee - night_see) <= 1e-6 * psee,
          f'stamp-moment SEEING: card {ksee!r}, CPU {psee!r}, night '
          f'{night_see!r}')
    print(f'night frame {NO_SEEING}: stamp selection equal on card and CPU '
          f'({int(pst[2].sum())} valid stamps); stamp-moment SEEING card '
          f'{ksee!r}, CPU {psee!r}, night {night_see!r} px', flush=True)


def refilter(cat, see):
    """GOODCUT of ``filter_sexcat`` rerun on a copy of ``cat``'s rows with
    ``see`` as its image's SEEING."""
    from zuds_tpu_torch.catalog import PipelineFITSCatalog
    from zuds_tpu_torch.filterobjects import filter_sexcat
    from zuds_tpu_torch.fits import Header
    redo = PipelineFITSCatalog()
    redo.data = cat.data.copy()
    redo.data['GOODCUT'] = 0
    redo.header = Header()
    redo.header.set('RMSMED', cat.header['RMSMED'])
    redo.image = SimpleNamespace(header={'SEEING': see})
    filter_sexcat(redo, ml=False)
    return redo.data['GOODCUT']


def pair_plan(line):
    """The host's warp plan for the work line "sci ref" (None: the gather
    warp runs), from the two headers alone."""
    from zuds_tpu_torch.coadd import ReferenceImage
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.ops.resample import plan_warp
    sci_path, ref_path = line.split()
    sci = ScienceImage.from_file(sci_path, load_others=False)
    ref = ReferenceImage.from_file(ref_path, load_others=False)
    return plan_warp(ref.mapping_to(sci), sci.shape, ref.shape)


class scoring_model:
    """While open, the port's ``load_model_helper`` reads braai weights
    written to ``d`` (the seed-0 init with ``inputs.spread_braai``'s gains,
    so the scores spread), and every ``rb_scores`` call is kept as (model,
    triplets, scores) for :func:`check_scores`."""

    def __init__(self, d):
        self.d, self.calls = d, []

    def __enter__(self):
        from zuds_tpu_torch import filterobjects, inputs
        from zuds_tpu_torch.models import braai
        _, params = braai.init_braai(0)
        braai.save_braai(inputs.spread_braai(params),
                         os.path.join(self.d, 'braai_d6_m9.npz'))
        self._saved = (filterobjects.load_model_helper, braai.rb_scores)
        helper, scores = self._saved

        def load(path=None, model_base_name='braai_d6_m9', device=None):
            return helper(self.d, model_base_name, device=device)

        def rb(model, triplets):
            out = scores(model, triplets)
            self.calls.append((model, triplets, out))
            return out

        filterobjects.load_model_helper, braai.rb_scores = load, rb
        return self

    def __exit__(self, *exc):
        from zuds_tpu_torch import filterobjects
        from zuds_tpu_torch.models import braai
        filterobjects.load_model_helper, braai.rb_scores = self._saved


def check_scores(calls, tag):
    """The card's scores of every kept call against the plain layers on the
    same triplets (1e-6 absolute); returns the largest difference."""
    import torch
    err = 0.0
    for model, triplets, scores in calls:
        check(scores.is_cuda, f'{tag}: the scores were not computed on the '
              'card')
        with torch.no_grad():
            plain = model.forward_plain(triplets)
        err = max(err, float((scores - plain).abs().max()))
    check(calls and err <= 1e-6, f'{tag}: card scores differ from the plain '
          f'layers by {err:.3g} ({len(calls)} scored batches)')
    return err


def night_catalog(d, i):
    from zuds_tpu_torch.catalog import PipelineFITSCatalog
    return PipelineFITSCatalog.from_file(
        [os.path.join(d, f) for f in os.listdir(d)
         if f.startswith(f'sub.night_n{i}_') and f.endswith('.cat')][0])


def night_phase(wrappers, name, record):
    """run_night over the flagship pairs and the fallback pair at ml=False:
    warm-up, then one counted, timed run; then the batched pairs again at
    ml=True (the scoring night), and H12 and H13 against their plain
    versions at SCORE_N candidates on the night's frames (``record`` takes
    their records); then :func:`db_phase` on the same pairs. Returns
    (launches, seconds of the batched pairs, stats, the db phase's
    transient fluxes)."""
    import numpy as np
    import torch
    from zuds_tpu_torch import inputs, night
    from zuds_tpu_torch.catalog import PipelineFITSCatalog
    from zuds_tpu_torch.parallel import SubtractDetectPipeline
    cfg = night.FLAGSHIP
    with tempfile.TemporaryDirectory(prefix='chip_smoke_night_') as d:
        t0 = time.perf_counter()
        work, truths = inputs.write_night_pairs(
            d, NIGHT_PAIRS + 1, cfg.height, cfg.width,
            no_seeing=(NO_SEEING,),
            ref_rot_deg=(0.0,) * FALLBACK + (FALLBACK_ROT,),
            header_json=Path(__file__).resolve().parent / 'tests' / 'data'
            / 'ztf_real_header.json')
        print(f'night: {NIGHT_PAIRS} flagship pairs and one with its '
              f'reference rotated by {FALLBACK_ROT} deg written in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
        # a same-shape frame past the bucket gets no plan either (the
        # rolled reads of its edge nodes leave the canvas): the fallback
        # pair's three aligns take the gather warp
        plans = [pair_plan(w) for w in work]
        print(f'night: host warp plans per pair {plans}', flush=True)
        check(all(p is not None for p in plans[:FALLBACK])
              and plans[FALLBACK] is None, f'night: warp plans {plans}')
        pipe = SubtractDetectPipeline(cfg)
        t0 = time.perf_counter()
        warm = night.run_night(work[:NIGHT_BATCH], batch=NIGHT_BATCH,
                               ml=False, cfg=cfg, pipe=pipe)
        torch.cuda.synchronize()
        print(f'night: warm-up run of {NIGHT_BATCH} pairs '
              f'{time.perf_counter() - t0:.2f} s', flush=True)
        check(all(not isinstance(r, Exception) for _, r in warm),
              f'night warm-up failed: {warm}')
        for w in wrappers.values():
            w.launches = 0
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = night.run_night(work, batch=NIGHT_BATCH, ml=False, cfg=cfg,
                              pipe=pipe, stats=stats)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        for path, r in res:
            check(isinstance(r, int), f'night: {path}: {r!r}')
        check(len(res) == NIGHT_PAIRS + 1 and stats['fallbacks'] == 1
              and len(stats['detections']) == NIGHT_PAIRS,
              f'night: {len(res)} results, {stats["fallbacks"]} fallbacks')
        # the fallback runs on the host while the card works on the batch
        # before it; the batched pairs' rate is taken without its seconds
        fb_s = stats['fallback_s']
        secs -= fb_s
        print(f'night: files -> catalog {NIGHT_PAIRS / secs:.3f} '
              f'quadrants/s ({NIGHT_PAIRS} pairs, batch {NIGHT_BATCH}, '
              f'{secs:.2f} s, host clock) on {name}', flush=True)
        fb_n = dict(res)[work[FALLBACK].split()[0]]
        print(f'night: pair {FALLBACK} (reference rotated by '
              f'{FALLBACK_ROT} deg) refused by the batched feed; per-pair '
              f'fallback {fb_s:.2f} s (the first per-pair run of this '
              f'process), {fb_n} GOODCUT detections, '
              f'{launches["warp_gather"]} H10, '
              f'{launches["apply_model_variance"]} H3-variance and '
              f'{launches["subtract_epilogue"]} H11 launches', flush=True)
        check(launches['warp'] == NIGHT_PAIRS
              and launches['warp_gather'] == 3
              and launches['apply_model'] == NIGHT_PAIRS + 1
              and launches['apply_model_variance'] == 1
              and launches['subtract_epilogue'] == 1
              and launches['negpix_veto'] == NIGHT_PAIRS + 1,
              f'night: launches {launches}')
        prep = stats['prepare_s'] - stats['upload_s']
        print(f'night: host seconds per phase: load '
              f'{stats["load_s"]:.3f}, prepare {prep:.3f}, upload '
              f'{stats["upload_s"]:.3f}, pipeline {stats["pipeline_s"]:.3f}, '
              f'commit {stats["commit_s"]:.3f}; upload '
              f'{stats["upload_bytes"] / NIGHT_PAIRS / 1e6:.1f} MB and '
              f'{stats["upload_s"] / NIGHT_PAIRS * 1e3:.1f} ms of host time '
              f'per pair; reference cache {stats["ref_cache_hits"]} hits, '
              f'{stats["ref_cache_misses"]} misses; GOODCUT detections per '
              f'frame {stats["detections"]}', flush=True)
        print(f'night: kernel launches {launches} '
              f'({NIGHT_PAIRS} frames)', flush=True)
        # the host link: one science frame from pinned memory to the card
        host = torch.empty((cfg.height, cfg.width),
                           dtype=torch.float32).pin_memory()
        link_ms = cuda_ms(lambda: torch.empty_like(host, device='cuda')
                          .copy_(host, non_blocking=True))
        print(f'night: host link {host.numel() * 4 / link_ms / 1e6:.1f} '
              f'GB/s ({host.numel() * 4 / 1e6:.1f} MB pinned -> card in '
              f'{link_ms:.3f} ms, CUDA events) on {name}', flush=True)
        for k, n in launches.items():
            check(n > 0 or k in COADD_ONLY + ML_ONLY + ZOGY_ONLY
                  + TRAIN_ONLY,
                  f'kernel {k} was not launched by the night')
        for i, (tx, ty) in enumerate(truths):
            cat = night_catalog(d, i)
            data = cat.data
            dist = np.hypot(data['X_IMAGE'] - 1 - tx, data['Y_IMAGE'] - 1 - ty)
            check(len(dist) and dist.min() < 2.0,
                  f'night frame {i}: transient at ({tx}, {ty}) not in the '
                  'catalog')
            j = int(np.argmin(dist))
            row = data[j]
            if i == FALLBACK:
                check(row['GOODCUT'] == 1 and fb_n == int(
                    (data['GOODCUT'] == 1).sum()),
                    f'night frame {i} (fallback): transient row {row}')
                print(f'night frame {i}: per-pair fallback; transient at '
                      f'({tx:.0f}, {ty:.0f}) found {dist.min():.2f} px '
                      f'away, GOODCUT 1, FWHM {row["FWHM_IMAGE"]:.2f} px',
                      flush=True)
                continue
            see = stats['seeing'][i]
            if i == NO_SEEING:
                # SEEING from the stamp moments, which keep each stamp's
                # positive noise and read wide (the reference's estimator):
                # the cuts rerun at the night's SEEING give the night's
                # GOODCUT, and at the science headers' SEEING they keep
                # the transient
                seeing_card_vs_cpu(work[i].split()[0], cfg, see)
                check(np.array_equal(refilter(cat, see), data['GOODCUT']),
                      f'night frame {i}: the cuts rerun at SEEING {see} '
                      'disagree with the night\'s GOODCUT')
                at_header = int(refilter(cat, inputs.NIGHT_SEEING[1])[j])
                check(at_header == 1, f'night frame {i}: transient row '
                      f'{row} not GOODCUT at SEEING '
                      f'{inputs.NIGHT_SEEING[1]}')
            else:
                check(row['GOODCUT'] == 1 and see == inputs.NIGHT_SEEING[1],
                      f'night frame {i}: transient row {row}')
            print(f'night frame {i}: SEEING {see:.4f} px ('
                  f'{"stamp moments" if i == NO_SEEING else "header"}); '
                  f'transient at ({tx:.0f}, {ty:.0f}) found '
                  f'{dist.min():.2f} px away, GOODCUT {int(row["GOODCUT"])}'
                  + (f' ({at_header} at SEEING {inputs.NIGHT_SEEING[1]})'
                     if i == NO_SEEING else '')
                  + f', FWHM {row["FWHM_IMAGE"]:.2f} px', flush=True)
        scoring_night(wrappers, name, record, d, work, truths, pipe)
        # ---- the db phase on the same pairs ------------------------------
        db_fluxes = db_phase(wrappers, name, d, work, truths, pipe)
    return launches, secs, stats, db_fluxes


class bound_db:
    """The port's sessions bound to a fresh sqlite file in ``d`` (its
    config a file there too), its tables made; unbound on exit. With
    ``config=True`` the config names that file (``sqlite_path``) and a
    spool there (``base_data_directory``), so a worker process or a
    ``main`` that binds the configured database binds the same one."""

    def __init__(self, d, tag, config=False):
        self.d = os.path.join(d, f'db_{tag}')
        self.config = config

    def __enter__(self):
        from zuds_tpu_torch import model_util, secrets
        os.makedirs(self.d)
        self.env = os.environ.get('ZUDS_CONFIG')
        os.environ['ZUDS_CONFIG'] = os.path.join(self.d, 'config')
        self.db = os.path.join(self.d, 'zuds.db')
        self.spool = os.path.join(self.d, 'spool')
        if self.config:
            with open(os.environ['ZUDS_CONFIG'], 'w') as f:
                f.write(f'sqlite_path: {self.db}\n'
                        f'base_data_directory: {self.spool}\n')
            os.chmod(os.environ['ZUDS_CONFIG'], 0o600)
        secrets._manager.cache = None
        model_util.init_db(database=self.db)
        model_util.create_tables()
        return self

    def __exit__(self, *exc):
        from zuds_tpu_torch import core, secrets
        for s in (core.DBSession, core.RefDBSession):
            s.remove()
            s.configure(None)
        secrets._manager.cache = None
        if self.env is None:
            os.environ.pop('ZUDS_CONFIG', None)
        else:
            os.environ['ZUDS_CONFIG'] = self.env


def counts_of(wrappers):
    return {k: w.launches for k, w in wrappers.items() if w.launches}


def db_phase(wrappers, name, d, work, truths, pipe):
    """The night at its default db=True and dophot's worker from the
    database: ``sci``/``ref`` records for the fallback pair (its per-pair
    chain reads them through ``from_file``), then ``run_night`` over the
    night's pairs, counted; one ``sesub`` record a frame (the batched
    frames' target and reference ids NULL, as ``donight.py``'s images
    read from HDUs carry none; the fallback's the records' ids), as many
    ``Detection`` rows as GOODCUT rows, each transient a detection within
    2 px (but on the frame without SEEING, which keeps no GOODCUT row),
    three thumbnails a detection, each decompressing to the 63x63 cut of
    its frame on that frame's WCS. Then one ``Source`` per
    detection and PHOT_N ``forced_positions`` (seed 13) on subtraction
    0, DB_MEASURED of them measured there already, and ``phot.main`` over
    the subtractions, counted: its rows per subtraction the anti-join's
    count, the measured pairs and the off-frame rows not listed, one H22
    launch a ``phot.do_one``. Prints the host seconds of each span of the
    commit (``commit.COMMIT_SPANS``), of a one-row commit right after a
    frame's worth of bytes is written to a new file, right after they are
    renamed over it, and of the next one, of each
    ``phot.do_one``, and the row counts. Returns {frame: its transient's forced flux}, which
    :func:`phot_phase` holds against its own measurement."""
    import csv
    import gzip
    import io
    import numpy as np
    import torch
    from zuds_tpu_torch import core, inputs, night, phot
    from zuds_tpu_torch.bookkeeping import Job
    from zuds_tpu_torch.coadd import ReferenceImage
    from zuds_tpu_torch.commit import COMMIT_SPANS
    from zuds_tpu_torch.detections import Detection
    from zuds_tpu_torch.fits import read_fits
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.mask import MaskImageBase
    from zuds_tpu_torch.source import ForcedPhotometryRecord, Source
    from zuds_tpu_torch.subtraction import sub_name
    from zuds_tpu_torch.thumbnails import Thumbnail, make_stamp
    cfg = night.FLAGSHIP
    H, W = cfg.height, cfg.width
    with bound_db(d, 'night') as db:
        sess = core.DBSession()
        fb_sci, fb_ref = work[FALLBACK].split()
        ids = {}
        for path, kind, cls in ((fb_sci, 'sci', ScienceImage),
                                (fb_ref, 'ref', ReferenceImage)):
            rec = core.record_from_image(cls.from_file(path), kind)
            sess.add(rec)
            sess.commit()
            ids[kind] = rec.id
        for w in wrappers.values():
            w.launches = 0
        st = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = night.run_night(work, batch=NIGHT_BATCH, ml=False, cfg=cfg,
                              pipe=pipe, stats=st)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        check(all(isinstance(r, int) for _, r in res)
              and st['fallbacks'] == 1, f'db night: {res}')
        for k, n in launches.items():
            check(n > 0 or k in COADD_ONLY + ML_ONLY + ZOGY_ONLY
                  + TRAIN_ONLY,
                  f'kernel {k} was not launched by the db night')
        check(launches['warp'] == NIGHT_PAIRS
              and launches['apply_model'] == NIGHT_PAIRS + 1,
              f'db night: launches {launches}')

        subs = {}
        for i, line in enumerate(work):
            sci_path, ref_path = line.split()
            base = os.path.basename(sub_name(sci_path, ref_path))
            recs = sess.query(core.ZTFFile).filter_by(
                basename=base).all()
            check(len(recs) == 1 and recs[0].type == 'sesub',
                  f'db night frame {i}: records {recs}')
            rec = recs[0]
            tgt = (ids['sci'], ids['ref']) if i == FALLBACK else (None, None)
            check((rec.target_id, rec.reference_id) == tgt,
                  f'db night frame {i}: target/reference ids '
                  f'{(rec.target_id, rec.reference_id)}, want {tgt}')
            cat = night_catalog(d, i).data
            good = cat[cat['GOODCUT'] == 1]
            dets = sess.query(Detection).filter_by(image_id=rec.id) \
                .order_by('id').all()
            # the frame without SEEING keeps no GOODCUT row: its
            # stamp-moment SEEING reads wide (the night phase's check)
            check(len(dets) == len(good) == dict(res)[sci_path]
                  and (len(dets) >= 1 or i == NO_SEEING),
                  f'db night frame {i}: {len(dets)} detections, '
                  f'{len(good)} GOODCUT rows')
            near = None
            if i != NO_SEEING:
                tx, ty = truths[i]
                near = min(dets, key=lambda x: math.hypot(
                    x.x_image - 1 - tx, x.y_image - 1 - ty))
                dist = math.hypot(near.x_image - 1 - tx,
                                  near.y_image - 1 - ty)
                check(dist < 2.0, f'db night frame {i}: transient '
                      f'{dist:.2f} px from its nearest detection')
            frames = {}
            for kind, path in (('sub', os.path.join(d, base)),
                               ('new', sci_path), ('ref', ref_path)):
                img = ScienceImage.from_file(path, load_others=False)
                frames[kind] = (np.asarray(img.data), img.wcs)
            nthumb = 0
            for det in dets:
                thumbs = sess.query(Thumbnail).filter_by(
                    detection_id=det.id).order_by('id').all()
                check([t.type for t in thumbs] == ['sub', 'new', 'ref'],
                      f'db night frame {i}: thumbnails {thumbs}')
                for t in thumbs:
                    stamp = read_fits(io.BytesIO(
                        gzip.decompress(t.bytes)))[0].data
                    data, wcs = frames[t.type]
                    cut = make_stamp(None, det.ra, det.dec, None, None,
                                     data, wcs).astype('f4')
                    check(stamp.shape == (63, 63)
                          and np.array_equal(stamp, cut),
                          f'db night frame {i}: {t.type} thumbnail of '
                          f'detection {det.id} is not the cut of its frame')
                    nthumb += 1
            subs[i] = dict(rec=rec, dets=dets, near=near,
                           path=os.path.join(d, base), thumbs=nthumb)
        ncommit = len(st['db_s'])
        batched = secs - st['fallback_s']
        print(f'db: run_night at db=True over {len(work)} pairs '
              f'{secs:.2f} s: files -> catalog and commit '
              f'{NIGHT_PAIRS / batched:.3f} quadrants/s ({NIGHT_PAIRS} '
              f'batched pairs, {batched:.2f} s; the per-pair fallback '
              f'{st["fallback_s"]:.2f} s), launches {counts_of(wrappers)}',
              flush=True)
        spans = ', '.join(f'{k} {[round(x, 4) for x in st[k]]}'
                          for k in COMMIT_SPANS)
        print(f'db: host seconds per committed frame ({ncommit} batched '
              f'frames; detections {st["detections"]}): {spans} on {name}',
              flush=True)
        # what the record's commit waits on: one row committed right after
        # as many bytes as a frame's three products are written to a new
        # file, again after they replace that file (as write_fits renames
        # over the products the scoring night wrote), then one more
        probe = []
        for write in (True, True, False):
            if write:
                np.zeros(3 * H * W, 'f4').tofile(
                    os.path.join(db.d, 'probe.tmp'))
                os.replace(os.path.join(db.d, 'probe.tmp'),
                           os.path.join(db.d, 'probe.bin'))
            t0 = time.perf_counter()
            sess.add(Job(status='probe'))
            sess.commit()
            probe.append(time.perf_counter() - t0)
        os.remove(os.path.join(db.d, 'probe.bin'))
        print(f'db: a one-row commit right after writing {12 * H * W} bytes '
              f'to a new file {probe[0]:.4f} s, renamed over that file '
              f'{probe[1]:.4f} s, the next one {probe[2]:.4f} s (host clock) '
              f'on {name}', flush=True)
        print(f'db: records: {len(work)} sesub (the fallback with target '
              f'{ids["sci"]} and reference {ids["ref"]}), '
              f'{sum(len(s["dets"]) for s in subs.values())} detections, '
              f'{sum(s["thumbs"] for s in subs.values())} thumbnails, each '
              f'the 63x63 cut of its frame', flush=True)
        persist_thumbs(sess, os.path.join(db.d, 'thumbs'), name,
                       sum(s['thumbs'] for s in subs.values()))

        # ---- sources, and dophot's worker over the subtractions ---------
        sub0 = ScienceImage.from_file(subs[0]['path'])
        mask0 = MaskImageBase.from_file(
            subs[0]['path'].replace('.fits', '.mask.fits')).data
        ra, dec, kind = inputs.forced_positions(
            sub0.wcs, H, W, PHOT_N, truths[0], inputs.night_stars(H, W),
            mask=mask0, seed=13)
        sources = [Source(id=f'F{j:04d}', ra=float(r), dec=float(dc))
                   for j, (r, dc) in enumerate(zip(ra, dec))]
        sources += [Source(id=f'D{x.id:05d}', ra=x.ra, dec=x.dec)
                    for s_ in subs.values() for x in s_['dets']]
        sess.add_all(sources)
        measured = {f'F{j:04d}' for j in range(1, DB_MEASURED + 1)}
        sess.add_all([ForcedPhotometryRecord(
            source_id=sid, image_id=subs[0]['rec'].id, flux=0.0)
            for sid in sorted(measured)])
        sess.commit()
        expect = {}
        for i, s_ in subs.items():
            img = ScienceImage.from_file(s_['path'])
            expect[s_['rec'].id] = len(phot.unphotometered_sources(
                img.id, img.footprint()))
        worklist = os.path.join(db.d, 'subs.txt')
        with open(worklist, 'w') as f:
            f.write('\n'.join(s_['path'] for s_ in subs.values()) + '\n')
        for w in wrappers.values():
            w.launches = 0
        pst = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merged = phot.main(worklist, db.d, stats=pst)
        torch.cuda.synchronize()
        psecs = time.perf_counter() - t0
        used = counts_of(wrappers)
        check(used == {'aperture_photometry': len(subs)},
              f'db phot: launches {used}, not one H22 a subtraction')
        with open(merged) as f:
            rows = list(csv.reader(f))[1:]
        per = {}
        for r in rows:
            per[int(r[1])] = per.get(int(r[1]), 0) + 1
        check(per == expect and pst['rows'] == list(expect.values()),
              f'db phot: rows per subtraction {per}, the anti-join {expect}')
        id0 = str(subs[0]['rec'].id)
        check(not [r for r in rows if r[1] == id0 and r[0] in measured],
              'db phot: a source measured already was listed again')
        off = {f'F{j:04d}' for j in np.flatnonzero(kind == 'off')}
        check(off and not [r for r in rows if r[1] == id0 and r[0] in off],
              'db phot: an off-frame source was listed')
        fluxes = {}
        for i, s_ in subs.items():
            if s_['near'] is None:
                continue
            sid = f'D{s_["near"].id:05d}'
            got = [float(r[4]) for r in rows
                   if r[0] == sid and r[1] == str(s_['rec'].id)]
            check(len(got) == 1 and math.isfinite(got[0]),
                  f'db phot: transient of frame {i}: forced flux {got}')
            fluxes[i] = got[0]
        print(f'db: {len(sources)} sources ({PHOT_N} forced positions, '
              f'{len(sources) - PHOT_N} detections), {DB_MEASURED} measured '
              f'on subtraction 0 beforehand; phot.main over {len(subs)} '
              f'subtractions {psecs:.2f} s: {len(rows)} rows (the '
              f'anti-join\'s {sum(expect.values())}), phot.do_one host '
              f'seconds {[round(x, 3) for x in pst["do_one_s"]]} (query '
              f'{pst["query_s"]:.3f}, photometry {pst["phot_s"]:.3f}, '
              f'CSV {pst["write_s"]:.3f} in all); launches {used} on '
              f'{name}', flush=True)
    return fluxes


def scoring_night(wrappers, name, record, d, work, truths, pipe):
    """The night's batched pairs again at ml=True, db=False (the ml=False
    run's catalogs are the pre-ML GOODCUT), counted; the checks of RB and
    GOODCUT frame by frame and of the card's scores against the plain
    layers; then H12 and H13 at SCORE_N candidates (H12 also timed at
    TRIPLET_MORE)."""
    import numpy as np
    import torch
    from zuds_tpu_torch import night
    pre = [night_catalog(d, i).data.copy() for i in range(NIGHT_PAIRS)]
    with scoring_model(d) as sm:
        for w in wrappers.values():
            w.launches = 0
        st = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = night.run_night(work[:NIGHT_PAIRS], batch=NIGHT_BATCH, ml=True,
                              db=False, cfg=night.FLAGSHIP, pipe=pipe,
                              stats=st)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    for path, r in res:
        check(isinstance(r, int), f'scoring night: {path}: {r!r}')
    nbatches = sum(1 for n in st['scored'] if n)
    check(launches['triplet_cut'] == nbatches > 0
          and launches['braai_conv3x3'] == 4 * nbatches
          and launches['negpix_veto'] == NIGHT_PAIRS,
          f'scoring night: launches {launches}, scored {st["scored"]}')
    err = check_scores(sm.calls, 'scoring night')
    print(f'scoring night: {NIGHT_PAIRS} pairs at ml=True in {secs:.2f} s '
          f'(host clock) on {name}; H12 {launches["triplet_cut"]}, H13 '
          f'{launches["braai_conv3x3"]} launches; card scores within '
          f'{err:.3g} of the plain layers', flush=True)
    for i, (tx, ty) in enumerate(truths[:NIGHT_PAIRS]):
        data = night_catalog(d, i).data
        scored = data['RB'] != -99
        # the rows of the ml=False run, matched by position: a row of
        # either catalog without its twin in the other cannot be checked,
        # so it fails the phase
        dist = np.hypot(data['X_IMAGE'][:, None] - pre[i]['X_IMAGE'][None, :],
                        data['Y_IMAGE'][:, None] - pre[i]['Y_IMAGE'][None, :])
        near = dist < 0.01
        check(len(data) == len(pre[i]) and (near.sum(1) == 1).all()
              and (near.sum(0) == 1).all(),
              f'scoring night frame {i}: {len(data)} rows against '
              f'{len(pre[i])} at ml=False, {int((near.sum(1) != 1).sum())} '
              f'and {int((near.sum(0) != 1).sum())} without one twin')
        was = (pre[i]['GOODCUT'][near.argmax(1)] == 1 if len(data)
               else np.zeros(0, bool))
        check(np.array_equal(scored, was),
              f'scoring night frame {i}: RB set on {int(scored.sum())} rows, '
              f'{int(was.sum())} reached the ML cut at ml=False')
        check(np.array_equal(data['GOODCUT'] == 1,
                             was & (data['RB'] >= RB_CUT_ZR)),
              f'scoring night frame {i}: GOODCUT is not the pre-ML GOODCUT '
              f'and RB >= {RB_CUT_ZR}')
        check(st['scored'][i] == int(scored.sum()),
              f'scoring night frame {i}: stats {st["scored"]}')
        j = int(np.argmin(np.hypot(data['X_IMAGE'] - 1 - tx,
                                   data['Y_IMAGE'] - 1 - ty)))
        print(f'scoring night frame {i}: {int(scored.sum())} candidates '
              f'scored, {int((data["GOODCUT"] == 1).sum())} kept at RB >= '
              f'{RB_CUT_ZR}; ML step {st["ml_s"][i]:.3f} s host clock '
              f'(frames from the card, two aligns, triplets, scores); '
              f'transient RB {float(data["RB"][j]):.4f}', flush=True)
    # H12 and H13 at SCORE_N candidates on the night's frame 0, its
    # reference and their difference
    from zuds_tpu_torch.fits import read_fits
    sci_path, ref_path = work[0].split()
    frames = [torch.as_tensor(np.ascontiguousarray(
        next(h for h in read_fits(p) if h.data is not None).data, 'f4'),
        device='cuda') for p in (sci_path, ref_path)]
    frames.append(frames[0] - frames[1])
    triplets = triplet_record(frames, record, launches)
    braai_record(triplets, record, launches, sm.calls[0][0], name)
    h13_float64_seeds(sm.calls[0][0], name)


def scoring_positions(H, W, n, size, seed=17):
    """int32 corners on the card of n seeded positions, a few past each
    edge (clamped as the filter clamps them)."""
    from zuds_tpu_torch.bench_detect import scoring_corners
    return scoring_corners(H, W, n, size, seed)


def compact_calls(out, cfg):
    """(mask, size, fill) of every H6 call in one ``detect_sources`` run on
    the slice's frame 0 (deblend=True), the masks copied."""
    from zuds_tpu_torch.constants import BAD_SUM
    from zuds_tpu_torch.ops import deblend, detect
    calls, real = [], detect.compact_indices

    def keep(mask, size, fill):
        calls.append((mask.clone(), size, fill))
        return real(mask, size, fill)

    detect.compact_indices = deblend.compact_indices = keep
    try:
        detect.detect_sources(out['diff'][0], out['rms'][0],
                              out['submask'][0],
                              (out['submask'][0] & BAD_SUM) == 0,
                              deblend=True, nsigma=cfg.nsigma,
                              max_det=cfg.max_det, det_cap=cfg.det_cap,
                              deb_cap=cfg.deb_cap)
    finally:
        detect.compact_indices = deblend.compact_indices = real
    check(len(calls) > 0, 'detect_sources made no H6 call')
    return calls


def triplet_record(frames, record, runs):
    """H12 against its plain version at SCORE_N candidates, then at
    TRIPLET_MORE (timed beside its bound, not recorded)."""
    import torch
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import cutouts
    H, W = frames[0].shape
    for n in (SCORE_N, TRIPLET_MORE):
        x0, y0 = scoring_positions(H, W, n, 63)
        k = launch.triplet_cut(*frames, x0, y0)
        p = cutouts.triplet_cut_plain(*frames, x0, y0)
        err = close('triplet_cut', k, p, 1e-6, 0.0)
        check(torch.equal(k, launch.triplet_cut(*frames, x0, y0)),
              f'two triplet_cut calls differ at {n} candidates')
        ms = graph_ms(lambda: launch.triplet_cut(*frames, x0, y0))
        call_ms = cuda_ms(lambda: launch.triplet_cut(*frames, x0, y0))
        plain = cuda_ms(lambda: cutouts.triplet_cut_plain(*frames, x0, y0),
                        1, 3)
        # reads three 63x63 windows per candidate and its corner, writes
        # as many floats; a square-add, a divide per value
        nv = n * 3 * 63 * 63
        bnd = bound(8 * nv + 8 * n, 3 * nv)
        print(f'triplet_cut: {n} candidates on {H}x{W}: {ms:.4f} ms on '
              f'the card (graph replay; bound {bnd[0]:.5f} ms, share '
              f'{bnd[0] / ms:.1%}), {call_ms:.4f} ms per wrapper call with '
              f'its host cost, plain {plain:.3f} ms, max abs err {err:.3g} '
              f'on {card()}', flush=True)
        if n == SCORE_N:
            record('triplet_cut', err, ms, plain, bnd, runs=runs,
                   per=f'scoring night of {NIGHT_PAIRS} frames')
            kept = k
    return kept


def h13_bound(cin, nbytes, flop):
    """(the bound of one H13 or H13t layer on its own unit, its fp32
    bound): layer 1 (Cin = 3) runs on fp32 FMAs, layers 2-4 on 3xTF32,
    three tensor-core products per product."""
    fp32 = bound(nbytes, flop)
    return (fp32 if cin == 3 else bound(nbytes, 3 * flop, TF32_FLOP_S)), fp32


def f64_errors(got, lib, ref):
    """(kernel, library) largest errors against the float64 ``ref``."""
    return (float((got.double() - ref).abs().max()),
            float((lib.double() - ref).abs().max()))


# (batch, seed) of inputs.labelled_triplets for h13_float64_seeds: the
# scoring path's batch on four seeds, held to cuDNN's error plus half an
# ulp; and the case where, at a batch of 16, cuDNN came out nearer
# float64 than H13 at layers 3 and 4 by more than that on an H100 (7.4e-7
# against 5.2e-7, 1.01e-6 against 6.5e-7), printed only
F64_CASES = ((256, 0), (256, 1), (256, 2), (256, 3))
F64_RECORDED = ((16, 5),)


def h13_float64_seeds(model, name):
    """H13 per layer against a float64 run of the plain version, beside
    cuDNN (TF32 off), on ``labelled_triplets`` (each layer fed the plain
    version's output of the one before): at F64_CASES the kernel's largest
    error is held to at most cuDNN's plus half an ulp of the layer's
    largest output; at every case whether it is at most cuDNN's is
    printed."""
    import numpy as np
    import torch
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import braai
    strict, cases = 0, 0
    for batch, seed in F64_CASES + F64_RECORDED:
        gated = (batch, seed) in F64_CASES
        t, _ = inputs.labelled_triplets(batch, seed=seed)
        x = torch.as_tensor(t, device='cuda')
        row = []
        for i, (cin, cout, pool) in enumerate(launch.BRAAI_LAYERS):
            layer = getattr(model, f'Conv_{i}')
            w, b = layer['kernel'], layer['bias']
            with torch.no_grad():
                k = launch.braai_conv3x3(x, w, b, pool)
                p = braai.conv3x3_plain(x, w, b, pool)
                ref = braai.conv3x3_plain(x.double(), w.double(),
                                          b.double(), pool)
            ek, el = f64_errors(k, p, ref)
            half = float(np.spacing(np.float32(float(ref.abs().max())))) / 2
            check(not gated or ek <= el + half,
                  f'H13 layer {i + 1} at batch {batch}, seed {seed}: '
                  f'{ek:.3g} from float64, cuDNN {el:.3g} (half an ulp of '
                  f'the largest output {half:.3g})')
            strict += ek <= el
            cases += 1
            row.append(f'layer {i + 1} {ek:.3g}/{el:.3g}'
                       f'{"" if ek <= el else " (past cuDNN)"}')
            x = p
        print(f'braai_conv3x3 against float64 at batch {batch}, seed {seed} '
              f'(kernel/cuDNN){"" if gated else ", recorded, not gated"}: '
              f'{", ".join(row)}', flush=True)
    print(f'braai_conv3x3 against float64: no further than cuDNN at '
          f'{strict} of {cases} layer cases; within cuDNN plus half an ulp '
          f'of the largest output at the {len(F64_CASES)} gated cases on '
          f'{name}', flush=True)


def braai_record(triplets, record, runs, model, name):
    """H13 per layer against its plain version (F.conv2d, ReLU, max_pool2d
    on NHWC views) and the library sequence (the same on NCHW tensors made
    beforehand), cuDNN with TF32 off, at SCORE_N triplets; each layer no
    further from a float64 run of the plain version than cuDNN; the scores
    of the whole net against the plain layers."""
    import torch
    import torch.nn.functional as F
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import braai
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          'TF32 is on for cuDNN or matmul')
    x = triplets
    tot = {'ms': 0.0, 'plain': 0.0, 'lib': 0.0, 'flop': 0.0, 'bytes': 0.0,
           'bound': 0.0, 'fp32': 0.0}
    err, top = 0.0, (0.0, 'bytes')
    for i, (cin, cout, pool) in enumerate(launch.BRAAI_LAYERS):
        layer = getattr(model, f'Conv_{i}')
        w, b = layer['kernel'], layer['bias']
        k = launch.braai_conv3x3(x, w, b, pool)
        p = braai.conv3x3_plain(x, w, b, pool)
        err = max(err, close(f'braai_conv3x3 layer {i + 1}', k, p, 1e-5,
                             1e-6))
        check(torch.equal(k, launch.braai_conv3x3(x, w, b, pool)),
              f'H13 layer {i + 1}: two calls differ')
        e64 = f64_errors(k, p, braai.conv3x3_plain(
            x.double(), w.double(), b.double(), pool))
        check(e64[0] <= e64[1], f'H13 layer {i + 1}: {e64[0]:.3g} from '
              f'float64, cuDNN {e64[1]:.3g}')
        xc = x.permute(0, 3, 1, 2).contiguous()
        wc = w.permute(3, 2, 0, 1).contiguous()

        def lib(xc=xc, wc=wc, b=b, pool=pool):
            y = torch.relu(F.conv2d(xc, wc, b))
            return F.max_pool2d(y, 2, 2) if pool else y

        ms = cuda_ms(lambda: launch.braai_conv3x3(x, w, b, pool))
        plain = cuda_ms(lambda: braai.conv3x3_plain(x, w, b, pool), 1, 3)
        lib_ms = cuda_ms(lib)
        # the convolution outputs the layer computes: a pooled layer skips
        # the odd last row and column that the floor pool drops
        n, ho, wo, _ = p.shape
        conv = (2 * ho) * (2 * wo) if pool else ho * wo
        flop = 2 * n * conv * cout * 9 * cin
        nbytes = 4 * (x.numel() + p.numel() + w.numel() + b.numel())
        bnd, fp32 = h13_bound(cin, nbytes, flop)
        print(f'braai_conv3x3 layer {i + 1} ({cin}->{cout}'
              f'{", pool" if pool else ""}), {n} triplets: {ms:.4f} ms '
              f'(bound {bnd[0]:.4f} ms by {bnd[1]}'
              f'{" on fp32" if cin == 3 else " on 3xTF32"}, share '
              f'{bnd[0] / ms:.1%}; fp32 bound {fp32[0]:.4f} ms, share '
              f'{fp32[0] / ms:.1%}), plain {plain:.3f} ms, cuDNN '
              f'{lib_ms:.3f} ms (TF32 off); two calls bit-equal; against '
              f'float64 the kernel {e64[0]:.3g}, cuDNN {e64[1]:.3g} on '
              f'{name}', flush=True)
        for key, v in (('ms', ms), ('plain', plain), ('lib', lib_ms),
                       ('flop', flop), ('bytes', nbytes), ('bound', bnd[0]),
                       ('fp32', fp32[0])):
            tot[key] += v
        top = max(top, bnd)
        x = p
    with torch.no_grad():
        scores = model(triplets)
        plain_scores = model.forward_plain(triplets)
    serr = float((scores - plain_scores).abs().max())
    check(serr <= 1e-6, f'braai scores: card and plain differ by {serr:.3g}')
    fwd = cuda_ms(lambda: braai.rb_scores(model, triplets))
    # the layers' bounds on their own units, added; bound_by the largest's
    bnd = (tot['bound'], top[1])
    # the dense head: the flattened features through Dense_0 (ReLU) and
    # Dense_1, two torch.matmul in fp32
    feat = x.reshape(x.shape[0], -1)
    k0, b0 = model.Dense_0['kernel'], model.Dense_0['bias']
    k1, b1 = model.Dense_1['kernel'], model.Dense_1['bias']
    head_ms = cuda_ms(lambda: torch.relu(feat @ k0 + b0) @ k1 + b1)
    head_flop = 2 * feat.shape[0] * (k0.numel() + k1.numel())
    head_bytes = 4 * (feat.numel() + k0.numel() + k1.numel()
                      + b0.numel() + b1.numel() + feat.shape[0])
    whole = (tot['bound'] + bound(head_bytes, head_flop)[0], top[1])
    print(f'braai_conv3x3: four layers per batch of {SCORE_N} triplets '
          f'{tot["ms"]:.4f} ms (bound {bnd[0]:.4f} ms, layers 2-4 on '
          f'3xTF32, {tot["flop"]:.4g} FLOP, share {bnd[0] / tot["ms"]:.1%}; '
          f'fp32 bound {tot["fp32"]:.4f} ms, share '
          f'{tot["fp32"] / tot["ms"]:.1%}), plain {tot["plain"]:.3f} ms, '
          f'cuDNN {tot["lib"]:.3f} ms; rb_scores (4 H13 and the dense head) '
          f'{fwd:.4f} ms (bound {whole[0]:.4f} ms, {head_flop:.4g} FLOP in '
          f'the head, share {whole[0] / fwd:.1%}; library: cuDNN and the '
          f'head\'s two torch.matmul {tot["lib"] + head_ms:.3f} ms, the head '
          f'alone {head_ms:.4f} ms); scores within {serr:.3g} of the plain '
          f'layers (scores {float(scores.min()):.3f}-'
          f'{float(scores.max()):.3f}) on {name}', flush=True)
    record('braai_conv3x3', err, tot['ms'], tot['plain'], bnd,
           library_ms=tot['lib'], runs=runs,
           per=f'scoring night of {NIGHT_PAIRS} frames')


def coadd_phase(wrappers, name, record):
    """ScienceCoadd.from_images over COADD_EPOCHS quadrant epochs: warm-up,
    one counted and timed build, one with the seeing estimate; the checks
    of the product; H9 and the two-plane H1 against their plain versions
    on the phase's own stack, and H9 on stacks of DEEP_EPOCHS made from it.
    ``record`` takes the two kernel records."""
    import numpy as np
    import torch
    from zuds_tpu_torch import coadd, inputs, night
    from zuds_tpu_torch.bench_combine import (combine_bound, deep_stack,
                                              same as bit_equal)
    from zuds_tpu_torch.constants import (BAD_SUM, BKG_VAL, COADD_ZP,
                                          MASK_BIT_NODATA_ALIGN)
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import background, resample
    from zuds_tpu_torch.ops import coadd as combine
    from zuds_tpu_torch.parallel import CoaddPipeline
    H, W = night.FLAGSHIP.height, night.FLAGSHIP.width
    N = COADD_EPOCHS
    with tempfile.TemporaryDirectory(prefix='chip_smoke_coadd_') as d:
        t0 = time.perf_counter()
        paths, wcss = inputs.write_coadd_epochs(d, N, H, W, cosmic=COSMIC)
        print(f'coadd: {N} epochs of {H}x{W} written in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)

        def build(out, **kw):
            t0 = time.perf_counter()
            images = [ScienceImage.from_file(p) for p in paths]
            for im in images:
                im.data, im.mask_image.data     # read the files
            load_s = time.perf_counter() - t0
            stack = coadd.ScienceCoadd.from_images(
                images, os.path.join(d, out), **kw)
            torch.cuda.synchronize()
            return stack, load_s, time.perf_counter() - t0

        _, _, warm_s = build('warm.fits', calculate_seeing=False)
        print(f'coadd: warm-up build {warm_s:.2f} s', flush=True)
        for w in wrappers.values():
            w.launches = 0
        stats = {}
        stack, load_s, secs = build('stack.fits', calculate_seeing=False,
                                    stats=stats)
        launches = {k: w.launches for k, w in wrappers.items()}
        prep = stats['prepare_s'] - stats['upload_s']
        print(f'coadd: files -> stack {N / secs:.3f} epochs/s ({N} epochs, '
              f'{secs:.2f} s, host clock) on {name}', flush=True)
        print(f'coadd: host seconds per phase: load {load_s:.3f}, prepare '
              f'{prep:.3f}, upload {stats["upload_s"]:.3f} '
              f'({stats["upload_bytes"] / N / 1e6:.1f} MB per epoch), '
              f'pipeline {stats["pipeline_s"]:.3f}, fetch '
              f'{stats["fetch_s"]:.3f}, write {stats["write_s"]:.3f}',
              flush=True)
        print(f'coadd: kernel launches per stack '
              f'{ {k: n for k, n in launches.items() if n} }', flush=True)
        check(launches['warp'] == N and launches['background_cells'] == N
              and launches['clipped_combine'] == 1,
              f'coadd: expected {N} H1, {N} H2 and 1 H9 launches, got '
              f'{launches}')

        # ---- the product ---------------------------------------------------
        data = stack.data
        wmap = stack.weight_image.data
        mask = stack.mask_image.data
        oh, ow = data.shape
        check(oh >= H and ow >= W and np.isfinite(data).all(),
              f'coadd: product of shape {data.shape} or not finite')
        check(stack.header['MAGZP'] == COADD_ZP
              and stack.header['NCOADD'] == N
              and stack.header['NAXIS1'] == ow
              and stack.header['NAXIS2'] == oh, 'coadd: header cards')
        check(np.array_equal((mask >> MASK_BIT_NODATA_ALIGN & 1) == 1,
                             wmap == 0),
              'coadd: the no-data bit is not exactly where weight == 0')
        inner = data[32:-32, 32:-32]
        sky = inner[np.abs(inner - np.median(inner)) < 20]
        scale = combine.fluxscale(inputs.COADD_MAGZP)
        limit = COADD_NOISE / np.sqrt(N) * scale * 1.25
        check(sky.std() < limit and abs(np.median(inner) - BKG_VAL) < 0.5,
              f'coadd: sky noise {sky.std():.4f} (limit {limit:.4f}), level '
              f'{np.median(inner):.3f}')
        back = coadd.ScienceCoadd.from_file(os.path.join(d, 'stack.fits'))
        check(np.array_equal(back.data, data), 'coadd: saved file differs')
        print(f'coadd: product {oh}x{ow}, MAGZP {stack.header["MAGZP"]}, '
              f'NCOADD {stack.header["NCOADD"]}, sky {np.median(inner):.3f} '
              f'+- {sky.std():.4f} counts (limit {limit:.4f}), '
              f'{int((wmap == 0).sum())} no-data pixels, all with the '
              f'no-data bit', flush=True)

        # ---- the stack again with a database bound (the db phase) ----------
        coadd_db(wrappers, name, d, paths, launches)

        # ---- the phase's own warped stack: H9 and H1 against plain ---------
        images = [ScienceImage.from_file(p) for p in paths]
        cfg, args = coadd.fused_inputs(images, stack.wcs, oh, ow)
        imgs, sats, masks, gus, gvs, covbs, scales, valid = args
        Hb, Wb = cfg.height, cfg.width
        pipe = CoaddPipeline(cfg)
        iw = torch.empty((N, Hb, Wb), device='cuda')
        ww = torch.empty_like(iw)
        mw = torch.empty((N, Hb, Wb), dtype=torch.int32, device='cuda')
        cov = torch.empty((N, Hb, Wb), dtype=torch.bool, device='cuda')
        for n in range(N):
            pipe.warp_epoch(imgs[n], sats[n], masks[n], gus[n], gvs[n],
                            covbs[n], valid[n], iw[n], ww[n], mw[n], cov[n])
        # H2 on an epoch on the canvas, as warp_epoch runs it
        bad0 = (masks[0] & BAD_SUM) > 0
        kb = launch.background_cells(imgs[0], ~bad0, cfg.box, 3)
        pb = background.background_cells_plain(imgs[0], ~bad0, cfg.box, 3)
        check(all(torch.equal(a, b) for a, b in zip(kb, pb)),
              'coadd: background_cells not bit-equal to the plain version '
              'on the canvas')
        cells_ms = graph_ms(lambda: launch.background_cells(
            imgs[0], ~bad0, cfg.box, 3))
        print(f'background_cells: epoch 0 on the {Hb}x{Wb} canvas: back, '
              f'sigma, n bit-equal to the plain version; {cells_ms:.4f} ms '
              f'(graph replay)', flush=True)
        del kb, pb, bad0
        k = combine.clipped_combine(iw, ww, mw, cov, scales)
        p = combine.clipped_combine_plain(iw, ww, mw, cov, scales)
        torch.cuda.synchronize()
        for key in ('nexp', 'nclip', 'mask', 'coadd', 'weight'):
            check(bit_equal(k[key], p[key]),
                  f'clipped_combine {key} differs from the plain version at '
                  f'{int((k[key] != p[key]).sum())} pixels')
        err = max(close('clipped_combine coadd', k['coadd'], p['coadd'],
                        2e-6, 0.0),
                  close('clipped_combine weight', k['weight'], p['weight'],
                        2e-6, 0.0))
        check(np.array_equal(k['coadd'][:oh, :ow].cpu().numpy() + BKG_VAL,
                             data),
              'coadd: the product is not H9 of the warped stack')
        # the cosmic ray, at the output pixel its epoch pixel maps to
        ce, cx, cy, _ = COSMIC
        ra, dec = wcss[ce].pix2sky_0(np.array([float(cx)]),
                                     np.array([float(cy)]))
        ox, oy = (int(round(float(t[0])))
                  for t in stack.wcs.sky2pix_0(ra, dec))
        hit = float(iw[ce, oy, ox] * scales[ce])
        level = float(np.median(data[oy - 8:oy + 9, ox - 8:ox + 9]))
        check(int(k['nclip'][oy, ox]) == 1 and int(k['nexp'][oy, ox]) == N
              and abs(float(data[oy, ox]) - level) < 10.0,
              f'coadd: cosmic ray at output ({ox}, {oy}): nclip '
              f'{int(k["nclip"][oy, ox])}, coadd {float(data[oy, ox]):.2f}, '
              f'neighbours {level:.2f}')
        print(f'coadd: cosmic ray of epoch {ce} at output ({ox}, {oy}): '
              f'{hit:.1f} scaled counts in its epoch, nclip 1, coadd '
              f'{float(data[oy, ox]):.2f} against {level:.2f} around it; '
              f'{int((k["nclip"] > 0).sum())} pixels clipped in all',
              flush=True)
        npx = Hb * Wb
        ms = cuda_ms(lambda: launch.clipped_combine(
            iw, ww, mw, cov, scales, 4.0, 0.3, MASK_BIT_NODATA_ALIGN))
        plain = cuda_ms(lambda: combine.clipped_combine_plain(
            iw, ww, mw, cov, scales), 1, 3)
        sort_ms = cuda_ms(lambda: torch.sort(iw, dim=0), 1, 3)
        # reads pixel, weight, mask, coverage of every epoch (13 B), writes
        # five planes (20 B); per pixel the sorting network's comparators
        # (two operations each) and ~12 operations per epoch
        bnd = combine_bound(N, npx)
        print(f'clipped_combine: {N}x{Hb}x{Wb}: all five outputs bit-equal; '
              f'{ms:.4f} ms (bound {bnd[0]:.4f} ms, share '
              f'{bnd[0] / ms:.1%}), plain {plain:.3f} ms, torch.sort of the '
              f'stack (for scale) {sort_ms:.3f} ms', flush=True)
        record('clipped_combine', err, ms, plain, bnd, runs=launches,
               per=f'stack of {N} epochs')

        # deeper stacks, made from the phase's own warped epochs with
        # seeded noise, cosmic rays, NaN and +-inf at weight > 0 and epochs
        # without weight: bit-equal on a band of rows, H9 timed on the
        # whole canvas
        for n in DEEP_EPOCHS:
            di, dw, dm, dc = deep_stack(iw, ww, mw, cov, n, 700 + n)
            dscales = scales[torch.arange(n, device='cuda') % N].contiguous()
            kd_ = combine.clipped_combine(di, dw, dm, dc, dscales)
            pd_ = combine.clipped_combine_plain(
                di[:, :DEEP_BAND], dw[:, :DEEP_BAND], dm[:, :DEEP_BAND],
                dc[:, :DEEP_BAND], dscales)
            for key in pd_:
                check(bit_equal(kd_[key][:DEEP_BAND], pd_[key]),
                      f'clipped_combine at {n} epochs: {key} differs from '
                      f'the plain version on the first {DEEP_BAND} rows')
            check(bool((kd_['nexp'][100:102, 1000:1016] == n).all()),
                  f'clipped_combine at {n} epochs: the NaN and +-inf pixels '
                  f'are not at weight > 0 in every epoch')
            dms = graph_ms(lambda: launch.clipped_combine(
                di, dw, dm, dc, dscales, 4.0, 0.3, MASK_BIT_NODATA_ALIGN))
            dbnd = combine_bound(n, npx)
            print(f'clipped_combine: {n}x{Hb}x{Wb} (made from the stack\'s '
                  f'epochs): bit-equal to the plain version on the first '
                  f'{DEEP_BAND} rows; {dms:.4f} ms (graph replay; bound '
                  f'{dbnd[0]:.4f} ms by {dbnd[1]}, share {dbnd[0] / dms:.1%}'
                  f'); {int((kd_["nclip"] > 0).sum())} pixels clipped',
                  flush=True)
            del di, dw, dm, dc, kd_, pd_
            torch.cuda.empty_cache()

        # H1 with two planes: epoch 0's frame, its weight and its mask
        img0, m0 = imgs[0], masks[0]
        bad = (m0 & BAD_SUM) > 0
        rms = background.background_mesh(img0, ~bad, box=cfg.box)['rms']
        wgt0 = torch.where(bad | (rms <= 0), 0.0,
                           1.0 / torch.clamp(rms, min=1e-12) ** 2).contiguous()
        u, v = resample.upsample_mapping(gus[0], gvs[0], (Hb, Wb),
                                         cfg.map_step)
        k1 = resample.warp_epoch(img0, wgt0, m0, u, v, covbs[0],
                                 cfg.max_shift)
        p1 = resample.warp_epoch_plain(img0, wgt0, m0, u, v, covbs[0],
                                       cfg.max_shift)
        err = close('two-plane warp pixels', k1[0], p1[0], 3e-5, 5e-3)
        close('two-plane warp weight', k1[1], p1[1], 3e-5, 1e-6)
        check(torch.equal(k1[2], p1[2]) and torch.equal(k1[3], p1[3]),
              'two-plane warp: mask or coverage differs from the plain '
              'composition')
        one = launch.warp(img0, m0, u, v, covbs[0], cfg.max_shift)
        check(torch.equal(one[0], k1[0]) and torch.equal(one[1], k1[2]),
              'two-plane warp: its first plane differs from the one-plane '
              'launch')
        check(all(torch.equal(a, b) for a, b in zip(
            launch.warp(img0, m0, u, v, covbs[0], cfg.max_shift, ref2=wgt0),
            launch.warp(img0, m0, u, v, covbs[0], cfg.max_shift,
                        ref2=wgt0))),
              'two-plane warp: two calls differ')
        dbl = [t.double() for t in (img0, wgt0, u, v, covbs[0])]
        p64 = resample.warp_epoch_plain(dbl[0], dbl[1], m0, dbl[2], dbl[3],
                                        dbl[4], cfg.max_shift)
        e64 = warp_f64('two-plane warp pixels', k1[0], p1[0], p64[0], p1[3])
        w64 = warp_f64('two-plane warp weight', k1[1], p1[1], p64[1], p1[3])
        del p64, dbl
        ms = graph_ms(lambda: launch.warp(img0, m0, u, v, covbs[0],
                                          cfg.max_shift, ref2=wgt0))
        call = cuda_ms(lambda: launch.warp(img0, m0, u, v, covbs[0],
                                           cfg.max_shift, ref2=wgt0))
        one_ms = graph_ms(lambda: launch.warp(img0, m0, u, v, covbs[0],
                                              cfg.max_shift))
        plain = cuda_ms(lambda: resample.warp_epoch_plain(
            img0, wgt0, m0, u, v, covbs[0], cfg.max_shift), 1, 2)
        bnd = warp_bound(npx, 2)
        print(f'warp_two_planes: {Hb}x{Wb}: {ms:.4f} ms on the card (graph '
              f'replay; {call:.4f} ms per wrapper call with its host cost; '
              f'one plane {one_ms:.4f} ms at this shape; bound {bnd[0]:.4f} '
              f'ms by {bnd[1]}, share {bnd[0] / ms:.1%}), plain {plain:.3f} '
              f'ms; against the float64 plain version: pixels {e64[0]:.4g} '
              f'(f32 plain {e64[1]:.4g}), weight {w64[0]:.4g} ({w64[1]:.4g})',
              flush=True)
        record('warp_two_planes', err, ms, plain, bnd,
               runs={'warp_two_planes': launches['warp']},
               per=f'stack of {N} epochs')
        del iw, ww, mw, cov, k, p, k1, p1, args, imgs, masks

        # ---- with the seeing estimate --------------------------------------
        seen, _, see_s = build('seeing.fits', calculate_seeing=True)
        see = seen.header['SEEING']
        check(1.8 < see < 2.6 and seen.header["NSTARSEE"] >= 20
              and os.path.exists(os.path.join(d, 'seeing.cat')),
              f'coadd: SEEING {see} from {seen.header["NSTARSEE"]} stars')
        print(f'coadd: with calculate_seeing {see_s:.2f} s; SEEING '
              f'{see:.4f} px from {seen.header["NSTARSEE"]} stars (the '
              f'scene\'s is {inputs.COADD_SEEING})', flush=True)

    # ---- a small stack on the card and on the CPU (plain versions) ---------
    with tempfile.TemporaryDirectory(prefix='chip_smoke_coadd_') as d:
        paths, _ = inputs.write_coadd_epochs(d, 4, 512, 512, seed=13,
                                             nstars=50)
        images = [ScienceImage.from_file(p) for p in paths]
        wcs, (h, w) = coadd.coadd_grid(images)
        outs = {}
        for where in ('cuda', 'cpu'):
            cfg, args = coadd.fused_inputs(images, wcs, h, w, device=where)
            outs[where] = {k_: v_.cpu() for k_, v_ in
                           CoaddPipeline(cfg)(*args).items()}
        a, b = outs['cuda'], outs['cpu']
        for key in ('nexp', 'mask'):
            check(torch.equal(a[key], b[key]),
                  f'small stack: {key} differs between card and CPU at '
                  f'{int((a[key] != b[key]).sum())} pixels')
        far = ((a['coadd'] - b['coadd']).abs() > 5e-3).float().mean()
        check(float(far) <= 1e-3, f'small stack: {float(far):.2e} of the '
              'pixels differ by more than 5e-3 counts')
        close('small stack weight', a['weight'], b['weight'], 2e-3, 0.0)
        print(f'small stack (4 epochs of 512x512): card and CPU agree on '
              f'nexp and mask; coadd max abs diff '
              f'{float((a["coadd"] - b["coadd"]).abs().max()):.3g}, '
              f'{float(far):.2e} of the pixels past 5e-3 counts', flush=True)
    return launches, secs, stats


def coadd_db(wrappers, name, d, paths, want):
    """The stack of the coadd phase's epochs with a database bound: ``sci``
    records for the epochs, the epochs read by ``from_file`` (each takes
    its record's id), ``ScienceCoadd.from_images`` counted (the launches of
    the phase's counted build, ``want``): one ``scicoadd`` record and one
    ``CoaddImage`` join an epoch, to the epochs' ids."""
    import torch
    from zuds_tpu_torch import core
    from zuds_tpu_torch.coadd import ScienceCoadd
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.joins import CoaddImage
    with bound_db(d, 'coadd'):
        sess = core.DBSession()
        t0 = time.perf_counter()
        for p in paths:
            sess.add(core.record_from_image(ScienceImage.from_file(p),
                                            'sci'))
        sess.commit()
        rec_s = time.perf_counter() - t0
        images = [ScienceImage.from_file(p) for p in paths]
        ids = [im.id for im in images]
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stack = ScienceCoadd.from_images(images, os.path.join(d, 'db.fits'),
                                         calculate_seeing=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        used = counts_of(wrappers)
        check(used == {k: n for k, n in want.items() if n},
              f'db coadd: launches {used}, the counted build {want}')
        recs = sess.query(core.ZTFFile).filter_by(type='scicoadd').all()
        joins = sess.query(CoaddImage).order_by('id').all()
        check(len(recs) == 1 and stack.id == recs[0].id
              and None not in ids
              and [(j.coadd_id, j.calibratableimage_id) for j in joins]
              == [(stack.id, i) for i in ids],
              f'db coadd: records {recs}, joins '
              f'{[(j.coadd_id, j.calibratableimage_id) for j in joins]}')
        print(f'db: ScienceCoadd.from_images with a database bound '
              f'{secs:.2f} s for {len(paths)} epochs (host clock; their '
              f'records {rec_s:.3f} s before): one scicoadd record (id '
              f'{stack.id}), {len(joins)} CoaddImage joins to the epochs\' '
              f'ids {ids}; launches {used} on {name}', flush=True)


class gaia_config:
    """The port's config pointed at a file in ``d`` whose
    ``gaia_cache_directory`` is ``cache``; restored on exit."""

    def __init__(self, d, cache):
        self.path = os.path.join(d, 'gaia.conf')
        self.cache = cache

    def __enter__(self):
        from zuds_tpu_torch import secrets
        with open(self.path, 'w') as f:
            f.write(f'gaia_cache_directory: {self.cache}\n')
        os.chmod(self.path, 0o600)
        self.env = os.environ.get('ZUDS_CONFIG')
        os.environ['ZUDS_CONFIG'] = self.path
        secrets._manager.cache = None
        return self

    def __exit__(self, *exc):
        from zuds_tpu_torch import secrets
        secrets._manager.cache = None
        if self.env is None:
            os.environ.pop('ZUDS_CONFIG', None)
        else:
            os.environ['ZUDS_CONFIG'] = self.env


def check_stack(tag, stack, n):
    """A reference stack's checks, as the coadd phase holds a ScienceCoadd:
    header cards, a finite product over the epochs' frame, the no-data bit
    exactly at weight 0, the sky's level and noise, SEEING from >= 20
    stars and the catalog beside it; the grid's WCS undistorted. Returns
    its SEEING and its catalog's stars (``seeing.select_stars``)."""
    from zuds_tpu_torch.seeing import select_stars
    import numpy as np
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.constants import (BKG_VAL, COADD_ZP,
                                          MASK_BIT_NODATA_ALIGN)
    from zuds_tpu_torch.ops import coadd as combine
    data = stack.data
    wmap = stack.weight_image.data
    mask = stack.mask_image.data
    oh, ow = data.shape
    h = stack.header
    check(h['MAGZP'] == COADD_ZP and h['NCOADD'] == n
          and h['NAXIS1'] == ow and h['NAXIS2'] == oh
          and not [k for k in h.keys() if k.startswith(('PV1_', 'PV2_'))],
          f'{tag}: header cards')
    check(np.isfinite(data).all(), f'{tag}: product not finite')
    check(np.array_equal((mask >> MASK_BIT_NODATA_ALIGN & 1) == 1,
                         wmap == 0),
          f'{tag}: the no-data bit is not exactly where weight == 0')
    inner = data[32:-32, 32:-32]
    sky = inner[np.abs(inner - np.median(inner)) < 20]
    limit = COADD_NOISE / np.sqrt(n) * combine.fluxscale(
        inputs.COADD_MAGZP) * 1.25
    check(sky.std() < limit and abs(np.median(inner) - BKG_VAL) < 0.5,
          f'{tag}: sky noise {sky.std():.4f} (limit {limit:.4f}), level '
          f'{np.median(inner):.3f}')
    see = h['SEEING']
    check(1.8 < see < 3.5 and h['NSTARSEE'] >= 20
          and os.path.exists(stack.local_path.replace('.fits', '.cat')),
          f'{tag}: SEEING {see} from {h["NSTARSEE"]} stars')
    print(f'{tag}: {oh}x{ow}, NCOADD {n}, sky {np.median(inner):.3f} +- '
          f'{sky.std():.4f} counts (limit {limit:.4f}), '
          f'{int((wmap == 0).sum())} no-data pixels, all with the bit; '
          f'SEEING {see:.4f} px from {h["NSTARSEE"]} stars', flush=True)
    return see, select_stars(stack.catalog)


def flux_ratio(stars, base):
    """The median ratio of the r = 3 px fluxes of the stars of ``stars``
    matched to those of ``base`` (within 2 arcsec), and the matches."""
    import numpy as np
    from zuds_tpu_torch.scamp import match_catalogs
    i1, i2 = match_catalogs(stars['X_WORLD'], stars['Y_WORLD'],
                            base['X_WORLD'], base['Y_WORLD'])
    return (float(np.median(stars['FLUX_APER'][i1]
                            / base['FLUX_APER'][i2])), len(i1))


def ref_phase(wrappers, name):
    """The reference build (makeref, queryref, scamp) on REF_EPOCHS
    3080x3072 epochs of the coadd scene: the epochs registered in a fresh
    sqlite file, ``queryref`` (one line), ``makeref.do_one`` on that line
    (14 epochs pass the cut; the ``ref`` record committed; counted); then
    the same 14 epochs with header WCS errors through
    ``ReferenceImage.from_images`` unsolved, solved against a Gaia-like
    cache of the scene's true star positions, and solved with no cache
    (epoch 0's stars the reference), each counted and on fresh copies of
    the epochs; the refit WCS and the stacks' SEEING gated."""
    import shutil
    import contextlib
    import numpy as np
    import torch
    from zuds_tpu_torch import core, inputs, makeref, night, queryref
    from zuds_tpu_torch.coadd import ReferenceImage
    from zuds_tpu_torch.constants import REFERENCE_VERSION
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.scamp import _TPV_DEG_IDX, match_catalogs
    from zuds_tpu_torch.seeing import select_stars
    H, W = night.FLAGSHIP.height, night.FLAGSHIP.width
    n_ep = REF_EPOCHS
    seeing = [inputs.COADD_SEEING] * n_ep
    seeing[REF_BAD_SEEING] = 3.0 / (inputs.COADD_SCALE * 3600.0)
    infobits = [0] * n_ep
    infobits[REF_BAD_INFOBITS] = 4
    maglim = [20.0 + 0.1 * i for i in range(n_ep)]
    keep = [i for i in range(n_ep) if i not in (REF_BAD_SEEING,
                                                REF_BAD_INFOBITS)]
    kw = dict(seeing=seeing, maglim=maglim, infobits=infobits)
    ra, dec = inputs.coadd_stars(H, W)
    nparams = sum(len(v) for v in _TPV_DEG_IDX.values())
    with tempfile.TemporaryDirectory(prefix='chip_smoke_ref_') as d:
        true_d = os.path.join(d, 'true')
        os.makedirs(true_d)
        t0 = time.perf_counter()
        paths, true = inputs.write_coadd_epochs(true_d, n_ep, H, W, **kw)
        print(f'ref: {n_ep} epochs of {H}x{W} written in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)

        # ---- register, query, makeref --------------------------------------
        with bound_db(d, 'ref'), contextlib.chdir(true_d):
            sess = core.DBSession()
            sess.add_all([core.record_from_image(ScienceImage.from_file(p),
                                                 'sci') for p in paths])
            sess.commit()
            lines = queryref.main()
            check(len(lines) == 1 and lines[0].split()[1:]
                  == [os.path.basename(p) for p in paths],
                  f'ref: queryref emitted {lines}')
            for w in wrappers.values():
                w.launches = 0
            st = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = makeref.do_one(lines[0], stats=st)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            used = counts_of(wrappers)
            recs = sess.query(core.ZTFFile).filter_by(type='ref').all()
            check(len(recs) == 1 and recs[0].id == ref.id
                  and recs[0].version == REFERENCE_VERSION
                  and queryref.main() == [],
                  f'ref: records {recs}; queryref after makeref')
        check(used.get('warp') == 14 and used.get('clipped_combine') == 1
              and all(used.get(k) == v for k, v in CATALOG_LAUNCHES.items())
              and used.get('background_cells', 0) >= 15,
              f'ref: makeref launches {used}: 14 H1, 1 H9, one catalog '
              f'(the SEEING)')
        print(f'ref: queryref -> 1 line of {n_ep} epochs; makeref.do_one '
              f'{14 / secs:.3f} epochs/s (14 of {n_ep} pass the cut, '
              f'{secs:.2f} s, host clock) on {name}; host s: prepare '
              f'{st["prepare_s"]:.3f} (upload {st["upload_s"]:.3f}), '
              f'pipeline {st["pipeline_s"]:.3f}, fetch {st["fetch_s"]:.3f}, '
              f'write {st["write_s"]:.3f}, seeing {st["seeing_s"]:.3f}; '
              f'launches {used}; ref record id {ref.id}, version '
              f'{REFERENCE_VERSION}', flush=True)
        see_true, stars_true = check_stack('ref: makeref stack (true WCS)',
                                           ref, 14)
        del ref
        shutil.rmtree(true_d)

        # ---- the same epochs with header WCS errors ------------------------
        err_d = os.path.join(d, 'err')
        os.makedirs(err_d)
        epaths, _ = inputs.write_coadd_epochs(
            err_d, n_ep, H, W, wcs_errors=True, **kw)
        heads = [ScienceImage.from_file(epaths[i]).wcs for i in keep]
        truth = [np.array(true[i].sky2pix(ra, dec)) for i in keep]
        before = [np.hypot(*(np.array(h.sky2pix(ra, dec)) - t))
                  for h, t in zip(heads, truth)]
        print(f'ref: header WCS errors at the {len(ra)} stars: max '
              f'{max(b.max() for b in before):.3f} px, rms per epoch '
              f'{min(np.sqrt((b ** 2).mean()) for b in before):.3f}-'
              f'{max(np.sqrt((b ** 2).mean()) for b in before):.3f} px',
              flush=True)
        gaia = os.path.join(d, 'gaia')
        gaia_file = inputs.write_gaia_cache(gaia, H, W)

        def run(tag, cache, solve):
            run_d = os.path.join(d, tag)
            os.makedirs(run_d)
            for i in keep:
                for q in (epaths[i], epaths[i].replace('sciimg', 'mskimg')):
                    shutil.copy(q, run_d)
            mine = [os.path.join(run_d, os.path.basename(epaths[i]))
                    for i in keep]
            with gaia_config(d, cache):
                t0 = time.perf_counter()
                images = [ScienceImage.from_file(p) for p in mine]
                for im in images:
                    im.data, im.mask_image.data     # read the files
                load_s = time.perf_counter() - t0
                for w in wrappers.values():
                    w.launches = 0
                st = {}
                t0 = time.perf_counter()
                stack = ReferenceImage.from_images(
                    images, os.path.join(run_d, 'ref.fits'),
                    solve_astrometry=solve, stats=st)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            used = counts_of(wrappers)
            ncat = 15 if solve else 1
            check(used.get('warp') == 14 and used.get('clipped_combine') == 1
                  and all(used.get(k) == v * ncat
                          for k, v in CATALOG_LAUNCHES.items())
                  and used.get('background_cells', 0) >= 14 + ncat,
                  f'ref {tag}: launches {used}')
            print(f'ref {tag}: from_images(solve_astrometry={solve}) '
                  f'{secs:.2f} s for 14 epochs (host clock) on {name}: load '
                  f'{load_s:.3f} (before), per-epoch catalogs '
                  f'{st.get("catalog_s", 0.0):.3f}, scamp fit '
                  f'{st.get("scamp_s", 0.0):.3f}, stack '
                  f'{st["prepare_s"] + st["pipeline_s"] + st["fetch_s"]:.3f}'
                  f' (pipeline {st["pipeline_s"]:.3f}), write '
                  f'{st["write_s"]:.3f}, seeing {st["seeing_s"]:.3f}; '
                  f'launches {used}', flush=True)
            return images, check_stack(f'ref {tag}', stack, 14), run_d

        # ---- unsolved, solved with the cache, solved without ---------------
        sees = {}
        _, sees['unsolved'], run_d = run('unsolved', os.path.join(d, 'none'),
                                         False)
        shutil.rmtree(run_d)
        for tag, cache in (('cache', gaia), ('nocache',
                                             os.path.join(d, 'none'))):
            images, sees[tag], run_d = run(tag, cache, True)
            if tag == 'cache':
                cached = np.load(gaia_file)
                ref_ra, ref_dec = cached['ra'], cached['dec']
                frame, where = (ra, dec), ''
            else:
                s0 = select_stars(images[0].catalog)
                ref_ra, ref_dec = s0['X_WORLD'], s0['Y_WORLD']
                # epoch 0's header frame: the stars where it puts them
                frame = heads[0].pix2sky(*truth[0])
                where = ', in epoch 0\'s header frame'
            rows = []
            for k, (im, t, h) in enumerate(zip(images, truth, heads)):
                stars = select_stars(im.catalog)
                i1, _ = match_catalogs(stars['X_WORLD'], stars['Y_WORLD'],
                                       ref_ra, ref_dec)
                back = ScienceImage.from_file(im.local_path).wcs
                err = np.hypot(*(np.array(back.sky2pix(*frame)) - t))
                rms = float(np.sqrt((err ** 2).mean()))
                cubic = bool(np.any(back.pv1[7:11]) or np.any(back.pv2[7:11]))
                deg3 = len(i1) >= 2 * nparams
                check(len(i1) >= 5 and cubic == deg3 and (
                    deg3 or not np.array_equal(back.cd, h.cd)),
                      f'ref {tag}: epoch {keep[k]}: {len(i1)} matches, '
                      f'cubic terms {cubic}')
                check(rms <= REF_SOLVE_RMS_PX and err.max() <= REF_SOLVE_MAX_PX,
                      f'ref {tag}: epoch {keep[k]}: refit WCS off the true '
                      f'star positions by rms {rms:.4f}, max '
                      f'{err.max():.4f} px (limits {REF_SOLVE_RMS_PX}, '
                      f'{REF_SOLVE_MAX_PX})')
                rows.append(f'{keep[k]}:{len(i1)}/{rms:.4f}/{err.max():.4f}')
            print(f'ref {tag}: every epoch solved (epoch: matches/rms/max px '
                  f'at the {len(ra)} true star positions{where}; degree 3 '
                  f'at >= {2 * nparams} matches) {" ".join(rows)}',
                  flush=True)
            del images
            shutil.rmtree(run_d)
    rows = []
    for tag, (see, stars) in sees.items():
        ratio, nmatch = flux_ratio(stars, stars_true)
        if tag == 'unsolved':
            check(abs(ratio - 1.0) > REF_FLUX_SHARE,
                  f'ref unsolved: its stars\' r = 3 px flux {ratio:.4f} of '
                  f'the true-WCS stack\'s: the gate cannot see the error')
        else:
            check(abs(see / see_true - 1.0) <= REF_FWHM_SHARE
                  and abs(ratio - 1.0) <= REF_FLUX_SHARE,
                  f'ref {tag}: SEEING {see:.4f} px against the true-WCS '
                  f'stack\'s {see_true:.4f} (share {REF_FWHM_SHARE}), star '
                  f'flux {ratio:.4f} of its (share {REF_FLUX_SHARE})')
        rows.append(f'{tag} {see:.4f} px ({see / see_true - 1:+.2%}), flux '
                    f'{ratio:.4f} over {nmatch} stars')
    print(f'ref: stack SEEING and r = 3 px star flux against the true-WCS '
          f'stack (SEEING {see_true:.4f} px, {len(stars_true)} stars): '
          f'{"; ".join(rows)}; limits {REF_FWHM_SHARE:.0%} and '
          f'{REF_FLUX_SHARE:.0%} on {name}', flush=True)


def pair_phase(wrappers, name, record, fused_pair_s):
    """sub.do_one on a pair whose reference is rotated by PAIR_ROT degrees
    (the gather warp) and on an unrotated pair (the planned warp): a
    warm-up, then counted, timed runs on fresh copies; the checks of the
    product; H10, H3 at one term (the variance and the order-0 model) and
    H11 against their plain versions on the rotated pair's tensors; a
    small rotated pair on card and CPU. ``record`` takes the four kernel
    records."""
    import shutil
    import numpy as np
    import torch
    from zuds_tpu_torch import inputs, night, sub
    from zuds_tpu_torch.bench_detect import negpix_bound
    from zuds_tpu_torch.catalog import PipelineFITSCatalog
    from zuds_tpu_torch.coadd import ReferenceImage
    from zuds_tpu_torch.constants import (BAD_SUM, BKG_VAL,
                                          SUB_NODATA_SENTINEL)
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import cutouts, resample, subtract
    from zuds_tpu_torch.ops import measure as measure_ops
    from zuds_tpu_torch.subtraction import SingleEpochSubtraction
    H, W = night.FLAGSHIP.height, night.FLAGSHIP.width
    header_json = (Path(__file__).resolve().parent / 'tests' / 'data'
                   / 'ztf_real_header.json')
    dev = torch.device('cuda')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_pair_') as d:
        src = os.path.join(d, 'src')
        os.mkdir(src)
        t0 = time.perf_counter()
        work, truths = inputs.write_night_pairs(
            src, 2, H, W, ref_rot_deg=(0.0, PAIR_ROT),
            header_json=header_json)
        plans = [pair_plan(w) for w in work]
        print(f'pair: an unrotated pair and one rotated by {PAIR_ROT} deg '
              f'written in {time.perf_counter() - t0:.1f} s; host warp '
              f'plans {plans}', flush=True)
        check(plans[0] is not None and plans[1] is None,
              f'pair: warp plans {plans}')

        def run(tag, i, ml=False, refine_calls=None):
            """do_one on a fresh copy of pair ``i`` (a pair's products are
            cached beside it), counted and timed; ``refine_calls`` takes
            the arguments of its catalogs' H23 calls."""
            dd = os.path.join(d, tag)
            shutil.copytree(src, dd)
            line = work[i].replace(src, dd)
            for w in wrappers.values():
                w.launches = 0
            st = {}
            if refine_calls is not None:
                refine = measure_ops.refine_detections

                def taken(img, rms, *args, **kw):
                    refine_calls.append((img.contiguous(), rms.contiguous(),
                                         tuple(a.contiguous() for a in args)))
                    return refine(img, rms, *args, **kw)
                measure_ops.refine_detections = taken
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                product, rows = sub.do_one(line, ml=ml, stats=st)
            finally:
                if refine_calls is not None:
                    measure_ops.refine_detections = refine
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            return (product, rows, st, secs,
                    {k: w.launches for k, w in wrappers.items()}, line)

        _, _, _, warm_s, _, _ = run('warm', 1)
        print(f'pair: warm-up do_one {warm_s:.2f} s', flush=True)
        results, pair_s = {}, {}
        refine_calls = []
        for tag, i in (('gather', 1), ('planned', 0)):
            product, rows, st, secs, launches, line = run(
                tag, i, refine_calls=refine_calls if tag == 'gather' else None)
            results[tag] = (product, launches, line, st['filter_s'])
            pair_s[tag] = (secs, st)
            used = {k: n for k, n in launches.items() if n}
            print(f'pair ({tag} warp): files -> filtered catalog '
                  f'{secs * 1e3:.0f} ms per pair against '
                  f'{fused_pair_s * 1e3:.0f} ms per pair of the batched '
                  f'night ({secs / fused_pair_s:.1f}x), host clock, on '
                  f'{name}', flush=True)
            print(f'pair ({tag} warp): host seconds: ' + ', '.join(
                f'{k[:-2]} {st[k]:.3f}' for k in (
                    'load_s', 'align_s', 'products_s', 'fit_s', 'subtract_s',
                    'assemble_s', 'catalog_s', 'filter_s'))
                + f'; kernel launches {used}', flush=True)
            gather = tag == 'gather'
            check(launches['warp_gather'] == (3 if gather else 0)
                  and launches['warp'] == (0 if gather else 3)
                  and launches['apply_model'] == 1
                  and launches['apply_model_variance'] == 1
                  and launches['subtract_epilogue'] == 1,
                  f'pair ({tag}): launches {launches}')
            tx, ty = truths[i]
            dist = np.hypot(rows['X_IMAGE'] - 1 - tx, rows['Y_IMAGE'] - 1 - ty)
            check(len(dist) and dist.min() < 2.0,
                  f'pair ({tag}): transient at ({tx}, {ty}) not a GOODCUT '
                  f'row ({len(rows)} rows)')
            hdr = product.header
            check(hdr['SUBMETH'] == 'hotpants', f'pair: SUBMETH {hdr}')
            for path in (product.local_path, product.mask_image.local_path,
                         product.local_path.replace('.fits', '.cat')):
                check(os.path.exists(path), f'pair: {path} is not on disk')
            cat = PipelineFITSCatalog.from_file(
                product.local_path.replace('.fits', '.cat'))
            check(int((cat.data['GOODCUT'] == 1).sum()) == len(rows),
                  'pair: the saved catalog differs from the returned rows')
            print(f'pair ({tag} warp): SUBKO {hdr["SUBKO"]}, SUBNRX '
                  f'{hdr["SUBNRX"]}, SEEING {hdr["SEEING"]}; transient at '
                  f'({tx:.0f}, {ty:.0f}) a GOODCUT row {dist.min():.2f} px '
                  f'away ({len(rows)} GOODCUT rows); sub, mask and catalog '
                  f'on disk', flush=True)

        # H23 at the pair catalogs' own N (the rotated pair's science and
        # subtraction catalogs, their valid rows)
        check(len(refine_calls) == 2,
              f'pair: {len(refine_calls)} catalog refinements, not 2')
        for j, (img, rms, rargs) in enumerate(refine_calls):
            refine_case(img, rms, rargs, f'pair catalog {j}', name)
        del refine_calls

        # ---- the scoring step: do_one on the rotated pair at ml=True -------
        with scoring_model(d) as sm:
            scored, _, st, secs, ml_launches, _ = run('scored', 1, ml=True)
        check(ml_launches['negpix_veto'] == 1
              and ml_launches['triplet_cut'] == 1
              and ml_launches['braai_conv3x3'] == 4,
              f'pair (ml=True): launches {ml_launches}')
        err = check_scores(sm.calls, 'pair (ml=True)')
        data = PipelineFITSCatalog.from_file(
            scored.local_path.replace('.fits', '.cat')).data
        tx, ty = truths[1]
        j = int(np.argmin(np.hypot(data['X_IMAGE'] - 1 - tx,
                                   data['Y_IMAGE'] - 1 - ty)))
        check(data['RB'][j] != -99 and st['scored'] == int(
            (data['RB'] != -99).sum()),
            f'pair (ml=True): the transient row {data[j]} was not scored')
        print(f'pair (ml=True, gather warp): {secs * 1e3:.0f} ms per pair; '
              f'filter {st["filter_s"]:.3f} s (its ML step {st["ml_s"]:.3f} '
              f's, {st["scored"]} candidates scored, '
              f'{int((data["GOODCUT"] == 1).sum())} kept) against '
              f'{results["gather"][3]:.3f} s at ml=False in this call and '
              f'{HOST_FILTER_S} s when the frames branch ran on the host '
              f'(PERF.md), host clock, on {name}; H14 '
              f'{ml_launches["negpix_veto"]}, H12 '
              f'{ml_launches["triplet_cut"]}, H13 '
              f'{ml_launches["braai_conv3x3"]} launches; transient RB '
              f'{float(data["RB"][j]):.4f}; card scores within {err:.3g} of '
              f'the plain layers', flush=True)

        # H14 at SCORE_N candidates on that pair's difference image, with
        # the medians (two sorts) on the card
        diff_t = torch.as_tensor(np.ascontiguousarray(scored.data, 'f4'),
                                 device=dev)
        med = cutouts.frame_median_exact(diff_t)
        sig = 1.48 * cutouts.frame_median_exact((diff_t - med).abs())
        x0, y0 = scoring_positions(H, W, SCORE_N, cutouts.NEGPIX_BOX)
        kv = launch.negpix_veto(diff_t, med, sig, x0, y0)
        check(torch.equal(kv, cutouts.negpix_veto_plain(diff_t, med, sig, x0,
                                                        y0)),
              'negpix_veto differs from its plain version')
        ms = graph_ms(lambda: launch.negpix_veto(diff_t, med, sig, x0, y0))
        call_ms = cuda_ms(lambda: launch.negpix_veto(diff_t, med, sig, x0,
                                                     y0))
        plain = cuda_ms(lambda: cutouts.negpix_veto_plain(diff_t, med, sig,
                                                          x0, y0), 1, 3)
        med_ms = cuda_ms(lambda: 1.48 * cutouts.frame_median_exact(
            (diff_t - cutouts.frame_median_exact(diff_t)).abs()), 1, 3)
        # the distinct corners' windows, a row's corner and verdict
        nd, bnd = negpix_bound(x0, y0)
        print(f'negpix_veto: {SCORE_N} candidates ({nd} distinct corners) '
              f'on {H}x{W}: bit-equal, {ms:.5f} ms on the card (graph '
              f'replay; bound {bnd[0]:.6f} ms by {bnd[1]}, share '
              f'{bnd[0] / ms:.1%}), {call_ms:.4f} ms per wrapper call with '
              f'its host cost, plain {plain:.3f} ms; the two median sorts '
              f'before it {med_ms:.3f} ms; {int(kv.sum())} vetoed',
              flush=True)

        # ---- the rotated pair's product and tensors ------------------------
        product, pair_launches, line = results['gather'][:3]
        sci = ScienceImage.from_file(line.split()[0])
        ref = ReferenceImage.from_file(line.split()[1])
        aligned = ref.aligned_to(sci)
        aligned_rms = ref.rms_image.aligned_to(sci)
        mask = product.mask_image.data
        diff = product.data
        check(np.array_equal((mask >> 16 & 1) == 1, aligned.coverage == 0)
              and 0 < int((aligned.coverage == 0).sum()) < 0.05 * mask.size,
              'pair: bit 16 is not exactly where the aligned reference has '
              'no coverage')
        check(np.array_equal((mask >> 17 & 1) == 1,
                             diff == np.float32(SUB_NODATA_SENTINEL)),
              'pair: bit 17 is not exactly where diff is the sentinel')
        inner = diff[64:-64, 64:-64]
        sig = 1.4826 * np.median(np.abs(inner - np.median(inner)))
        check(np.isfinite(diff).all() and sig < 12.5,
              f'pair: residual sigma {sig:.2f}')
        print(f'pair: bit 16 exactly on the {int((aligned.coverage == 0).sum())}'
              f' pixels the aligned reference does not cover, bit 17 exactly '
              f'on the sentinel; residual sigma {sig:.2f} counts',
              flush=True)

        # H10 on the pair's reference and mapping, with a seeded 18-bit mask
        grid = ref.mapping_to(sci)
        u, v = resample.upsample_mapping(
            torch.as_tensor(np.asarray(grid.u, 'f4'), device=dev),
            torch.as_tensor(np.asarray(grid.v, 'f4'), device=dev),
            grid.shape, grid.step)
        img = torch.as_tensor(np.ascontiguousarray(ref.data, 'f4'),
                              device=dev)
        rms_src = torch.as_tensor(np.ascontiguousarray(ref.rms_image.data,
                                                       'f4'), device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        rmask = torch.where(
            torch.rand((H, W), generator=gen, device=dev) < 0.01,
            torch.randint(0, 1 << 18, (H, W), generator=gen, device=dev,
                          dtype=torch.int32), 0).to(torch.int32)
        k = launch.warp_gather(img, rmask, u, v, img2=rms_src)
        (pa, pb), pm, pc = resample._gather_plain([img, rms_src], rmask, u, v)
        err = close('warp_gather pixels', k[0], pa, 3e-5, 5e-3)
        close('warp_gather second plane', k[1], pb, 3e-5, 5e-3)
        check(torch.equal(k[2], pm) and torch.equal(k[3], pc),
              'warp_gather: mask or coverage differs from the plain version')
        one = launch.warp_gather(img, rmask, u, v)
        check(torch.equal(one[0], k[0]) and torch.equal(one[2], k[2])
              and torch.equal(one[3], k[3]),
              'warp_gather: its first plane differs from the one-plane launch')
        check(np.array_equal(one[3].cpu().numpy(), aligned.coverage)
              and np.array_equal(one[0].cpu().numpy(), aligned.data),
              'pair: the aligned reference is not H10 of the reference')
        check(all(torch.equal(a, b) for a, b in zip(
            k, launch.warp_gather(img, rmask, u, v, img2=rms_src))),
              'warp_gather: two calls differ')
        (q64, s64), _, _ = resample._gather_plain(
            [img.double(), rms_src.double()], None, u.double(), v.double())
        e64 = warp_f64('warp_gather pixels', k[0], pa, q64, pc > 0)
        r64 = warp_f64('warp_gather second plane', k[1], pb, s64, pc > 0)
        del q64, s64
        ms = graph_ms(lambda: launch.warp_gather(img, rmask, u, v))
        call = cuda_ms(lambda: launch.warp_gather(img, rmask, u, v))
        two_ms = graph_ms(lambda: launch.warp_gather(img, rmask, u, v,
                                                     img2=rms_src))
        plain = cuda_ms(lambda: resample._gather_plain([img], rmask, u, v),
                        1, 2)
        bnd = warp_bound(H * W, 1)
        bnd2 = warp_bound(H * W, 2)
        print(f'warp_gather: {H}x{W}, rotation {PAIR_ROT} deg: {ms:.4f} ms '
              f'on the card (graph replay; {call:.4f} ms per wrapper call '
              f'with its host cost; bound {bnd[0]:.4f} ms by {bnd[1]}, share '
              f'{bnd[0] / ms:.1%}); with a second plane {two_ms:.4f} ms '
              f'(bound {bnd2[0]:.4f} ms, share {bnd2[0] / two_ms:.1%}); '
              f'plain {plain:.3f} ms; against the float64 plain version: '
              f'pixels {e64[0]:.4g} (f32 plain {e64[1]:.4g}), second plane '
              f'{r64[0]:.4g} ({r64[1]:.4g}); no PyTorch call warps with a '
              f'Lanczos kernel (grid_sample is bilinear or bicubic)',
              flush=True)
        record('warp_gather', err, ms, plain, bnd, runs=pair_launches,
               per='pair')

        # H3 at one term: the aligned reference rms through the squared
        # centre kernels of a fit of the pair's shape (K from the SEEING,
        # the guard's order and regions), seeded coefficients
        seeing = float(product.header['SEEING'])
        ksize = max(9, min(int(2 * round(2.5 * seeing / 2) + 1), 31))
        order, nreg = product.header['SUBKO'], product.header['SUBNRX']
        basis = inputs.KernelBasis(ksize, seeing_sigma=seeing / 2.355)
        tables = [torch.as_tensor(a, device=dev)
                  for a in (basis.gx, basis.gy, basis.sums, basis.b0_2d)]
        nm = len(subtract.spatial_terms(order))
        rng = np.random.default_rng(11)
        c = rng.normal(0, 0.01, (nreg * nreg, basis.nbasis * nm + 1))
        c[:, 0] += 1.0
        coeffs = torch.as_tensor(c, dtype=torch.float32, device=dev)
        ref_rms = torch.as_tensor(aligned_rms.data, device=dev)
        kerns = subtract.center_kernels(coeffs, *tables, order=order,
                                        nreg=nreg)
        kv = subtract.propagate_ref_var(ref_rms, coeffs, *tables, order=order,
                                        nreg=nreg)
        pv = subtract.propagate_ref_var_plain(ref_rms, kerns)
        scale = float(pv.abs().max())
        err = close('apply_model_variance', kv, pv, 1e-4, 1e-3 * scale)
        check(torch.equal(kv, subtract.propagate_ref_var(
            ref_rms, coeffs, *tables, order=order, nreg=nreg)),
              'apply_model_variance: two calls differ')
        var = (ref_rms ** 2).contiguous()
        k2 = (kerns ** 2).contiguous()
        cx, cy, _, _, wx, wy = subtract.model_geometry(H, W, order=0,
                                                       nreg=nreg)
        # the tensor-core GEMM of two or more terms, fed a zero second
        # term: the one-term launch as it ran before the direct kernel
        k2z = torch.stack([k2, torch.zeros_like(k2)], 1).contiguous()
        zero_bg = torch.zeros(nreg * nreg, device=dev)

        def gemm_var():
            return launch.apply_model(var, k2z, zero_bg, cx, cy, (0, 1),
                                      (0, 0), wx, wy)
        v64 = subtract.propagate_ref_var_plain(ref_rms.double(),
                                               kerns.double())
        e64 = [float((t.double() - v64).abs().max())
               for t in (kv, pv, gemm_var())]
        del v64
        ms = graph_ms(lambda: launch.apply_model_variance(var, k2, cx, cy,
                                                          wx, wy))
        call = cuda_ms(lambda: launch.apply_model_variance(var, k2, cx, cy,
                                                           wx, wy))
        gemm_ms = cuda_ms(gemm_var)
        plain = cuda_ms(lambda: subtract.propagate_ref_var_plain(ref_rms,
                                                                 kerns), 1, 3)
        conv_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
            var[None, None], k2[:1, None], padding=ksize // 2), 1, 3)
        # reads the variance, writes the propagated frame (8 B/px) and the
        # region kernels; 2 K^2 fp32 operations per pixel (the GEMM's three
        # TF32 products of the same work printed beside)
        bnd = bound(8 * H * W + 4 * k2.numel(), 2 * ksize * ksize * H * W)
        tf32 = 3 * 2 * ksize * ksize * H * W / TF32_FLOP_S * 1e3
        print(f'apply_model_variance: {H}x{W}, K={ksize}, {nreg}x{nreg} '
              f'regions, one term (direct fp32): {ms:.4f} ms (graph replay; '
              f'{call:.4f} ms per wrapper call; bound {bnd[0]:.4f} ms by '
              f'{bnd[1]}, share {bnd[0] / ms:.1%}; the same work as three '
              f'TF32 products {tf32:.4f} ms), the GEMM with a zero second '
              f'term {gemm_ms:.4f} ms, plain {plain:.3f} ms (one conv2d per '
              f'region); one conv2d of the frame with one kernel (for scale; '
              f'the regions\' kernels differ) {conv_ms:.3f} ms; max abs err '
              f'{err:.3g} on a variance of up to {scale:.3g}; against the '
              f'float64 plain version (not gated): kernel {e64[0]:.4g}, f32 '
              f'plain {e64[1]:.4g}, the GEMM {e64[2]:.4g}', flush=True)
        record('apply_model_variance', err, ms, plain, bnd,
               runs=pair_launches, per='pair')

        # H11 on the pair's own frames
        scimbkg = torch.as_tensor(
            np.ascontiguousarray(sci.background_subtracted_image.data, 'f4')
            + np.float32(BKG_VAL), device=dev)
        sci_rms = torch.as_tensor(np.ascontiguousarray(sci.rms_image.data,
                                                       'f4'), device=dev)
        refw = torch.as_tensor(aligned.data, device=dev)
        model = subtract.apply_kernel_fast(refw, coeffs, *tables, order=order,
                                           nreg=nreg)

        # H3 at one term: the pair's order-0 model on its aligned reference
        check(nm == 1, f'pair: the fit is of order {order}, not 0: H3 ran '
              f'{nm} terms')
        pm = subtract.apply_kernel(refw, coeffs, *tables, order=order,
                                   nreg=nreg)
        err = close('apply_model one term', model, pm, 1e-4, 1e-3)
        check(torch.equal(model, subtract.apply_kernel_fast(
            refw, coeffs, *tables, order=order, nreg=nreg)),
              'apply_model one term: two calls differ')
        kd1 = subtract.model_kernels(coeffs, *tables, order=order, nreg=nreg)
        bg1 = coeffs[:, -1].contiguous()
        geom1 = subtract.model_geometry(H, W, order=order, nreg=nreg)
        kd1z = torch.cat([kd1, torch.zeros_like(kd1)], 1).contiguous()

        def gemm_model():
            return launch.apply_model(refw, kd1z, bg1, *geom1[:2], (0, 1),
                                      (0, 0), *geom1[4:])
        m64 = subtract.apply_kernel(refw.double(), coeffs.double(),
                                    *(t.double() for t in tables),
                                    order=order, nreg=nreg)
        e64 = [float((t.double() - m64).abs().max())
               for t in (model, pm, gemm_model())]
        del m64
        ms = graph_ms(lambda: launch.apply_model(refw, kd1, bg1, *geom1))
        call = cuda_ms(lambda: launch.apply_model(refw, kd1, bg1, *geom1))
        gemm_ms = cuda_ms(gemm_model)
        plain = cuda_ms(lambda: subtract.apply_kernel(
            refw, coeffs, *tables, order=order, nreg=nreg), 1, 3)
        bnd = bound(8 * H * W + 4 * kd1.numel() + 4 * bg1.numel(),
                    2 * ksize * ksize * H * W)
        print(f'apply_model one term: {H}x{W}, K={ksize}, {nreg}x{nreg} '
              f'regions, order {order}: {ms:.4f} ms (graph replay; '
              f'{call:.4f} ms per wrapper call; bound {bnd[0]:.4f} ms by '
              f'{bnd[1]}, share {bnd[0] / ms:.1%}), the GEMM with a zero '
              f'second term {gemm_ms:.4f} ms, plain {plain:.3f} ms; max abs '
              f'err {err:.3g}; against the float64 plain version (not '
              f'gated): kernel {e64[0]:.4g}, f32 plain {e64[1]:.4g}, the '
              f'GEMM {e64[2]:.4g}', flush=True)
        record('apply_model_one_term', err, ms, plain, bnd,
               runs={'apply_model_one_term': pair_launches['apply_model']},
               per='pair')
        tmask = torch.as_tensor(mask & ~(1 << 17), device=dev)
        bad = (tmask & BAD_SUM) > 0
        errs = []
        for contract in (False, True):
            kk = subtract.subtract_epilogue(scimbkg, model, sci_rms, kv, bad,
                                            tmask, contract=contract)
            pp = subtract.subtract_epilogue_plain(scimbkg, model, sci_rms, kv,
                                                  bad, tmask,
                                                  contract=contract)
            for a, b, what in zip(kk, pp, ('diff', 'rms', 'submask')):
                check(torch.equal(a, b), f'subtract_epilogue {what} differs '
                      f'from the plain version at {int((a != b).sum())} '
                      f'pixels (contract={contract})')
            errs.append(kk[1])
        check(not torch.equal(*errs), 'subtract_epilogue: the two rounding '
              'modes give one rms')
        check(np.array_equal(kk[2].cpu().numpy(), mask),
              'pair: the product\'s mask is not H11\'s')
        ms = cuda_ms(lambda: subtract.subtract_epilogue(scimbkg, model,
                                                        sci_rms, kv, bad))
        sub_ms = cuda_ms(lambda: subtract.subtract_epilogue(
            scimbkg, model, sci_rms, kv, bad, tmask, contract=True))
        plain = cuda_ms(lambda: subtract.subtract_epilogue_plain(
            scimbkg, model, sci_rms, kv, bad), 1, 3)
        # reads four frames and the bad map (17 B/px), writes two (8 B/px);
        # ~6 operations per pixel; a submask adds 8 B/px
        bnd = bound(25 * H * W, 6 * H * W)
        bnd_s = bound(33 * H * W, 8 * H * W)
        print(f'subtract_epilogue: {H}x{W}: bit-equal in both rounding '
              f'modes; {ms:.4f} ms (bound {bnd[0]:.4f} ms, share '
              f'{bnd[0] / ms:.1%}), with a submask {sub_ms:.4f} ms (bound '
              f'{bnd_s[0]:.4f} ms, share {bnd_s[0] / sub_ms:.1%}), plain '
              f'{plain:.3f} ms', flush=True)
        record('subtract_epilogue', 0.0, ms, plain, bnd, runs=pair_launches,
               per='pair')

    # ---- a small rotated pair on the card and on the CPU -------------------
    with tempfile.TemporaryDirectory(prefix='chip_smoke_pair_') as d:
        outs = {}
        for where in ('cuda', 'cpu'):
            dd = os.path.join(d, where)
            os.mkdir(dd)
            work, _ = inputs.write_night_pairs(
                dd, 1, 256, 256, ref_rot_deg=(PAIR_ROT,), nstars=30,
                header_json=header_json)
            sci = ScienceImage.from_file(work[0].split()[0])
            ref = ReferenceImage.from_file(work[0].split()[1])
            small = SingleEpochSubtraction.from_images(sci, ref, device=where)
            outs[where] = (small, ref.aligned_to(sci, device=where))
        (a, ra), (b, rb) = outs['cuda'], outs['cpu']
        check(np.array_equal(a.mask_image.data, b.mask_image.data)
              and np.array_equal(ra.coverage, rb.coverage),
              'small pair: mask or coverage differs between card and CPU')
        err = close('small pair aligned reference', torch.as_tensor(ra.data),
                    torch.as_tensor(rb.data), 3e-5, 5e-3)
        check(all(a.header[k_] == b.header[k_]
                  for k_ in ('SUBKO', 'SUBNRX', 'SUBMETH', 'SEEING')),
              'small pair: header cards differ between card and CPU')
        ok = a.mask_image.data == 0
        far = float((np.abs(a.data - b.data)[ok] > 0.05).mean())
        print(f'small pair (256x256, reference rotated by {PAIR_ROT} deg): '
              f'card and CPU agree on the submask and the coverage; aligned '
              f'reference max abs diff {err:.3g}; {far:.2e} of the unmasked '
              f'diff pixels past 0.05 counts (the fit moves at the ulp)',
              flush=True)
    return pair_s


def phot_phase(wrappers, name, db_fluxes):
    """Forced photometry on a flagship subtraction: one pair of the
    night's scene through ``sub.do_one`` (ml=False), the product read back
    by ``ScienceImage.from_file``, PHOT_N seeded positions on it
    (``inputs.forced_positions``: the transient, the catalogue stars,
    blank sky, edge and off-frame rows, rows on masked pixels). Counted:
    dophot's call ``aperture_photometry(sub, ra, dec,
    apply_calibration=True, assume_background_subtracted=True)`` (one H22
    launch); ``raw_aperture_photometry`` on the three product files; the
    call again on the frame alone (``load_others=False``), where the
    background mesh (H2) runs first. Checked: the transient's forced flux,
    the off-frame rows NaN and bad, the masked rows flagged (raw: the mask
    file), H22 against its plain version at these positions, and each
    of the db phase's transient fluxes ``db_fluxes`` (frame -> flux from
    ``phot.main``) within PHOT_FLUX_TOL of this phase's dophot value;
    printed: the blank-sky pulls' robust sigma and the host seconds per
    call."""
    import numpy as np
    import torch
    from zuds_tpu_torch import inputs, night, sub as zsub
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.kernels.checks import aperture_check
    from zuds_tpu_torch.mask import MaskImageBase
    from zuds_tpu_torch.photometry import (aperture_photometry,
                                           raw_aperture_photometry)
    cfg = night.FLAGSHIP
    H, W = cfg.height, cfg.width
    sig = inputs.NIGHT_SEEING[1] / 2.3548
    want = inputs.NIGHT_TRANSIENT_FLUX * (1 - math.exp(-9.0 / (2 * sig ** 2)))
    with tempfile.TemporaryDirectory(prefix='chip_smoke_phot_') as d:
        work, truths = inputs.write_night_pairs(
            d, 1, H, W, header_json=Path(__file__).resolve().parent
            / 'tests' / 'data' / 'ztf_real_header.json')
        product, _ = zsub.do_one(work[0], ml=False)
        path = product.local_path
        mask_path = product.mask_image.local_path
        rms_path = path.replace('.fits', '.rms.fits')
        mask = MaskImageBase.from_file(mask_path).data
        img = ScienceImage.from_file(path)
        ra, dec, kind = inputs.forced_positions(
            img.wcs, H, W, PHOT_N, truths[0], inputs.night_stars(H, W),
            mask=mask, seed=13)
        print(f'phot: flagship subtraction {os.path.basename(path)}, '
              f'{PHOT_N} positions: ' + ', '.join(
                  f'{int((kind == k).sum())} {k}'
                  for k in inputs.FORCED_KINDS), flush=True)

        def counted(fn):
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return (res, time.perf_counter() - t0,
                    {k: w.launches for k, w in wrappers.items() if w.launches})

        runs = {
            'dophot': counted(lambda: aperture_photometry(
                img, ra, dec, apply_calibration=True,
                assume_background_subtracted=True)),
            'raw': counted(lambda: raw_aperture_photometry(
                path, rms_path, mask_path, ra, dec, apply_calibration=True)),
            'mesh': counted(lambda: aperture_photometry(
                ScienceImage.from_file(path, load_others=False), ra, dec,
                apply_calibration=True)),
        }
        sky, off = kind == 'sky', kind == 'off'
        for tag, (res, secs, used) in runs.items():
            h2 = 1 if tag == 'mesh' else 0
            check(used == {'aperture_photometry': 1,
                           **({'background_cells': 1} if h2 else {})},
                  f'phot ({tag}): launches {used}')
            got = float(res['flux'][0])
            check(abs(got - want) <= PHOT_FLUX_TOL * want,
                  f'phot ({tag}): the transient\'s forced flux {got:.1f} '
                  f'is not within {PHOT_FLUX_TOL:.0%} of {want:.1f}')
            check(bool(np.isnan(res['flux'][off]).all()
                       and np.isnan(res['fluxerr'][off]).all()
                       and res['bad'][off].all()),
                  f'phot ({tag}): off-frame rows not NaN and bad')
            pull = res['flux'][sky] / res['fluxerr'][sky]
            rsig = 1.4826 * float(np.median(np.abs(pull - np.median(pull))))
            print(f'phot ({tag}): {secs * 1e3:.1f} ms for {PHOT_N} positions '
                  f'(host clock, to synchronize) on {name}; transient '
                  f'{got:.1f} against {want:.1f} planted in r = 3 px '
                  f'({got / want:.4f}); zp {res["zp"]}; '
                  f'{int(res["bad"].sum())} bad; blank-sky pulls median '
                  f'{float(np.median(pull)):.3f}, robust sigma {rsig:.3f} '
                  f'(no gate); launches {used}', flush=True)
        ref_flux = float(runs['dophot'][0]['flux'][0])
        check(set(db_fluxes) == set(range(NIGHT_PAIRS + 1)) - {NO_SEEING}
              and all(abs(f - ref_flux) <= PHOT_FLUX_TOL * ref_flux
                      for f in db_fluxes.values()),
              f'db phot: transients\' forced flux {db_fluxes} not within '
              f'{PHOT_FLUX_TOL:.0%} of the phot phase\'s {ref_flux:.1f}')
        print(f'db: transients\' forced flux from phot.main '
              f'{ {i: round(f, 1) for i, f in db_fluxes.items()} }, each '
              f'within {PHOT_FLUX_TOL:.0%} of the phot phase\'s '
              f'{ref_flux:.1f}', flush=True)
        raw = runs['raw'][0]
        check(bool((raw['flags'][kind == 'masked'] != 0).all()),
              'phot (raw): a row on a masked pixel is not flagged')

        # H22 against its plain version at these positions, on the
        # product's own tensors
        dev = torch.device('cuda')
        x, y = (torch.as_tensor(np.asarray(v, 'f4'), device=dev)
                for v in img.wcs.sky2pix_0(ra, dec))
        t = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
             for k, v in (('img', np.asarray(img.data, 'f4')),
                          ('rms', np.asarray(img.rms_image.data, 'f4')),
                          ('mask', np.asarray(mask).astype(np.int32)))}
        err = aperture_check(t['img'], t['rms'], t['mask'], x, y, 3.0,
                             'phot')
        k = launch.aperture_photometry(t['img'], t['rms'], t['mask'], x, y,
                                       3.0, 9)
        digest = hashlib.sha256(b''.join(
            k[key].contiguous().cpu().numpy().tobytes()
            for key in ('flux', 'fluxerr', 'area', 'flags', 'oob')))
        print(f'phot: H22 at the {PHOT_N} positions: flags, oob and '
              f'overlaps bit-equal to the plain version, flux within its '
              f'order bound (max abs err {err:.3g}); outputs sha256 '
              f'{digest.hexdigest()}', flush=True)
        if os.environ.get('ZUDS_PHOT_INPUTS'):
            # the frames and positions, for bench_detect.py --phot
            torch.save({**{key: v.cpu() for key, v in t.items()},
                        'x': x.cpu(), 'y': y.cpu()},
                       os.environ['ZUDS_PHOT_INPUTS'])


def alert_phase(wrappers, name):
    """The alert chain and the control plane that feeds it, from FITS
    pairs to spooled, read-back alert packets (see the module's
    docstring). (a) ``controller.run_once`` starts the ``nightly`` worker
    on the card over the registered pairs: one ``sesub`` record a pair
    with the records' target and reference ids, no ``FailedSubtraction``,
    the detections the catalogs' GOODCUT rows, each transient among them,
    the kernel library loaded and not rebuilt. (b) On copies, in a second
    database: ``sub.do_one`` (ml=False, counted), a known source and one
    PS1 and one DR8 row 1 arcsec from each transient, ``associate``
    (stage 1 matches each transient and nothing else), ``phot_controller``
    (its ``phot`` worker on the card; ``alert_ready`` on the transients
    alone), ``makealert.main`` and ``doalert.main`` (one thin alert a
    ready detection: no cutouts, the crossmatch blocks; each spooled file
    the bytes of ``alert_to_record``), then the full alerts of the
    detections with their subtraction attached: 123 candidate fields, the
    ps/ls blocks equal to the local rows, the three cutouts the 63x63
    cuts of their frames on the frames' WCS, the light curve's flux on
    the transient's own subtraction within PHOT_FLUX_TOL of the planted
    flux in r = 3 px, the spooled file the bytes of ``alert_to_record``.
    Prints the host seconds of each step."""
    import contextlib
    import glob
    import gzip
    import io
    import shutil
    import numpy as np
    import torch
    from zuds_tpu_torch import core, doalert, inputs, makealert, night
    from zuds_tpu_torch import send, sub as zsub
    from zuds_tpu_torch.alert import Alert
    from zuds_tpu_torch.avro import read_avro, write_avro
    from zuds_tpu_torch.bookkeeping import FailedSubtraction, ForcePhotJob
    from zuds_tpu_torch.catalog import PipelineFITSCatalog
    from zuds_tpu_torch.control import controller, makesources
    from zuds_tpu_torch.control import phot_controller
    from zuds_tpu_torch.crossmatch import abmag
    from zuds_tpu_torch.detections import Detection
    from zuds_tpu_torch.external import DR8North, PS1
    from zuds_tpu_torch.fits import read_fits
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.kernels import build
    from zuds_tpu_torch.source import ForcedPhotometryRecord, Source
    from zuds_tpu_torch.spatial import angular_distance
    from zuds_tpu_torch.subtraction import sub_name
    from zuds_tpu_torch.thumbnails import make_stamp
    cfg = night.FLAGSHIP
    H, W = cfg.height, cfg.width
    sig = inputs.NIGHT_SEEING[1] / 2.3548
    want = inputs.NIGHT_TRANSIENT_FLUX * (1 - math.exp(-9.0 / (2 * sig ** 2)))
    secs = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[key] = secs.get(key, 0.0) + time.perf_counter() - t0
        return out

    def register(sess, lines):
        # read as science images, so that the reference's record has its
        # quadrant (ReferenceImage.from_file reads no FIELDID/CCDID/...)
        ids = {}
        for line in lines:
            for path, kind in zip(line.split(), ('sci', 'ref')):
                if path not in ids:
                    rec = core.record_from_image(
                        ScienceImage.from_file(path), kind)
                    sess.add(rec)
                    sess.commit()
                    ids[path] = rec.id
        return ids

    def transient(sess, line, i, d):
        """The sesub record of ``line`` and its detection nearest pair
        ``i``'s transient (checked within 2 px), with all its detections
        and the catalog's GOODCUT rows."""
        sci, ref = line.split()
        base = os.path.basename(sub_name(sci, ref))
        recs = sess.query(core.ZTFFile).filter_by(basename=base).all()
        check(len(recs) == 1 and recs[0].type == 'sesub',
              f'alert: pair {i}: records {recs}')
        dets = sess.query(Detection).filter_by(image_id=recs[0].id) \
            .order_by('id').all()
        cat = PipelineFITSCatalog.from_file(
            os.path.join(d, base.replace('.fits', '.cat'))).data
        good = cat[cat['GOODCUT'] == 1]
        tx, ty = truths[i]
        check(len(dets) == len(good) >= 1, f'alert: pair {i}: '
              f'{len(dets)} detections, {len(good)} GOODCUT rows')
        near = min(dets, key=lambda x: math.hypot(x.x_image - 1 - tx,
                                                  x.y_image - 1 - ty))
        dist = math.hypot(near.x_image - 1 - tx, near.y_image - 1 - ty)
        check(dist < 2.0, f'alert: pair {i}: transient {dist:.2f} px from '
              f'its nearest detection')
        return recs[0], near, dets

    def spooled(spool, candid):
        paths = glob.glob(os.path.join(spool, 'alerts', '*',
                                       f'{candid}.avro'))
        check(len(paths) == 1, f'alert: spool files of {candid}: {paths}')
        return paths[0]

    def same_bytes(path, alert):
        record, schema = send.alert_to_record(alert)
        buf = io.BytesIO()
        write_avro(buf, schema, [record])
        with open(path, 'rb') as f:
            raw = f.read()
        check(raw == buf.getvalue(), f'alert: {path} is not the bytes of '
              f'alert_to_record')
        return read_avro(io.BytesIO(raw))[1]

    with tempfile.TemporaryDirectory(prefix='chip_smoke_alert_') as d:
        da, dbd = os.path.join(d, 'a'), os.path.join(d, 'b')
        os.makedirs(da)
        work, truths = timed('write', lambda: inputs.write_night_pairs(
            da, ALERT_PAIRS, H, W, header_json=Path(__file__).resolve()
            .parent / 'tests' / 'data' / 'ztf_real_header.json'))
        # fresh copies for (b): a pair's products are cached beside it
        shutil.copytree(da, dbd)
        work_b = [' '.join(os.path.join(dbd, os.path.basename(p))
                           for p in line.split()) for line in work]
        so = build.library_path()
        so_state = (so.stat().st_mtime_ns, sorted(os.listdir(so.parent
                                                             .parent)))

        # ---- (a) the controller's nightly worker on the card -------------
        with bound_db(da, 'control', config=True) as dba:
            sess = core.DBSession()
            ids = timed('a_records', lambda: register(sess, work))
            pairs = controller.unprocessed_pairs(sess)
            check(sorted(pairs) == sorted(tuple(map(os.path.basename,
                                                    line.split()))
                                          for line in work),
                  f'alert: unprocessed pairs {pairs}')
            launcher = controller.LocalLauncher()
            with contextlib.chdir(da):
                jobs = timed('a_submit', lambda: controller.run_once(
                    sess, launcher, dba.d))
            check(len(jobs) == 1, f'alert: {len(jobs)} jobs submitted')
            proc = launcher.procs[jobs[0].slurm_id]
            try:
                rc = timed('a_worker', lambda: proc.wait(ALERT_WAIT_S))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = None
            check(rc == 0, f'alert: the nightly worker ended with {rc}')
            status = [j.status for j in controller.refresh_job_status(
                sess, launcher)]
            check(status == ['done'], f'alert: job status {status}')
            check(sess.query(FailedSubtraction).count() == 0,
                  'alert: the nightly worker recorded a FailedSubtraction')
            nd = []
            for i, line in enumerate(work):
                rec, near, dets = transient(sess, line, i, da)
                sci, ref = line.split()
                check((rec.target_id, rec.reference_id)
                      == (ids[sci], ids[ref]),
                      f'alert: pair {i}: target/reference ids '
                      f'{(rec.target_id, rec.reference_id)}')
                nd.append(len(dets))
            check(controller.unprocessed_pairs(sess) == [],
                  'alert: pairs left unprocessed after the worker')
        check((so.stat().st_mtime_ns, sorted(os.listdir(so.parent.parent)))
              == so_state, 'alert: a worker rebuilt the kernel library')
        print(f'alert (a): controller.run_once over {len(work)} registered '
              f'pairs, one nightly worker on the card (ml=True) in '
              f'{secs["a_worker"]:.2f} s: exit 0, job done, one sesub '
              f'record a pair with its target and reference ids, '
              f'detections {nd} = the GOODCUT rows, each transient a '
              f'detection, no FailedSubtraction, the kernel library '
              f'loaded, not rebuilt; host s records '
              f'{secs["a_records"]:.3f}, submit {secs["a_submit"]:.3f} on '
              f'{name}', flush=True)

        # ---- (b) the alert chain -----------------------------------------
        with bound_db(dbd, 'alerts', config=True) as dbb:
            sess = core.DBSession()
            ids_b = timed('b_records', lambda: register(sess, work_b))
            for w in wrappers.values():
                w.launches = 0
            subs = {}
            for i, line in enumerate(work_b):
                subs[i] = timed('b_do_one', lambda: zsub.do_one(
                    line, ml=False))[0]
            torch.cuda.synchronize()
            used = counts_of(wrappers)
            check(used.get('apply_model', 0) >= ALERT_PAIRS,
                  f'alert: sub.do_one launched {used}')
            tdets, recs = {}, {}
            for i, line in enumerate(work_b):
                recs[i], near, _ = transient(sess, line, i, dbd)
                tdets[i] = near.id
                check((recs[i].target_id, recs[i].reference_id)
                      == tuple(ids_b[p] for p in line.split()),
                      f'alert: pair {i}: the per-pair chain\'s ids')
            rng = np.random.default_rng(27)
            wcs = ScienceImage.from_file(work_b[0].split()[0]).wcs
            local = {}
            for i in range(ALERT_PAIRS):
                ra, dec = (float(v) for v in wcs.pix2sky_0(*truths[i]))
                ps = PS1(objid=int(rng.integers(10 ** 15, 10 ** 16)), ra=ra,
                         dec=dec + 1 / 3600, sgscore=float(rng.uniform()),
                         **{f'{b}mag': float(rng.uniform(15, 22))
                            for b in 'griz'})
                dr = DR8North(
                    objid=int(rng.integers(1, 10 ** 6)),
                    ra=ra + 1 / 3600 / math.cos(math.radians(dec)), dec=dec,
                    type='EXP', ebv=float(rng.uniform(0, 0.1)),
                    **{f'flux_{b}': float(rng.uniform(0.5, 50))
                       for b in ('g', 'r', 'z', 'w1', 'w2', 'w3', 'w4')},
                    gaia_phot_g_mean_mag=float(rng.uniform(15, 21)),
                    parallax=float(rng.uniform(0, 2)),
                    **{f'z_phot_{k}': float(rng.uniform(0, 1))
                       for k in ('mean', 'median', 'std', 'l68', 'u68',
                                 'l95', 'u95')},
                    z_spec=float(rng.uniform(0, 1)))
                sess.add_all([Source(id=f'ZUDS26chip{i:02d}', ra=ra,
                                     dec=dec, origin='chip_smoke'), ps, dr])
                local[i] = (f'ZUDS26chip{i:02d}', ps, dr)
            sess.commit()
            matched, new = timed('b_associate',
                                 lambda: makesources.associate(sess))
            linked = {x.id: (x.source_id, x.triggers_alert) for x in
                      sess.query(Detection).filter(
                          'source_id IS NOT NULL').all()}
            check((matched, new) == (ALERT_PAIRS, 0) and linked == {
                tdets[i]: (local[i][0], 1) for i in range(ALERT_PAIRS)},
                f'alert: associate matched {matched}, new {new}: {linked}')
            with contextlib.chdir(dbd):
                timed('b_phot', lambda: phot_controller.main(
                    workdir=os.path.join(dbb.d, 'phot'), once=True))
            sess = core.DBSession()
            pjobs = [j.status for j in sess.query(ForcePhotJob).all()]
            nfp = sess.query(ForcedPhotometryRecord).count()
            ready = sorted(x.id for x in sess.query(Detection).filter_by(
                alert_ready=1).all())
            check(pjobs == ['done'] and nfp == ALERT_PAIRS ** 2
                  and ready == sorted(tdets.values()),
                  f'alert: phot jobs {pjobs}, {nfp} forced rows, '
                  f'alert_ready {ready}')
            made = timed('b_makealert', makealert.main)
            sess = core.DBSession()
            thin = sess.query(Alert).order_by('id').all()
            check(made == len(thin) == ALERT_PAIRS
                  and sorted(a.detection_id for a in thin) == ready,
                  f'alert: makealert built {made} alerts: {thin}')
            worklist = os.path.join(dbb.d, 'alert_ids.txt')
            with open(worklist, 'w') as f:
                f.write(''.join(f'{i}\n' for i in ready))
            rc = timed('b_doalert',
                       lambda: doalert.main(['doalert', worklist]))
            sess = core.DBSession()
            sent = sess.query(Alert).filter_by(sent=1).order_by('id').all()
            check(rc == 0 and len(sent) == ALERT_PAIRS,
                  f'alert: doalert exit {rc}, {len(sent)} sent')
            for a in thin + sent:
                cand = a.payload['candidate']
                ps = local[[i for i in tdets if tdets[i]
                            == a.detection_id][0]][1]
                check(a.cutout_science is None and cand['pid'] == 0
                      and cand['objectidps1'] == ps.objid,
                      f'alert: the thin alert of {a.detection_id}: '
                      f'cutouts or crossmatch')
            for a in sent:
                same_bytes(spooled(dbb.spool, a.detection_id), a)

            # the full alerts: the detections with their subtraction
            full = []
            for i in range(ALERT_PAIRS):
                det = sess.query(Detection).get(tdets[i])
                det.image = subs[i]
                alert = timed('b_from_detection',
                              lambda: Alert.from_detection(det))
                timed('b_send', lambda: send.send_alert(alert))
                path = spooled(dbb.spool, det.id)
                got = timed('b_read', lambda: same_bytes(path, alert))
                check(len(got) == 1, f'alert: {path}: {len(got)} records')
                got = got[0]
                cand = got['candidate']
                sid, ps, dr = local[i]
                check(len(cand) == 123 and cand['alert_type'] == 'single'
                      and got['candid'] == det.id
                      and got['objectId'] == sid,
                      f'alert: pair {i}: the packet\'s envelope')

                def f32(v):
                    return None if v is None else float(np.float32(v))

                def sep(row):
                    return float(angular_distance(det.ra, det.dec, row.ra,
                                                  row.dec) * 3600.0)
                wants = {'objectidps1': ps.objid, 'sgscore1': f32(ps.sgscore),
                         'distpsnr1': f32(sep(ps)), 'psgmag1': f32(ps.gmag),
                         'psrmag1': f32(ps.rmag), 'psimag1': f32(ps.imag),
                         'pszmag1': f32(ps.zmag), 'objectidps2': None,
                         'lsobjectid1': dr.objid, 'lsdistnr1': f32(sep(dr)),
                         'lstype1': dr.type, 'lsebv1': f32(dr.ebv),
                         'lsgaiag1': f32(dr.gaia_phot_g_mean_mag),
                         'lsgaiap1': f32(dr.parallax),
                         'lszspec1': f32(dr.z_spec), 'lsobjectid2': None}
                wants.update({f'ls{b}1': f32(abmag(getattr(dr, f'flux_{b}')))
                              for b in 'grz'})
                wants.update({f'lsw{k}_1': f32(abmag(getattr(dr,
                                                           f'flux_w{k}')))
                              for k in '1234'})
                wants.update({f'lszphot{k}1': f32(getattr(dr,
                                                          f'z_phot_{k}'))
                              for k in ('mean', 'std', 'l68', 'u68', 'l95',
                                        'u95')})
                wants['lszphotmed1'] = f32(dr.z_phot_median)
                bad = {k: (cand[k], v) for k, v in wants.items()
                       if cand[k] != v}
                check(not bad, f'alert: pair {i}: crossmatch blocks {bad}')
                sci, ref = work_b[i].split()
                for key, path in (('Difference', subs[i].local_path),
                                  ('Science', sci), ('Template', ref)):
                    raw = got[f'cutout{key}']
                    check(raw is not None, f'alert: pair {i}: no {key} '
                          f'cutout')
                    stamp = read_fits(io.BytesIO(gzip.decompress(raw)))[0] \
                        .data
                    img = ScienceImage.from_file(path, load_others=False)
                    cut = make_stamp(None, det.ra, det.dec, None, None,
                                     np.asarray(img.data), img.wcs)
                    check(stamp.shape == (63, 63)
                          and np.array_equal(stamp, cut.astype('f4')),
                          f'alert: pair {i}: the {key} cutout is not the '
                          f'cut of its frame')
                lc = [p['flux'] for p in got['light_curve']]
                check(len(lc) == ALERT_PAIRS and None not in lc
                      and abs(max(lc) - want) <= PHOT_FLUX_TOL * want,
                      f'alert: pair {i}: light curve {lc}, planted '
                      f'{want:.1f}')
                full.append((det.id, cand, lc))
        for i, (candid, cand, lc) in enumerate(full):
            print(f'alert (b): pair {i}: candid {candid}, objectId '
                  f'{local[i][0]}, ra {cand["ra"]:.6f} dec '
                  f'{cand["dec"]:.6f}, jd {cand["jd"]}, snr '
                  f'{cand["snr"]:.1f}, ndethist_single '
                  f'{cand["ndethist_single"]}, distpsnr1 '
                  f'{cand["distpsnr1"]:.3f}", lsdistnr1 '
                  f'{cand["lsdistnr1"]:.3f}", light curve '
                  f'{[round(x, 1) for x in lc]} against {want:.1f} '
                  f'planted in r = 3 px', flush=True)
        steps = ', '.join(f'{k} {v:.3f}' for k, v in secs.items())
        print(f'alert (b): sub.do_one x{ALERT_PAIRS} (ml=False; launches '
              f'{used}), associate matched {ALERT_PAIRS}, phot_controller '
              f'(its phot worker on the card) {nfp} forced rows, makealert '
              f'{len(thin)} and doalert {len(sent)} thin alerts, '
              f'{len(full)} full alerts (123 fields, ps/ls blocks, three '
              f'cutouts, light curve) spooled and read back, each file the '
              f'bytes of alert_to_record; host seconds: {steps} on {name}',
              flush=True)
    return len(thin) + len(sent) + len(full)


def star_free(sci, ok, margin=64, box=25):
    """``ok`` less a ``box`` px square about every source of ``sci``'s
    catalog and a ``margin`` px border: the star-free sky of a frame."""
    import torch
    import torch.nn.functional as F
    data = sci.catalog.data
    H, W = ok.shape
    mark = torch.zeros((1, 1, H, W))
    xi = torch.as_tensor(data['X_IMAGE'] - 1.0).round().long().clamp(0, W - 1)
    yi = torch.as_tensor(data['Y_IMAGE'] - 1.0).round().long().clamp(0, H - 1)
    mark[0, 0, yi, xi] = 1.0
    near = F.max_pool2d(mark, box, 1, box // 2)[0, 0].numpy() > 0
    free = ok & ~near
    free[:margin], free[-margin:] = False, False
    free[:, :margin], free[:, -margin:] = False, False
    return free


def zogy_phase(wrappers, name, record, hotpants_s):
    """SingleEpochSubtraction.from_images(method='zogy') on the flagship
    pair whose reference is rotated by PAIR_ROT degrees (the gather warp
    H10) and on the unrotated pair (the planned warp H1): a warm-up, then
    load, from_images, sub.catalog and filter_sexcat(ml=False), counted and
    timed on fresh copies, beside the per-pair phase's hotpants pair
    (``hotpants_s``: tag -> (seconds, stats)); the rotated pair again at
    ml=True; the checks of the product; H15-H18 against their plain
    versions on the rotated pair's own tensors, with their records; the
    card's f32 against a float64 plain run on the card; a 256^2 pair on
    the card and on the CPU."""
    import shutil
    import numpy as np
    import torch
    from zuds_tpu_torch import inputs, night
    from zuds_tpu_torch.bench_detect import stamps_bound
    from zuds_tpu_torch.coadd import ReferenceImage
    from zuds_tpu_torch.constants import BAD_SUM, BKG_VAL, SUB_NODATA_SENTINEL
    from zuds_tpu_torch.filterobjects import filter_sexcat
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import zogy
    from zuds_tpu_torch.subtraction import (SingleEpochSubtraction,
                                            _select_stamps)
    H, W = night.FLAGSHIP.height, night.FLAGSHIP.width
    header_json = (Path(__file__).resolve().parent / 'tests' / 'data'
                   / 'ztf_real_header.json')
    dev = torch.device('cuda')
    with tempfile.TemporaryDirectory(prefix='chip_smoke_zogy_') as d:
        src = os.path.join(d, 'src')
        os.mkdir(src)
        t0 = time.perf_counter()
        work, truths = inputs.write_night_pairs(
            src, 2, H, W, ref_rot_deg=(0.0, PAIR_ROT),
            header_json=header_json)
        print(f'zogy: an unrotated pair and one rotated by {PAIR_ROT} deg '
              f'written in {time.perf_counter() - t0:.1f} s', flush=True)

        def run(tag, i, ml=False):
            """load, from_images(method='zogy'), catalog and filter on a
            fresh copy of pair ``i``, counted and timed."""
            dd = os.path.join(d, tag)
            shutil.copytree(src, dd)
            sci_path, ref_path = work[i].replace(src, dd).split()
            for w in wrappers.values():
                w.launches = 0
            st = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sci = ScienceImage.from_file(sci_path)
            ref = ReferenceImage.from_file(ref_path)
            sci.data, ref.data
            st['load_s'] = time.perf_counter() - t0
            sub = SingleEpochSubtraction.from_images(sci, ref, method='zogy',
                                                     stats=st)
            t1 = time.perf_counter()
            # the rms as assembled; the catalog replaces it with the sub's
            # own background mesh rms
            rms0 = sub.rms_image.data
            cat = sub.catalog
            t2 = time.perf_counter()
            filter_sexcat(cat, ml=ml, stats=st)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            st['catalog_s'], st['filter_s'] = t2 - t1, t3 - t2
            st['assembled_rms'] = float(np.median(
                rms0[sub.mask_image.data == 0]))
            return (sub, sci, ref, cat, st, t3 - t0,
                    {k: w.launches for k, w in wrappers.items()})

        warm_s = run('warm', 1)[5]
        print(f'zogy: warm-up pair {warm_s:.2f} s', flush=True)
        res = {}
        for tag, i in (('gather', 1), ('planned', 0)):
            sub, sci, ref, cat, st, secs, launches = run(tag, i)
            res[tag] = (sub, sci, ref, launches)
            hp_s, hp_st = hotpants_s[tag]
            print(f'zogy pair ({tag} warp): files -> filtered catalog '
                  f'{secs * 1e3:.0f} ms per pair against {hp_s * 1e3:.0f} ms '
                  f'for the hotpants do_one of the same scene in this call, '
                  f'host clock, on {name}', flush=True)
            keys = ('load_s', 'align_s', 'products_s', 'psf_s', 'zogy_s',
                    'assemble_s', 'catalog_s', 'filter_s')
            print(f'zogy pair ({tag} warp): host seconds: ' + ', '.join(
                f'{k[:-2]} {st[k]:.3f}' for k in keys) + '; hotpants: '
                + ', '.join(f'{k[:-2]} {hp_st[k]:.3f}' for k in (
                    'load_s', 'align_s', 'products_s', 'fit_s',
                    'subtract_s', 'assemble_s', 'catalog_s', 'filter_s')),
                flush=True)
            print(f'zogy pair ({tag} warp): kernel launches '
                  f'{ {k: n for k, n in launches.items() if n} }',
                  flush=True)
            gather = tag == 'gather'
            check(all(launches[k] == n for k, n in ZOGY_LAUNCHES.items())
                  and launches['warp_gather'] == (3 if gather else 0)
                  and launches['warp'] == (0 if gather else 3)
                  and launches['apply_model'] == 0
                  and launches['subtract_epilogue'] == 0,
                  f'zogy pair ({tag}): launches {launches}')
            check(sub.header['SUBMETH'] == 'zogy'
                  and sub.scorr_image.basename
                  == sub.basename.replace('.fits', '.scorr.fits'),
                  f'zogy pair ({tag}): SUBMETH or scorr basename')
            mask, diff = sub.mask_image.data, sub.data
            score = sub.scorr_image.data
            tx, ty = truths[i]
            peak = float(score[int(ty) - 2:int(ty) + 3,
                               int(tx) - 2:int(tx) + 3].max())
            check(peak > 10.0, f'zogy pair ({tag}): score peak {peak:.2f} '
                  f'at the transient ({tx:.1f}, {ty:.1f})')
            free = star_free(sci, mask == 0)
            sky = score[free]
            rsig = float(1.4826 * np.median(np.abs(sky - np.median(sky))))
            check(np.isfinite(score[mask == 0]).all()
                  and 0.85 < rsig < 1.15,
                  f'zogy pair ({tag}): robust sigma of s_corr on star-free '
                  f'sky {rsig:.4f}')
            aligned = ref.aligned_to(sci)
            nodata = aligned.coverage == 0
            check(np.array_equal((mask >> 16 & 1) == 1, nodata)
                  and 0 < int(nodata.sum()) < 0.05 * mask.size,
                  f'zogy pair ({tag}): bit 16 is not exactly where the '
                  'aligned reference has no coverage')
            check(np.array_equal((mask >> 17 & 1) == 1,
                                 diff == np.float32(SUB_NODATA_SENTINEL)),
                  f'zogy pair ({tag}): bit 17 is not exactly on the sentinel')
            dsky = diff[free]
            dsig = float(1.4826 * np.median(np.abs(dsky - np.median(dsky))))
            rows = cat.data
            dist = np.hypot(rows['X_IMAGE'] - 1 - tx, rows['Y_IMAGE'] - 1 - ty)
            near = len(dist) and dist.min() < 2.0
            good = int((rows['GOODCUT'] == 1).sum())
            print(f'zogy pair ({tag} warp): transient at ({tx:.0f}, {ty:.0f}) '
                  f'a score peak of {peak:.1f} sigma; s_corr robust sigma '
                  f'{rsig:.4f} on {int(free.sum())} star-free sky pixels; d '
                  f'robust sigma {dsig:.4f} counts against a median rms of '
                  f'{st["assembled_rms"]:.3f} as assembled and '
                  f'{float(np.median(sub.rms_image.data[free])):.3f} after '
                  f'the catalog (the reference\'s whitened d); bit 16 on '
                  f'{int(nodata.sum())} pixels, bit 17 on the sentinel; '
                  f'catalog {len(rows)} rows, {good} GOODCUT at ml=False, '
                  f'transient {"a row" if near else "not a row"} of it',
                  flush=True)

        # ---- the rotated pair at ml=True -----------------------------------
        with scoring_model(d) as sm:
            _, _, _, cat, st, secs, ml_launches = run('scored', 1, ml=True)
        nsc = st.get('scored', 0)
        check(ml_launches['triplet_cut'] == (1 if nsc else 0)
              and ml_launches['braai_conv3x3'] == (4 if nsc else 0)
              and ml_launches['negpix_veto'] == 1
              and all(ml_launches[k] == n for k, n in ZOGY_LAUNCHES.items()),
              f'zogy pair (ml=True): launches {ml_launches}, scored {nsc}')
        err = check_scores(sm.calls, 'zogy pair (ml=True)') if nsc else 0.0
        print(f'zogy pair (ml=True, gather warp): {secs * 1e3:.0f} ms per '
              f'pair, filter {st["filter_s"]:.3f} s (ML step '
              f'{st.get("ml_s", 0.0):.3f} s, {nsc} candidates scored, '
              f'{int((cat.data["GOODCUT"] == 1).sum())} kept), host clock, '
              f'on {name}; H14 {ml_launches["negpix_veto"]}, H12 '
              f'{ml_launches["triplet_cut"]}, H13 '
              f'{ml_launches["braai_conv3x3"]} launches; card scores within '
              f'{err:.3g} of the plain layers', flush=True)

        # ---- H15-H18 on the rotated pair's own tensors ---------------------
        sub, sci, ref, launches = res['gather']
        aligned = ref.aligned_to(sci)
        scimbkg = np.ascontiguousarray(
            sci.background_subtracted_image.data).astype(np.float32) + BKG_VAL
        new = torch.as_tensor(scimbkg - BKG_VAL, device=dev)
        refdata = torch.as_tensor(np.ascontiguousarray(aligned.data, 'f4'),
                                  device=dev)
        sci_rms = np.ascontiguousarray(sci.rms_image.data, 'f4')
        ref_rms = np.ascontiguousarray(ref.rms_image.aligned_to(sci).data,
                                       'f4')
        bad = (sub.mask_image.data & BAD_SUM) > 0
        sn = float(np.median(sci_rms[~bad]))
        sr = max(float(np.median(ref_rms[~bad])), 1e-3)
        xs, ys, valid = (torch.as_tensor(a, device=dev) for a in
                         _select_stamps(sci, smax=ZOGY_STAMPS))
        nvalid = int(valid.sum())
        errs = {'psf_stamps': 0.0, 'psf_clip': 0.0}
        psfs = []
        for tag, img in (('science', new), ('aligned reference', refdata)):
            ks, kg = launch.psf_stamps(img, xs, ys, valid, 25)
            ps, pg = zogy.psf_stamps_plain(img, xs, ys, valid)
            check(torch.equal(kg, pg), f'psf_stamps good0 differs on the '
                  f'{tag}')
            errs['psf_stamps'] = max(errs['psf_stamps'], close(
                f'psf_stamps {tag}', ks[pg], ps[pg], 0.0, 1e-7))
            kp, kgood = launch.psf_clip(ks, kg, 2)
            pp, pgood = zogy.psf_clip_plain(ks, kg, 2)
            check(torch.equal(kgood, pgood), f'psf_clip good differs on the '
                  f'{tag}')
            errs['psf_clip'] = max(errs['psf_clip'], close(
                f'psf_clip {tag}', kp, pp, 0.0, 1e-7))
            whole = zogy.estimate_psf_from_stars(img, xs, ys, valid)
            close(f'estimate_psf_from_stars {tag}', whole,
                  zogy.estimate_psf_plain(img, xs, ys, valid), 0.0, 1e-7)
            psfs.append(whole)
            print(f'zogy PSF of the {tag}: {nvalid} stamps, '
                  f'{int(pg.sum())} good0, {int(kgood.sum())} kept by the '
                  f'clip (equal on the card and in the plain version); '
                  f'peak {float(whole.max()):.5f}', flush=True)
        # H17 at an even size (fftfreq's -1/2 at n / 2: the ramped spectrum
        # is not Hermitian there) on the science frame
        ks, kg = launch.psf_stamps(new, xs, ys, valid, ZOGY_EVEN_STAMP)
        ps, pg = zogy.psf_stamps_plain(new, xs, ys, valid, ZOGY_EVEN_STAMP)
        check(torch.equal(kg, pg), f'psf_stamps good0 differs at size '
              f'{ZOGY_EVEN_STAMP}')
        err_even = close(f'psf_stamps size {ZOGY_EVEN_STAMP}', ks[pg], ps[pg],
                         0.0, 1e-7)
        errs['psf_stamps'] = max(errs['psf_stamps'], err_even)
        print(f'psf_stamps at size {ZOGY_EVEN_STAMP} on the science frame: '
              f'{int(pg.sum())} good0 (equal), max abs err {err_even:.3g} '
              f'against the plain version', flush=True)
        # H15 alone on the pair's spectra: the modes where it and the plain
        # version differ, and cuFFT's inverse of one input twice
        sc = zogy.zogy_scalars(sn, sr)
        spectra = [torch.fft.rfft2(new), torch.fft.rfft2(refdata),
                   zogy._psf_to_otf(psfs[0], (H, W)),
                   zogy._psf_to_otf(psfs[1], (H, W))]
        kk = launch.zogy_spectral(*spectra, **sc)
        pp = zogy.spectral_pass_plain(*spectra, **sc)
        ndiff = [int((a != b).sum()) for a, b in zip(kk, pp)]
        err15 = max(float((a - b).abs().max()) for a, b in zip(kk, pp))
        print(f'zogy_spectral on the pair\'s spectra: modes differing from '
              f'the plain version in D_hat, P_d_hat, S_hat {ndiff} of '
              f'{kk[0].numel()} (max abs {err15:.3g})', flush=True)
        k = zogy.zogy_subtract(new, refdata, *psfs, sn, sr)
        p = zogy.zogy_subtract_plain(new, refdata, *psfs, sn, sr)
        dsig = float(p['d'].std())
        err_d = close('zogy d', k['d'], p['d'], 0.0, 1e-4 * dsig)
        pd_peak = float(p['psf_d'].abs().max())
        err_pd = close('zogy psf_d', k['psf_d'], p['psf_d'], 0.0, 1e-9)
        # the two sums of p_d^2 add in other orders: an ulp of the norm is
        # an ulp of the score's peak (~1.2e-4 at 1000 sigma)
        err_s = close('zogy s_corr', k['s_corr'], p['s_corr'], 2.4e-7, 1e-4)
        kd, ks_ = k['d'].cpu().numpy(), k['s_corr'].cpu().numpy()
        check(np.array_equal(kd[~bad], sub.data[~bad])
              and np.array_equal(ks_, sub.scorr_image.data),
              'zogy: the product is not the kernels\' d and s_corr')
        f64 = zogy.zogy_subtract_plain(new.double(), refdata.double(),
                                       *(q.double() for q in psfs), sn, sr)
        e64_d = float((k['d'].double() - f64['d']).abs().max())
        e64_s = float((k['s_corr'].double() - f64['s_corr']).abs().max())
        check(e64_d <= 0.1 and e64_s <= 0.01,
              f'zogy: the card\'s f32 d and s_corr are {e64_d:.3g} and '
              f'{e64_s:.3g} from a float64 run')
        print(f'zogy {H}x{W}: H15/H16 through d (std {dsig:.3f}), psf_d '
              f'(peak {pd_peak:.4g}), s_corr against the plain passes: '
              f'{err_d:.3g}, {err_pd:.3g}, {err_s:.3g}; f32 on the card '
              f'against float64 on the card: d {e64_d:.3g}, s_corr '
              f'{e64_s:.3g}', flush=True)

        # ---- times ---------------------------------------------------------
        n = spectra[0].numel()
        same = not any(ndiff)
        ms = graph_ms(lambda: launch.zogy_spectral(*spectra, **sc))
        call_ms = cuda_ms(lambda: launch.zogy_spectral(*spectra, **sc))
        plain = cuda_ms(lambda: zogy.spectral_pass_plain(*spectra, **sc),
                        1, 3)
        # A reads the two OTFs (16 B per mode); B reads the four spectra
        # (32 B) and writes three (24 B); ~60 operations per mode
        bnd = bound(72 * n, 60 * n)
        print(f'zogy_spectral: {n} modes (strides {spectra[0].stride()}): '
              f'{ms:.4f} ms on the card (graph replay; bound {bnd[0]:.4f} ms, '
              f'share {bnd[0] / ms:.1%}), {call_ms:.4f} ms per wrapper call '
              f'with its host cost, plain {plain:.3f} ms; '
              f'{"bit-equal to" if same else "differs from"} the plain '
              f'version (max abs {err15:.3g}); no PyTorch call computes it',
              flush=True)
        record('zogy_spectral', err_d, ms, plain, bnd, runs=launches,
               per='zogy pair')
        p_d = torch.fft.irfft2(kk[1], s=(H, W))
        s_ = torch.fft.irfft2(kk[2], s=(H, W))
        f_d = sc['f_d']
        err16 = close('zogy_normalize', launch.zogy_normalize(p_d, s_, f_d),
                      zogy.score_normalize_plain(p_d, s_, f_d), 1e-6, 0.0)
        ms = graph_ms(lambda: launch.zogy_normalize(p_d, s_, f_d))
        call_ms = cuda_ms(lambda: launch.zogy_normalize(p_d, s_, f_d))
        plain = cuda_ms(lambda: zogy.score_normalize_plain(p_d, s_, f_d),
                        1, 3)
        norm_ms = cuda_ms(lambda: torch.linalg.vector_norm(p_d))
        # reads p_d and s, writes s_corr (12 B/px); a square-add and a
        # divide per pixel
        bnd = bound(12 * H * W, 3 * H * W)
        print(f'zogy_normalize: {H}x{W}: {ms:.4f} ms on the card (graph '
              f'replay; bound {bnd[0]:.4f} ms, share {bnd[0] / ms:.1%}), '
              f'{call_ms:.4f} ms per wrapper call with its host cost, plain '
              f'{plain:.3f} ms; for scale '
              f'torch.linalg.vector_norm(p_d) alone {norm_ms:.4f} ms; max '
              f'abs err {err16:.3g}', flush=True)
        record('zogy_normalize', err_s, ms, plain, bnd, runs=launches,
               per='zogy pair')
        ms = graph_ms(lambda: launch.psf_stamps(new, xs, ys, valid, 25))
        call_ms = cuda_ms(lambda: launch.psf_stamps(new, xs, ys, valid, 25))
        plain = cuda_ms(lambda: zogy.psf_stamps_plain(new, xs, ys, valid),
                        1, 3)
        # the function's own work, as the reference does it in f32
        # (bench_detect.stamps_bound). H17 itself issues more: four DFT
        # passes in double over the half spectrum, 50,050 FMAs a 25x25
        # stamp (bench_detect.stamp_flop: 6.4e6 FLOP for 64 stamps)
        S = ZOGY_STAMPS
        bnd = stamps_bound(S, 25)
        print(f'psf_stamps: {S} stamps of 25x25 on {H}x{W}: {ms:.4f} ms on '
              f'the card (graph replay; bound {bnd[0]:.5f} ms by {bnd[1]}, '
              f'share {bnd[0] / ms:.1%}), {call_ms:.4f} ms per wrapper call '
              f'with its host cost, plain {plain:.3f} ms', flush=True)
        record('psf_stamps', errs['psf_stamps'], ms, plain, bnd,
               runs=launches, per='zogy pair')
        ks, kg = launch.psf_stamps(new, xs, ys, valid, 25)
        ms = graph_ms(lambda: launch.psf_clip(ks, kg, 2))
        call_ms = cuda_ms(lambda: launch.psf_clip(ks, kg, 2))
        plain = cuda_ms(lambda: zogy.psf_clip_plain(ks, kg, 2), 1, 3)
        # reads the stamps and flags once, writes the PSF and the flags;
        # three passes of ~6 operations per stamp pixel
        bnd = bound(S * 625 * 4 + 2 * S + 625 * 4, 3 * 6 * S * 625)
        kept = launch.psf_clip(ks, kg, 2)[1]
        print(f'psf_clip: {S} stamps of 25x25 ({int(kg.sum())} good, '
              f'{int(kept.sum())} kept), 2 clip passes: {ms:.5f} ms on the '
              f'card (graph replay; bound {bnd[0]:.5f} ms, share '
              f'{bnd[0] / ms:.1%}), {call_ms:.4f} ms per wrapper call with '
              f'its host cost, plain {plain:.3f} ms', flush=True)
        record('psf_clip', errs['psf_clip'], ms, plain, bnd, runs=launches,
               per='zogy pair')
        padded = []
        for q in psfs:
            z = torch.zeros((H, W), device=dev)
            z[:25, :25] = q
            padded.append(torch.roll(z, (-12, -12), dims=(0, 1)))

        def transforms():
            torch.fft.rfft2(new), torch.fft.rfft2(refdata)
            for z in padded:
                torch.fft.rfft2(z)
            for c in kk:
                torch.fft.irfft2(c, s=(H, W))
        fft_ms = cuda_ms(transforms)
        total_ms = cuda_ms(lambda: zogy.zogy_subtract(new, refdata, *psfs,
                                                      sn, sr))
        print(f'zogy: cuFFT, the seven transforms at {H}x{W} (fp32) '
              f'{fft_ms:.3f} ms; zogy_subtract whole (transforms, glue, H15, '
              f'H16) {total_ms:.3f} ms on {name}', flush=True)

    # ---- a small rotated pair on the card and on the CPU -------------------
    with tempfile.TemporaryDirectory(prefix='chip_smoke_zogy_') as d:
        outs = {}
        for where in ('cuda', 'cpu'):
            dd = os.path.join(d, where)
            os.mkdir(dd)
            work, _ = inputs.write_night_pairs(
                dd, 1, 256, 256, ref_rot_deg=(PAIR_ROT,), nstars=30,
                header_json=header_json)
            sci = ScienceImage.from_file(work[0].split()[0])
            ref = ReferenceImage.from_file(work[0].split()[1])
            outs[where] = SingleEpochSubtraction.from_images(
                sci, ref, method='zogy', device=where)
        a, b = outs['cuda'], outs['cpu']
        check(np.array_equal(a.mask_image.data, b.mask_image.data)
              and all(a.header[k_] == b.header[k_]
                      for k_ in ('SUBKO', 'SUBNRX', 'SUBMETH', 'SEEING')),
              'small zogy pair: mask or header cards differ between card and '
              'CPU')
        ok = a.mask_image.data == 0
        errs = []
        for x, y in ((a.data, b.data), (a.scorr_image.data,
                                        b.scorr_image.data)):
            e = np.abs(x - y)[ok]
            errs.append((float(np.percentile(e, 99)), float(e.max())))
            check(errs[-1][0] < 5e-3 and errs[-1][1] < 0.1,
                  f'small zogy pair: card and CPU differ by {errs[-1]}')
        print(f'small zogy pair (256x256, reference rotated by {PAIR_ROT} '
              f'deg): card and CPU agree on the submask and the header; diff '
              f'99th percentile and max abs diff {errs[0]}, scorr {errs[1]}',
              flush=True)


class recording_step:
    """While open, the dispatchers of the training layers (H13t, H19, H20)
    and the Adam update keep their arguments: each layer's inputs at the
    main path's shapes, for the kernels' checks against their plain
    versions."""

    def __enter__(self):
        from zuds_tpu_torch.models import adam, braai
        self.fwd, self.dgrad, self.wgrad, self.adam = [], [], [], []
        self._saved = (braai.conv3x3_train, braai.conv3x3_dgrad,
                       braai.conv3x3_wgrad, adam.Adam.update)
        fwd, dgrad, wgrad, update = self._saved

        def keep(store, fn):
            def call(*args):
                store.append(args)
                return fn(*args)
            return call

        def upd(tx, grads, state, params, plain=False):
            self.adam.append(tuple(t.flat.clone() for t in (
                params, grads, state['mu'], state['nu']))
                + (state['count'].clone(),))
            return update(tx, grads, state, params, plain)

        braai.conv3x3_train = keep(self.fwd, fwd)
        braai.conv3x3_dgrad = keep(self.dgrad, dgrad)
        braai.conv3x3_wgrad = keep(self.wgrad, wgrad)
        adam.Adam.update = upd
        return self

    def __exit__(self, *exc):
        from zuds_tpu_torch.models import adam, braai
        (braai.conv3x3_train, braai.conv3x3_dgrad, braai.conv3x3_wgrad,
         adam.Adam.update) = self._saved


class card_forward:
    """While open, the plain training forward (``conv3x3_train_plain``)
    gives H13t's output and routing bytes instead of its own, so the plain
    step's backward and update run on the card's forward decisions.
    ``differ`` gains, per layer, the routing bytes (a pooled layer) or the
    ReLU signs of the output (an unpooled one) where the plain forward
    decided otherwise."""

    def __enter__(self):
        from zuds_tpu_torch.kernels import launch
        from zuds_tpu_torch.models import braai
        self._saved = plain = braai.conv3x3_train_plain
        self.differ = []

        def call(x, w, b, pool, mask=None, keep=1.0):
            y, route = plain(x, w, b, pool, mask, keep)
            ky, kr = launch.braai_conv3x3_train(x.contiguous(), w, b, pool,
                                                mask, keep)
            self.differ.append(int((kr != route).sum()) if pool
                               else int(((ky > 0) != (y > 0)).sum()))
            return ky, kr

        braai.conv3x3_train_plain = call
        return self

    def __exit__(self, *exc):
        from zuds_tpu_torch.models import braai
        braai.conv3x3_train_plain = self._saved


def near_ties(r, ho, wo, tol):
    """NHWC bool: the 2x2 windows of the pool over the pre-activations
    ``r`` (N, C, Hc, Wc; before ReLU) whose largest value lies within
    ``tol`` of 0 (ReLU may or may not pass it) or, positive, within ``tol``
    of the second (their first maximum may move with the summation
    order)."""
    n, c = r.shape[:2]
    win = r[:, :, :2 * ho, :2 * wo].reshape(n, c, ho, 2, wo, 2)
    win = win.permute(0, 1, 2, 4, 3, 5).reshape(n, c, ho, wo, 4)
    top = win.topk(2, dim=-1).values
    tie = (top[..., 0].abs() <= tol) | (
        (top[..., 0] > 0) & (top[..., 0] - top[..., 1] <= tol))
    return tie.permute(0, 2, 3, 1)


def close_to_max(name, got, want, rel):
    """Max abs error of ``got`` against ``want``; fail past ``rel`` times
    the largest magnitude of ``want``."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= rel * scale, f'{name}: max abs err {err:.3g} past {rel} x '
          f'{scale:.3g}')
    return err


def adam_aware(name, got, want, mu, lr=TRAIN_LR):
    """The parameters of a step by the Adam-aware rule: within 1e-5 where
    the gradient (``mu``, 0.1 g after one step) is over 1e-3 of its
    largest, within 2 lr elsewhere (a near-zero gradient whose sign
    differs moves its parameter by 2 lr), at most 0.1% past 1e-5."""
    d = (got - want).abs()
    near0 = mu.abs() <= 1e-3 * float(mu.abs().max())
    far = int((d > 1e-5).sum())
    check(float(d[~near0].max()) <= 1e-5
          and (float(d[near0].max()) if near0.any() else 0.0) <= 2 * lr
          and far <= 1e-3 * d.numel(),
          f'{name}: parameters differ by {float(d.max()):.3g} '
          f'({far} past 1e-5)')
    return float(d.max()), far


def train_bound(kname, nbytes, flop):
    """The bound of H19 or H20 on its own unit: 3xTF32, three tensor-core
    products per product (H13t's layers: :func:`h13_bound`)."""
    check(kname in ('braai_conv3x3_dgrad', 'braai_conv3x3_wgrad'), kname)
    return bound(nbytes, 3 * flop, TF32_FLOP_S)


def routed_flop(gy, cin):
    """The FLOP of one backward convolution (H19's or H20's) from the
    layer's output gradient ``gy``: each element reaches one position of
    the convolution's output (a pooled layer's through its routing byte,
    to one position of its 2x2 window), which takes 9 Cin products and
    sums."""
    return 2 * gy.numel() * 9 * cin


def backward_resources(widths):
    """Print ptxas's report (``nvcc -Xptxas -v``) of H13's two kernels
    (layer 1's FMA kernel and the tensor-core kernel) and H19's and H20's kernels, and what a launch of H19 and H20
    gets on this card per layer (registers, spills, dynamic shared memory,
    resident blocks); ``widths`` the layers' input widths."""
    import re
    from zuds_tpu_torch.kernels import build, launch
    lines, fn = [], None
    for line in build.ptxas_report('braai.cu').splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            k = re.search(r'(conv3x3_mma|conv3x3|[dw]grad)_kernelILi(\d+)'
                          r'ELi(\d+)E(?:Lb([01])E)?(?:Lb([01])E)?',
                          m.group(1))
            fn = (f'{k.group(1)}_kernel<' + ', '.join(
                g for g in k.groups()[1:] if g is not None) + '>'
                  if k else None)
        elif fn and ('Used' in line or 'spill' in line):
            lines.append(f'{fn}: {line.split(":", 1)[-1].strip()}')
    check(len(lines) >= 14, f'ptxas reported {len(lines)} lines for H13, '
          'H19 and H20')
    print('ptxas -v, H13, H19 and H20: ' + '; '.join(lines),
          flush=True)
    for (cin, cout, pool), wd in zip(launch.BRAAI_LAYERS, widths):
        for kind in (('dgrad', 'wgrad') if cin > 3 else ('wgrad',)):
            r = launch.braai_backward_resources(kind, cin, cout, pool, wd)
            print(f'{kind} {cin}x{cout}{" pool" if pool else ""} at width '
                  f'{wd}: {r["registers"]} registers, {r["spill_bytes"]} '
                  f'bytes spilled, {r["smem_bytes"]} bytes of dynamic shared '
                  f'memory, {r["blocks_per_sm"]} blocks per SM', flush=True)


def train_kernel_checks(rec, params, name):
    """H13t, H19, H20 (per layer) and H21 against their plain versions on
    the tensors of the step :class:`recording_step` kept, timed beside
    their bounds and library calls; ``params`` the step's result.
    Returns the layer kernels' sums (ms, plain, lib, flop, bytes, err
    per kernel) and H21's (ms, plain ms, library ms, bound)."""
    import torch
    import torch.nn.functional as F
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import adam, braai
    dev = torch.device('cuda')
    tot = {k: {'ms': 0.0, 'plain': 0.0, 'lib': 0.0, 'flop': 0.0,
               'bytes': 0.0, 'err': 0.0, 'bound': 0.0, 'opms': 0.0,
               'by': (0.0, 'bytes')} for k in TRAIN_ONLY[:3]}
    ties, apart = [], []
    for i, (xi, w, b, pool, mask, keep) in enumerate(rec.fwd):
        cin, cout = w.shape[2], w.shape[3]
        k, kr = launch.braai_conv3x3_train(xi, w, b, pool, mask, keep)
        p, pr = braai.conv3x3_train_plain(xi, w, b, pool, mask, keep)
        err = close(f'braai_conv3x3_train layer {i + 1}', k, p, 1e-5, 1e-6)
        k2, kr2 = launch.braai_conv3x3_train(xi, w, b, pool, mask, keep)
        check(torch.equal(k, k2) and (kr is None or torch.equal(kr, kr2)),
              f'H13t layer {i + 1}: two calls differ')
        e64 = f64_errors(k, p, braai.conv3x3_train_plain(
            xi.double(), w.double(), b.double(), pool, mask, keep)[0])
        check(e64[0] <= e64[1], f'H13t layer {i + 1}: {e64[0]:.3g} from '
              f'float64, cuDNN {e64[1]:.3g}')
        n, ho, wo, _ = p.shape
        hc, wc = xi.shape[1] - 2, xi.shape[2] - 2
        conv = (2 * ho) * (2 * wo) if pool else ho * wo
        xc = xi.permute(0, 3, 1, 2).contiguous()
        wcn = w.permute(3, 2, 0, 1).contiguous()
        mc = None if mask is None else mask.permute(0, 3, 1, 2).contiguous()
        if pool:
            r = F.conv2d(xc, wcn, b)
            tie = near_ties(r, ho, wo, 1e-5 * float(r.abs().max()))
            check(torch.equal(kr[~tie], pr[~tie]),
                  f'H13t layer {i + 1}: routing bytes differ off the near '
                  'ties')
            ties.append(float(tie.float().mean()))
            apart.append(int((kr != pr).sum()))
            check(ties[-1] < 0.01, f'H13t layer {i + 1}: {ties[-1]:.3%} of '
                  'the windows are near ties')
        keep_t = torch.full((), keep, device=dev)

        def lib_fwd(xc=xc, wcn=wcn, b=b, pool=pool, mc=mc, keep_t=keep_t):
            z = torch.relu(F.conv2d(xc, wcn, b))
            if not pool:
                return z
            v, idx = F.max_pool2d(z, 2, 2, return_indices=True)
            return torch.where(mc, v / keep_t, 0.0), idx

        ms = cuda_ms(lambda: launch.braai_conv3x3_train(xi, w, b, pool, mask,
                                                        keep))
        plain = cuda_ms(lambda: braai.conv3x3_train_plain(xi, w, b, pool,
                                                          mask, keep), 1, 3)
        lib_ms = cuda_ms(lib_fwd)
        flop = 2 * n * conv * cout * 9 * cin
        nbytes = 4 * (xi.numel() + p.numel() + w.numel() + b.numel()) \
            + (2 * p.numel() if pool else 0)
        bnd, fp32 = h13_bound(cin, nbytes, flop)
        print(f'braai_conv3x3_train layer {i + 1} ({cin}->{cout}'
              f'{", pool, dropout" if pool else ""}), {n} triplets: '
              f'{ms:.4f} ms (bound {bnd[0]:.4f} ms by {bnd[1]}'
              f'{" on fp32" if cin == 3 else " on 3xTF32"}, share '
              f'{bnd[0] / ms:.1%}; fp32 bound {fp32[0]:.4f} ms), plain '
              f'{plain:.3f} ms, cuDNN sequence {lib_ms:.3f} ms (TF32 off); '
              f'two calls bit-equal; max abs err {err:.3g}; against float64 '
              f'the kernel {e64[0]:.3g}, cuDNN {e64[1]:.3g}'
              + (f'; routing bytes equal off {ties[-1]:.4%} near ties, '
                 f'{apart[-1]} of {kr.numel()} ({apart[-1] / kr.numel():.4%})'
                 f' routed apart' if pool else '') + f' on {name}',
              flush=True)
        t13 = tot['braai_conv3x3_train']
        for key, v in (('ms', ms), ('plain', plain), ('lib', lib_ms),
                       ('flop', flop), ('bytes', nbytes), ('bound', bnd[0])):
            t13[key] += v
        t13['opms'] += h13_bound(cin, 0, flop)[0][0]
        t13['by'] = max(t13['by'], bnd)
        t13['err'] = max(t13['err'], err)
    # H19 and H20 run 3xTF32 on the tensor cores: their bound is three
    # times the routed FLOP over the TF32 peak (the fp32 bound beside it);
    # against float64 each is held to cuDNN's own error (TF32 off)
    for gy, w, saved, mask, keep, pool, in_shape in rec.dgrad:
        i = [tuple(f[0].shape) for f in rec.fwd].index(tuple(in_shape))
        cin, cout = w.shape[2], w.shape[3]
        k = launch.braai_conv3x3_dgrad(gy, w, saved, mask, keep, pool,
                                       in_shape)
        k2 = launch.braai_conv3x3_dgrad(gy, w, saved, mask, keep, pool,
                                        in_shape)
        check(torch.equal(k, k2), f'H19 layer {i + 1}: two calls differ')
        p = braai.conv3x3_dgrad_plain(gy, w, saved, mask, keep, pool,
                                      in_shape)
        err = close_to_max(f'braai_conv3x3_dgrad layer {i + 1}', k, p, 1e-5)
        n, h, wd, _ = in_shape
        gz = braai.grad_z_plain(gy, saved, mask, keep, pool,
                                (h - 2, wd - 2)).permute(0, 3, 1, 2)\
            .contiguous()
        wcn = w.permute(3, 2, 0, 1).contiguous()
        lib = torch.nn.grad.conv2d_input((n, cin, h, wd), wcn, gz)
        g64 = torch.nn.grad.conv2d_input((n, cin, h, wd), wcn.double(),
                                         gz.double()).permute(0, 2, 3, 1)
        e64 = (float((k - g64).abs().max()),
               float((lib.permute(0, 2, 3, 1) - g64).abs().max()))
        check(e64[0] <= e64[1], f'H19 layer {i + 1}: {e64[0]:.3g} from '
              f'float64, cuDNN {e64[1]:.3g}')
        ms = cuda_ms(lambda: launch.braai_conv3x3_dgrad(
            gy, w, saved, mask, keep, pool, in_shape))
        plain = cuda_ms(lambda: braai.conv3x3_dgrad_plain(
            gy, w, saved, mask, keep, pool, in_shape), 1, 3)
        lib_ms = cuda_ms(lambda: torch.nn.grad.conv2d_input(
            (n, cin, h, wd), wcn, gz))
        flop = routed_flop(gy, cin)
        nbytes = 4 * (gy.numel() + w.numel() + n * h * wd * cin) + (
            saved.numel() * saved.element_size()) + (
            0 if mask is None else mask.numel())
        bnd = train_bound('braai_conv3x3_dgrad', nbytes, flop)
        print(f'braai_conv3x3_dgrad layer {i + 1} ({cin}<-{cout}'
              f'{", pool" if pool else ""}): {ms:.4f} ms (bound '
              f'{bnd[0]:.4f} ms by {bnd[1]} on 3xTF32, share '
              f'{bnd[0] / ms:.1%}; fp32 bound {bound(nbytes, flop)[0]:.4f}'
              f'), plain {plain:.3f} ms, cuDNN conv2d_input {lib_ms:.3f} ms;'
              f' two calls bit-equal; max abs err {err:.3g}; against float64'
              f' the kernel {e64[0]:.3g}, cuDNN {e64[1]:.3g} (largest |gx| '
              f'{float(g64.abs().max()):.3g}) on {name}', flush=True)
        for key, v in (('ms', ms), ('plain', plain), ('lib', lib_ms),
                       ('flop', flop), ('bytes', nbytes)):
            tot['braai_conv3x3_dgrad'][key] += v
        tot['braai_conv3x3_dgrad']['err'] = max(
            tot['braai_conv3x3_dgrad']['err'], err)
    for i, (xi, gy, saved, mask, keep, pool) in enumerate(reversed(rec.wgrad)):
        cin, cout = xi.shape[-1], gy.shape[-1]
        kw, kb = launch.braai_conv3x3_wgrad(xi, gy, saved, mask, keep, pool)
        kw2, kb2 = launch.braai_conv3x3_wgrad(xi, gy, saved, mask, keep,
                                              pool)
        check(torch.equal(kw, kw2) and torch.equal(kb, kb2),
              f'H20 layer {i + 1}: two calls differ')
        # the sums run over up to 861k terms in two orders: 1e-4 of the
        # largest gradient, the gradients' tolerance of the CPU tests
        pw, pb = braai.conv3x3_wgrad_plain(xi, gy, saved, mask, keep, pool)
        err = max(close_to_max(f'braai_conv3x3_wgrad layer {i + 1}', kw, pw,
                               1e-4),
                  close_to_max(f'braai_conv3x3_wgrad bias {i + 1}', kb, pb,
                               1e-4))
        h, wd = xi.shape[1:3]
        gz = braai.grad_z_plain(gy, saved, mask, keep, pool,
                                (h - 2, wd - 2)).permute(0, 3, 1, 2)\
            .contiguous()
        xc = xi.permute(0, 3, 1, 2).contiguous()

        def lib_w(xc=xc, gz=gz, shape=(cout, cin, 3, 3)):
            return torch.nn.grad.conv2d_weight(xc, shape, gz), gz.sum((0, 2,
                                                                        3))

        lw, lb = lib_w()
        w64 = torch.nn.grad.conv2d_weight(
            xc.double(), (cout, cin, 3, 3), gz.double())
        b64 = gz.double().sum((0, 2, 3))
        e64 = (max(float((kw - w64.permute(2, 3, 1, 0)).abs().max()),
                   float((kb - b64).abs().max())),
               max(float((lw - w64).abs().max()),
                   float((lb - b64).abs().max())))
        check(e64[0] <= e64[1], f'H20 layer {i + 1}: {e64[0]:.3g} from '
              f'float64, cuDNN {e64[1]:.3g}')
        ms = cuda_ms(lambda: launch.braai_conv3x3_wgrad(xi, gy, saved, mask,
                                                        keep, pool))
        plain = cuda_ms(lambda: braai.conv3x3_wgrad_plain(
            xi, gy, saved, mask, keep, pool), 1, 3)
        lib_ms = cuda_ms(lib_w)
        flop = routed_flop(gy, cin)
        nbytes = 4 * (xi.numel() + gy.numel() + 9 * cin * cout + cout) + (
            saved.numel() * saved.element_size()) + (
            0 if mask is None else mask.numel())
        bnd = train_bound('braai_conv3x3_wgrad', nbytes, flop)
        print(f'braai_conv3x3_wgrad layer {i + 1} ({cin}x{cout}'
              f'{", pool" if pool else ""}): {ms:.4f} ms (bound '
              f'{bnd[0]:.4f} ms by {bnd[1]} on 3xTF32, share '
              f'{bnd[0] / ms:.1%}; fp32 bound {bound(nbytes, flop)[0]:.4f}'
              f'), plain {plain:.3f} ms, cuDNN conv2d_weight and the bias '
              f'sum {lib_ms:.3f} ms; two calls bit-equal; max abs err '
              f'{err:.3g}; against float64 the kernel {e64[0]:.3g}, cuDNN '
              f'{e64[1]:.3g} (largest |gw| {float(w64.abs().max()):.3g}) on '
              f'{name}', flush=True)
        for key, v in (('ms', ms), ('plain', plain), ('lib', lib_ms),
                       ('flop', flop), ('bytes', nbytes)):
            tot['braai_conv3x3_wgrad'][key] += v
        tot['braai_conv3x3_wgrad']['err'] = max(
            tot['braai_conv3x3_wgrad']['err'], err)
    # H21 on the step's own buffers: bit-equal, timed on copies
    p, g, mu, nu, count = rec.adam[0]
    bc1, bc2 = adam.bias_corrections(count + 1)
    kp, kmu, knu = p.clone(), mu.clone(), nu.clone()
    launch.adam_step(kp, g, kmu, knu, bc1, bc2, TRAIN_LR, adam.B1, adam.B2,
                     adam.EPS)
    want = adam.adam_update_plain(p, g, mu, nu, bc1, bc2, TRAIN_LR)
    for a, b_, what in zip((kp, kmu, knu), want, ('p', 'mu', 'nu')):
        check(torch.equal(a, b_), f'H21: {what} differs from the plain '
              f'version by {float((a - b_).abs().max()):.3g}')
    check(torch.equal(kp, params.flat),
          'H21 on the recorded buffers differs from the step\'s update')
    adam_ms = graph_ms(lambda: launch.adam_step(
        kp, g, kmu, knu, bc1, bc2, TRAIN_LR, adam.B1, adam.B2, adam.EPS))
    adam_call = cuda_ms(lambda: launch.adam_step(
        kp, g, kmu, knu, bc1, bc2, TRAIN_LR, adam.B1, adam.B2, adam.EPS))
    adam_plain = cuda_ms(lambda: adam.adam_update_plain(
        p, g, mu, nu, bc1, bc2, TRAIN_LR), 1, 3)
    leaf = torch.nn.Parameter(p.clone())
    leaf.grad = g.clone()
    opt = torch.optim.Adam([leaf], lr=TRAIN_LR, fused=True)
    adam_lib = cuda_ms(opt.step)
    npar = p.numel()
    adam_bnd = bound(28 * npar, 12 * npar)
    print(f'adam_step: {npar} parameters: {adam_ms:.4f} ms (graph replay; '
          f'bound {adam_bnd[0]:.4f} ms by {adam_bnd[1]}, share '
          f'{adam_bnd[0] / adam_ms:.1%}), {adam_call:.4f} ms per wrapper '
          f'call, plain {adam_plain:.3f} ms, torch.optim.Adam(fused=True) '
          f'{adam_lib:.4f} ms (other rounding: time only); bit-equal to the '
          f'plain version on {name}', flush=True)
    return tot, (adam_ms, adam_plain, adam_lib, adam_bnd)


def train_phase(wrappers, name, record):
    """braai training at full width: make_train_state(0) on the card and
    TRAIN_N labelled triplets; H13t, H19, H20 and H21 against their plain
    versions on one step's own tensors, with their times, bounds and
    library times; a step against the plain step with the same masks;
    TRAIN_STEPS counted and timed steps (the loss gate), ten more under the
    profiler; the trained weights through save_braai, load_braai and
    rb_scores on the card; one step at the dry run's batch of 2."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.models import adam, braai
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32,
          'TF32 is on for cuDNN or matmul')
    dev = torch.device('cuda')
    t_np, y_np = inputs.labelled_triplets(TRAIN_N, seed=0)
    x = torch.from_numpy(t_np).to(dev)
    y = torch.from_numpy(y_np).to(dev)

    # one step, its tensors kept: the kernels against their plain versions
    model, params, tx, state = braai.make_train_state(0)
    check(model.Conv_0['kernel'].is_cuda and state['count'].is_cuda,
          'make_train_state did not build on the card')
    gen = torch.Generator(device=dev).manual_seed(0)
    masks = braai.draw_masks(TRAIN_N, gen, dev)
    with recording_step() as rec:
        params, state, loss0 = braai.train_step(params, state, x, y, 0,
                                                masks=masks)
    check(len(rec.fwd) == 4 and len(rec.dgrad) == 3 and len(rec.wgrad) == 4
          and len(rec.adam) == 1, 'train: the recorded step ran '
          f'{len(rec.fwd)} H13t, {len(rec.dgrad)} H19, {len(rec.wgrad)} H20'
          f', {len(rec.adam)} Adam calls')
    backward_resources([f[0].shape[2] for f in rec.fwd])
    with torch.no_grad():
        tot, (adam_ms, adam_plain, adam_lib, adam_bnd) = \
            train_kernel_checks(rec, params, name)
    npar = params.flat.numel()

    # a step on the card against the plain step, same state and masks
    _, pk, _, sk = braai.make_train_state(0)
    _, pp, _, sp = braai.make_train_state(0)
    masks = braai.draw_masks(TRAIN_N, torch.Generator(device=dev)
                             .manual_seed(1), dev)
    pk, sk, lk = braai.train_step(pk, sk, x, y, 0, masks=masks)
    pp, sp, lp = braai.train_step_plain(pp, sp, x, y, 0, masks=masks)
    lk, lp = float(lk), float(lp)
    check(abs(lk - lp) <= 1e-5 * abs(lp), f'train: loss {lk} on the card, '
          f'{lp} plain')
    # mu = 0.1 g. Where a pool window's two largest values lie within the
    # rounding of the two forwards (0.09% of layer 2's windows lie within
    # 1e-5 of its largest value, ROADMAP section 3) the paths may route
    # its gradient to different positions, and a convolution kernel's
    # gradient gains one other term of its sum over up to 861k positions.
    # So mu is held at 1e-3 of its largest against the plain step, and at
    # 1e-4 against the plain step on the card's forward decisions (below)
    mu_p = sp['mu'].flat
    mu_k = sk['mu'].flat
    mu_err = close_to_max('train: mu', mu_k, mu_p, 1e-3)
    mu_far = int(((mu_k - mu_p).abs() > 1e-4 * float(mu_p.abs().max()))
                 .sum())
    p_err, far = adam_aware('train: parameters', pk.flat, pp.flat, mu_p)
    print(f'train: one step on the card against the plain step (same '
          f'masks): loss {lk:.7f} vs {lp:.7f}, mu within {mu_err:.3g} of a '
          f'largest {float(mu_p.abs().max()):.3g} ({mu_far} elements past '
          f'1e-4 of it), parameters within {p_err:.3g} ({far} past 1e-5 of '
          f'{npar})', flush=True)
    # the same plain step on the card's forward decisions: where the two
    # forwards route a pool window or pass a ReLU alike, mu holds at 1e-4
    _, pf, _, sf = braai.make_train_state(0)
    with card_forward() as fwd:
        pf, sf, lf = braai.train_step_plain(pf, sf, x, y, 0, masks=masks)
    mu_f = sf['mu'].flat
    mu_err_f = close_to_max('train: mu on the card\'s forward', mu_k, mu_f,
                            1e-4)
    mu_far_f = int(((mu_k - mu_f).abs() > 1e-4 * float(mu_f.abs().max()))
                   .sum())
    p_err_f, far_f = adam_aware('train: parameters on the card\'s forward',
                                pk.flat, pf.flat, mu_f)
    print(f'train: the plain step on the card\'s forward (H13t\'s outputs '
          f'and routing bytes; the plain forward decided otherwise at '
          f'{fwd.differ} routing bytes or ReLU signs of layers 1-4): loss '
          f'{float(lf):.7f}, mu within {mu_err_f:.3g} of the card\'s step '
          f'({mu_far_f} elements past 1e-4 of its largest), parameters '
          f'within {p_err_f:.3g} ({far_f} past 1e-5)', flush=True)

    # TRAIN_STEPS steps, counted and timed: the main path
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_STEPS):
        params, state, loss = braai.train_step(params, state, x, y, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    for k, n in launches.items():
        want = TRAIN_STEPS * TRAIN_LAUNCHES.get(k, 0)
        check(n == want, f'train: {k} launched {n} times in '
              f'{TRAIN_STEPS} steps, expected {want}')
    losses = torch.stack(losses).cpu().numpy()
    check(np.isfinite(losses).all(), 'train: a loss is not finite')
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    check(last < first - TRAIN_LOSS_DROP, f'train: the mean loss of the '
          f'last 10 steps {last:.4f} is not below the first 10\'s '
          f'{first:.4f} by {TRAIN_LOSS_DROP}')
    ms_step = secs * 1e3 / TRAIN_STEPS
    print(f'train: {TRAIN_STEPS} steps of {TRAIN_N} triplets: '
          f'{ms_step:.3f} ms/step, {TRAIN_N * TRAIN_STEPS / secs:.1f} '
          f'triplets/s (host clock) on {name}; loss {losses[0]:.4f} -> '
          f'{losses[-1]:.4f} (mean of the first 10 {first:.4f}, of the last '
          f'10 {last:.4f}); launches per step '
          + ', '.join(f'{k} {launches[k] // TRAIN_STEPS}'
                      for k in TRAIN_ONLY), flush=True)
    # ten more steps under the profiler: the device's busy share
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            params, state, loss = braai.train_step(params, state, x, y, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    # the kernels' own device time (an op's total would count its
    # kernels again)
    by_name = {}
    for e in prof.key_averages():
        t = getattr(e, 'self_device_time_total', None) or getattr(
            e, 'self_cuda_time_total', 0)
        if t:
            by_name[e.key] = t / 1e3 / 10
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f'train: profiler over 10 steps: wall {wall * 1e3 / 10:.3f} '
          f'ms/step, device busy {busy / 10:.3f} ms/step ('
          + (f'{busy / (wall * 1e3):.1%}' if busy else 'not measured: no '
             'device events') + f') on {name}; device ms/step by name: '
          + '; '.join(f'{k[:60]} {v:.4f}' for k, v in top), flush=True)

    # the library step: autograd of F.conv2d (cuDNN, TF32 off) and the
    # dense head, same masks, torch.optim.Adam(fused=True)
    lib_params = [t.detach().clone().requires_grad_() for t in (
        [model.Conv_0['kernel'], model.Conv_0['bias'], model.Conv_1['kernel'],
         model.Conv_1['bias'], model.Conv_2['kernel'], model.Conv_2['bias'],
         model.Conv_3['kernel'], model.Conv_3['bias'],
         model.Dense_0['kernel'], model.Dense_0['bias'],
         model.Dense_1['kernel'], model.Dense_1['bias']])]
    lib_opt = torch.optim.Adam(lib_params, lr=TRAIN_LR, fused=True)
    xc = x.permute(0, 3, 1, 2).contiguous()
    mcs = [masks['Dropout_0'].permute(0, 3, 1, 2).contiguous(),
           masks['Dropout_1'].permute(0, 3, 1, 2).contiguous(),
           masks['Dropout_2']]
    kc = torch.full((), braai.KEEP_CONV, device=dev)
    kd = torch.full((), braai.KEEP_DENSE, device=dev)

    def lib_step():
        lib_opt.zero_grad(set_to_none=False)
        h = xc
        for j in range(4):
            wj = lib_params[2 * j].permute(3, 2, 0, 1)
            h = torch.relu(F.conv2d(h, wj, lib_params[2 * j + 1]))
            if j % 2:
                h = torch.where(mcs[j // 2], F.max_pool2d(h, 2, 2) / kc, 0.0)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = torch.relu(h @ lib_params[8] + lib_params[9])
        h = torch.where(mcs[2], h / kd, 0.0)
        s = torch.sigmoid(h @ lib_params[10] + lib_params[11])[..., 0]
        braai.bce_loss(s, y).backward()
        lib_opt.step()

    lib_step_ms = cuda_ms(lib_step, 2, 10)
    conv_flop = sum(tot[k]['flop'] for k in TRAIN_ONLY[:3])
    conv_ms = tot['braai_conv3x3_train']['opms'] + sum(
        train_bound(k, 0, tot[k]['flop'])[0] for k in TRAIN_ONLY[1:3])
    head_flop = 3 * 2 * TRAIN_N * (9216 * 256 + 256)
    step_bnd = conv_ms + bound(0, head_flop)[0] + adam_bnd[0]
    print(f'train: the step\'s bound {step_bnd:.4f} ms (convolutions '
          f'{conv_flop:.4g} FLOP, {conv_ms:.4f} ms, H13t at layers 2-4, '
          f'H19 and H20 on 3xTF32; '
          f'dense head {head_flop:.4g} FLOP, {bound(0, head_flop)[0]:.4f} '
          f'ms; Adam '
          f'{adam_bnd[0]:.4f} ms by bytes): {ms_step:.3f} ms/step, share '
          f'{step_bnd / ms_step:.1%}; the library step (cuDNN autograd, '
          f'fused Adam) {lib_step_ms:.3f} ms/step on {name}', flush=True)

    # the trained weights: save_braai, load_braai, rb_scores on the card
    with tempfile.TemporaryDirectory(prefix='chip_smoke_train_') as d:
        path = os.path.join(d, 'braai_d6_m9.npz')
        braai.save_braai(params, path)
        loaded, _ = braai.load_braai(path)
    check(loaded.Conv_0['kernel'].is_cuda, 'load_braai did not load onto '
          'the card')
    with torch.no_grad():
        s_trained = braai.rb_scores(model, x)
    s_loaded = braai.rb_scores(loaded, x)
    check(torch.equal(s_trained, s_loaded), 'train: the saved and loaded '
          'model scores otherwise than the trained one')
    real = float(s_loaded[y == 1].mean())
    bogus = float(s_loaded[y == 0].mean())
    check(real > bogus, f'train: trained scores real {real:.3f} not above '
          f'bogus {bogus:.3f}')
    print(f'train: trained weights saved, loaded on the card and scored: '
          f'mean RB real {real:.3f}, bogus {bogus:.3f}', flush=True)

    # the dry run's shape: one step on 2 Gaussian triplets, labels 0 and 1
    rng = np.random.default_rng(0)
    t2 = rng.normal(size=(TRAIN_DRYRUN_N, 63, 63, 3)).astype('f4')
    _, p2, _, s2 = braai.make_train_state(0)
    n0 = {k: launch.WRAPPERS[k].launches for k in TRAIN_ONLY}
    p2, s2, l2 = braai.train_step(p2, s2, t2, np.array([0.0, 1.0], 'f4'), 0)
    check(bool(torch.isfinite(l2)) and bool(torch.isfinite(
        p2.flat).all()), 'train: the dry run\'s step is not '
        'finite')
    check(all(launch.WRAPPERS[k].launches - n0[k] == TRAIN_LAUNCHES[k]
              for k in TRAIN_ONLY), 'train: the dry run\'s step did not '
          'launch every training kernel')
    print(f'train: one step at the dry run\'s batch of {TRAIN_DRYRUN_N}: '
          f'loss {float(l2):.4f}', flush=True)

    for k in TRAIN_ONLY[:3]:
        t = tot[k]
        # H13t: its layers' bounds on their own units, added
        bnd = ((t['bound'], t['by'][1]) if k == 'braai_conv3x3_train'
               else train_bound(k, t['bytes'], t['flop']))
        record(k, t['err'], t['ms'], t['plain'], bnd, library_ms=t['lib'],
               runs=launches, per=f'{TRAIN_STEPS} training steps of '
               f'{TRAIN_N}')
    record('adam_step', 0.0, adam_ms, adam_plain, adam_bnd,
           library_ms=adam_lib, runs=launches,
           per=f'{TRAIN_STEPS} training steps')
    return ms_step


def persist_thumbs(sess, directory, name, n):
    """dothumb's twin over the night's committed thumbnails: every one
    persisted (``file_uri`` set, at least the ``n`` the db phase checked),
    each PNG decoding to its
    stamp's zscale rendering (without matplotlib, as on the card machine)
    or at least a PNG; prints the host seconds."""
    import gzip
    import io
    import numpy as np
    from zuds_tpu_torch import thumb
    from zuds_tpu_torch.fits import read_fits
    from zuds_tpu_torch.image import zscale_limits
    from zuds_tpu_torch.thumbnails import (Thumbnail, gray_levels,
                                           read_png_gray)
    t0 = time.perf_counter()
    done = thumb.persist_all(directory)
    secs = time.perf_counter() - t0
    rows = sess.query(Thumbnail).all()
    check(done == len(rows) >= n and all(t.file_uri for t in rows),
          f'surface: dothumb persisted {done} of {len(rows)} thumbnails '
          f'({n} checked by the db phase)')
    kinds = set()
    for t in rows:
        stamp = read_fits(io.BytesIO(gzip.decompress(t.bytes)))[0].data
        with open(t.file_uri, 'rb') as f:
            check(f.read(8) == b'\x89PNG\r\n\x1a\n',
                  f'surface: {t.file_uri} is not a PNG')
        try:
            px = read_png_gray(t.file_uri)
        except ValueError:
            kinds.add('matplotlib')
            continue
        kinds.add('zlib')
        check(np.array_equal(
                  px, gray_levels(stamp, *zscale_limits(stamp))[::-1]),
              f'surface: {t.file_uri} is not its stamp\'s zscale rendering')
    print(f'surface: dothumb persisted {done} thumbnails of the night in '
          f'{secs:.3f} s ({sorted(kinds)} PNGs, each decoding to its '
          f'stamp\'s zscale rendering) (host clock) on {name}', flush=True)


def mesh_phase(wrappers, name, pipe, targs, out, single_s):
    """The mesh twin (``parallel/mesh.py``) on the card: (a) a world of one
    over NCCL, the slice's batch placed by ``place_batch`` through
    ``SubtractDetectPipeline(cfg, mesh)`` against the single-process
    ``out``, then timed in turns with the single-process ``pipe``; (b) two
    ranks over gloo
    sharing the card (NCCL refuses two ranks on one device; gloo's
    collectives go through the host), started once by ``spawn_ranks``:
    one flagship frame a rank (the same batch), the coadd's rows over
    'space' at both ``subtract_back`` and braai's step at batch TRAIN_N,
    each against the single-process run on this card. Every comparison is
    bit for bit but the step's (its gradient is summed in another order:
    the share of parameters that moved apart by more than 1e-5 at most
    1e-3, the moments within 1e-5 of their largest). Prints each leg's host
    seconds beside ``single_s``, the single-process batch's."""
    import dataclasses as dc
    import torch
    import torch.distributed as dist
    from zuds_tpu_torch import inputs, night
    from zuds_tpu_torch.models import braai
    from zuds_tpu_torch.parallel import (CoaddPipeline,
                                         SubtractDetectPipeline, legs)
    from zuds_tpu_torch.parallel import mesh as pmesh
    cfg = night.FLAGSHIP
    H, W = cfg.height, cfg.width
    B = targs[0].shape[0]

    # (a) world 1 over NCCL
    mesh1 = pmesh.quadrant_mesh()
    check(dist.get_backend() == 'nccl' and dist.get_world_size() == 1,
          f'mesh: world of one over {dist.get_backend()}')
    mesh_pipe = SubtractDetectPipeline(cfg, mesh1)
    placed = pmesh.place_batch(mesh1, *targs, device='cuda')
    got, launches, secs = run_counted(mesh_pipe, placed, wrappers)
    gathered = pmesh.gather_batch(mesh1, got)
    bad = [k for k in out if not torch.equal(gathered[k], out[k])]
    check(not bad, f'mesh: world-1 NCCL pipeline differs from the '
          f'single-process run in {bad}')
    check(launches['warp'] == B and launches['apply_model'] == B,
          f'mesh: world-1 launches {launches}')
    # the host clock spreads: batches timed one by one, in turns with the
    # single-process pipeline, the gather included
    batch_ms = {'mesh': [], 'single': []}
    for _ in range(5):
        for mode, run in (('mesh', lambda: pmesh.gather_batch(
                mesh1, mesh_pipe(*placed))), ('single', lambda: pipe(*targs))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            batch_ms[mode].append((time.perf_counter() - t0) * 1e3 / B)
    mm, sm = batch_ms['mesh'], batch_ms['single']
    print(f'mesh (a): world 1 over NCCL, {B} flagship frames: '
          f'{statistics.median(mm):.1f} ms/frame (range {min(mm):.1f}-'
          f'{max(mm):.1f}) against the single-process pipeline\'s '
          f'{statistics.median(sm):.1f} (range {min(sm):.1f}-{max(sm):.1f}); '
          f'host clock, median of {len(mm)} batches each in turns, the '
          f'gather included; the first, counted run {secs * 1e3 / B:.1f} '
          f'ms/frame; bit-equal; launches '
          f'{dict((k, v) for k, v in launches.items() if v)} on {name}',
          flush=True)
    dist.destroy_process_group()

    # (b) two ranks over gloo sharing the card
    ccfg = dc.replace(cfg, map_step=32)
    n_ep = MESH_EPOCHS
    trip, lab = inputs.labelled_triplets(TRAIN_N, seed=3)
    specs = [('subtract', (cfg, B, 0, 'cuda'), {'warmup': True}),
             ('coadd', (ccfg, n_ep, 5, 'cuda'),
              {'subtract_back': True, 'warmup': True}),
             ('coadd', (ccfg, n_ep, 5, 'cuda'),
              {'subtract_back': False, 'warmup': True}),
             ('train', (trip, lab, None, 'cuda'),
              {'seed': 4, 'warmup': True})]
    t0 = time.perf_counter()
    res = pmesh.spawn_ranks(legs.run_legs, 2, (specs,), backend='gloo',
                            timeout=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    sub0, sub1 = res[0][0], res[1][0]
    check(sub0['frames'] == [0] and sub1['frames'] == [1],
          f'mesh: ranks ran frames {sub0["frames"]}, {sub1["frames"]}')
    bad = [k for k in out if not torch.equal(sub0['out'][k], out[k].cpu())]
    check(not bad, f'mesh: 2-rank pipeline differs from the single-process '
          f'run in {bad}')
    for r in (0, 1):
        la = res[r][0]['launches']
        check(la['warp'] == 1 and la['apply_model'] == 1,
              f'mesh: rank {r} launches {la}')
    print(f'mesh (b): 2 ranks over gloo sharing the card, one flagship '
          f'frame each (after a warm-up run): rank seconds '
          f'{sub0["secs"]:.4f}, {sub1["secs"]:.4f}, then the gather through '
          f'the host {sub0["gather_secs"]:.4f}, {sub1["gather_secs"]:.4f} '
          f'(the single-process batch of {B} {single_s:.4f}); bit-equal to '
          f'the single-process batch; {wall:.1f} s for the spawn and all '
          f'legs, on {name}', flush=True)
    args = inputs.to_torch(inputs.coadd_inputs(n_ep, H, W, ccfg.map_step,
                                               seed=5), 'cuda')
    for i, sb in ((1, True), (2, False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = CoaddPipeline(ccfg, subtract_back=sb)(*args)
        torch.cuda.synchronize()
        one = time.perf_counter() - t0
        got = res[0][i]['out']
        bad = [k for k in want if not torch.equal(got[k], want[k].cpu())]
        check(not bad, f'mesh: coadd rows over space (subtract_back={sb}) '
              f'differ from the single process in {bad}')
        la = res[0][i]['launches']
        check(la['warp'] == n_ep + 1 and la['clipped_combine'] == 1,
              f'mesh: coadd rank 0 launches {la}')
        print(f'mesh (b): coadd of {n_ep} epochs and a padded one at '
              f'{H}x{W}, rows over 2 ranks (subtract_back={sb}, after a '
              f'warm-up run): rank '
              f'seconds {res[0][i]["secs"]:.3f}, {res[1][i]["secs"]:.3f}; '
              f'single process {one:.3f}; bit-equal, on {name}', flush=True)
    _, p, _, st = braai.make_train_state(4, device='cuda')
    masks = braai.draw_masks(TRAIN_N, 4, torch.device('cuda'))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, st, loss = braai.train_step(p, st, trip, lab, 4, masks=masks)
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    got = res[0][3]['out']
    dl = abs(float(got['loss']) - float(loss))
    # Adam's first step moves a parameter by ~lr sign(g), so a parameter
    # whose g differs in sign near 0 may move apart by up to 2 lr; the
    # moments hold the gradient itself
    d = (got['params'] - p.flat.cpu()).abs()
    dp, moved = float(d.max()), float((d > 1e-5).float().mean())
    dmom = {m: float((got[m] - st[m].flat.cpu()).abs().max())
            / float(st[m].flat.abs().max()) for m in ('mu', 'nu')}
    check(dl <= 1e-6 * abs(float(loss)) and dp <= 2 * TRAIN_LR
          and moved <= 1e-3 and max(dmom.values()) <= 1e-5,
          f'mesh: 2-rank train_step off the single process (loss '
          f'{dl:.3g}, params {dp:.3g}, a share {moved:.3g} past 1e-5, '
          f'moments {dmom})')
    la = res[0][3]['launches']
    check(la['adam_step'] == 1, f'mesh: train rank 0 launches {la}')
    print(f'mesh (b): braai train_step at batch {TRAIN_N} over 2 ranks '
          f'(after a warm-up step): rank seconds {res[0][3]["secs"]:.4f}, '
          f'{res[1][3]["secs"]:.4f} (the all-reduce through the host '
          f'included); single process {one:.4f} s; loss off by {dl:.3g}, '
          f'params by at most {dp:.3g} ({moved:.3g} of them past 1e-5), mu '
          f'and nu by {dmom["mu"]:.3g}, {dmom["nu"]:.3g} of their largest, '
          f'on {name}', flush=True)


def surface_phase(wrappers, name, pipe, targs):
    """The rest of the surface on the card: ``run_sextractor`` on a
    flagship frame with every check image, the archive daemon's round trip
    (the files' bytes unchanged), ``device_profile`` over one slice frame
    (its trace names H1's and H3's launches) and the demo twin. Prints
    each step's host seconds."""
    import json as js
    import numpy as np
    import torch
    from zuds_tpu_torch import core, demo, inputs, night, tracing
    from zuds_tpu_torch.control import archive_daemon
    from zuds_tpu_torch.image import ScienceImage
    from zuds_tpu_torch.sextractor import run_sextractor
    cfg = night.FLAGSHIP
    H, W = cfg.height, cfg.width
    with tempfile.TemporaryDirectory(prefix='chip_smoke_surface_') as d:
        work, _ = inputs.write_night_pairs(
            d, 1, H, W, header_json=Path(__file__).resolve().parent
            / 'tests' / 'data' / 'ztf_real_header.json')
        sci_path, ref_path = work[0].split()
        img = ScienceImage.from_file(sci_path)
        img.device = 'cuda'
        t0 = time.perf_counter()
        res = run_sextractor(img, ['rms', 'segm', 'bkgsub', 'bkg'])
        secs = time.perf_counter() - t0
        cat, rms, segm, bkgsub, bkg = res
        check(len(cat.data) > 0, 'surface: run_sextractor found nothing')
        for tag, prod in (('rms', rms), ('segm', segm), ('bkgsub', bkgsub),
                          ('bkg', bkg)):
            a = np.asarray(prod.data)
            check(a.shape == (H, W) and np.isfinite(a).all(),
                  f'surface: {tag} check image {a.shape}')
        check(int(np.asarray(segm.data).max()) >= 1,
              'surface: empty segmentation')
        try:
            run_sextractor(img, ['aper'])
            check(False, 'surface: an unknown check image did not raise')
        except ValueError:
            pass
        print(f'surface: run_sextractor on a {H}x{W} frame with rms, segm, '
              f'bkgsub and bkg: {len(cat.data)} rows, {secs:.3f} s (host '
              f'clock) on {name}', flush=True)

        # the archive daemon's round trip
        with bound_db(d, 'archive', config=True) as db:
            sess = core.DBSession()
            os.makedirs(db.spool)
            names = []
            for p in (sci_path, ref_path):
                base = os.path.basename(p)
                shutil.copyfile(p, os.path.join(db.spool, base))
                rec = core.record_from_image(ScienceImage.from_file(p),
                                             'sci')
                sess.add(rec)
                names.append(base)
            sess.commit()
            t0 = time.perf_counter()
            tar = archive_daemon.archive_to_cold(sess, os.path.join(d, 'cold'))
            back = archive_daemon.retrieve_from_cold(
                sess, names, os.path.join(d, 'cold'), os.path.join(d, 'back'))
            secs = time.perf_counter() - t0
            check(tar is not None and len(back) == 2,
                  f'surface: archive round trip {tar}, {back}')
            for base, path in zip(names, back):
                check(filecmp.cmp(os.path.join(db.spool, base), path,
                                  shallow=False),
                      f'surface: {base} changed through the cold tier')
            check(archive_daemon.archive_to_cold(
                sess, os.path.join(d, 'cold')) is None,
                'surface: archived twice')
        print(f'surface: archive daemon round trip of 2 flagship frames '
              f'({sum(os.path.getsize(p) for p in back)} bytes) '
              f'{secs:.3f} s, bytes unchanged (host clock) on {name}',
              flush=True)

    # device_profile over one slice frame
    one = [a[:1] for a in targs]
    with tempfile.TemporaryDirectory(prefix='chip_smoke_trace_') as d:
        t0 = time.perf_counter()
        with tracing.device_profile(d) as prof:
            pipe(*one)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with open(os.path.join(d, 'trace.json')) as f:
            events = js.load(f)
        events = events.get('traceEvents', events)
        kernels = [e.get('name', '') for e in events
                   if e.get('cat') == 'kernel']
        nwarp = sum('warp_kernel' in k for k in kernels)
        napply = sum('apply_mma_kernel' in k for k in kernels)
        check(nwarp >= 1 and napply >= 1, f'surface: the trace has {nwarp} '
              f'H1 and {napply} H3 launches of {len(kernels)} kernels')
        busy = sum(e.get('dur', 0) for e in events
                   if e.get('cat') == 'kernel') / 1e3
    print(f'surface: device_profile over one slice frame {secs:.3f} s '
          f'(host clock, the profiler on); the trace holds {len(kernels)} '
          f'kernel launches, H1 {nwarp}, H3 {napply}, {busy:.2f} ms of '
          f'kernel time, on {name}', flush=True)

    # the demo twin on the card
    with tempfile.TemporaryDirectory(prefix='chip_smoke_demo_') as d:
        env = os.environ.pop('ZUDS_CONFIG', None)
        from zuds_tpu_torch import secrets
        secrets._manager.cache = None
        try:
            t0 = time.perf_counter()
            summary = demo.main(d, device='cuda')
            secs = time.perf_counter() - t0
        finally:
            for s in (core.DBSession, core.RefDBSession):
                s.remove()
                s.configure(None)
            secrets._manager.cache = None
            if env is None:
                os.environ.pop('ZUDS_CONFIG', None)
            else:
                os.environ['ZUDS_CONFIG'] = env
        tx, ty, _ = demo.TRANSIENT
        cat = summary['catalog'].data
        good = cat[cat['GOODCUT'] == 1]
        dist = float(np.hypot(good['X_IMAGE'] - 1 - tx,
                              good['Y_IMAGE'] - 1 - ty).min()) \
            if len(good) else float('inf')
        check(dist < 2.0 and summary['topic'] and summary['flux'] > 0,
              f'surface: demo transient {dist:.2f} px from a candidate, '
              f'topic {summary["topic"]}, flux {summary["flux"]}')
        spool = os.path.join(d, 'data', 'alerts', summary['topic'])
        check(len(os.listdir(spool)) == 1, 'surface: demo spooled no alert')
    print(f'surface: demo twin on the card {secs:.2f} s: {len(good)} '
          f'candidates, the transient {dist:.2f} px from one, forced flux '
          f'{summary["flux"]:.0f} +- {summary["fluxerr"]:.0f}, one alert '
          f'spooled (host clock) on {name}', flush=True)


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this check needs one CUDA card')
    from zuds_tpu_torch import inputs, kernels, night
    from zuds_tpu_torch.bench_detect import blend_field, full_graph
    from zuds_tpu_torch.bench_stats import sector_bytes
    from zuds_tpu_torch.constants import BAD_SUM
    from zuds_tpu_torch.kernels import build, launch
    from zuds_tpu_torch.ops import (background, compact, deblend, detect,
                                    measure, resample, subtract)
    from zuds_tpu_torch.parallel import SubtractDetectPipeline

    dev = torch.device('cuda')
    name = card()
    print(f'card: {name}', flush=True)

    t0 = time.perf_counter()
    build.library()
    print(f'build: kernel library built and loaded in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    # ---- the slice: the port's main path, counted -------------------------
    cfg = night.FLAGSHIP
    H, W = cfg.height, cfg.width
    B = 2
    args, planted = inputs.plant_sources(
        inputs.synth_inputs(B, H, W, cfg, seed=0), n=3, flux=2e4, seed=1)
    targs = inputs.to_torch(args, dev)
    pipe = SubtractDetectPipeline(cfg)
    wrappers = kernels.all_wrappers()
    out, launches, first_s = run_counted(pipe, targs, wrappers)
    print(f'slice (deblend=True): first run {first_s * 1e3:.1f} ms for {B} '
          f'frames; kernel launches {launches}', flush=True)
    # the slice takes its stamps as inputs: H7 runs in the host feed (the
    # night below), every other kernel here
    for k, n in launches.items():
        check(n > 0 or k == 'stamp_candidates'
              or k in COADD_ONLY + PAIR_ONLY + ML_ONLY + ZOGY_ONLY
              + TRAIN_ONLY,
              f'kernel {k} was not launched by the main path')
    check(all(launches[k] == n * B for k, n in MEASURE_LAUNCHES.items()),
          f'the measure stage launched {launches} for {B} frames, not '
          f'{MEASURE_LAUNCHES} per frame')
    check(all(launches[k] == n * B for k, n in DETECT_LAUNCHES.items()),
          f'the detect stage launched {launches} for {B} frames, not '
          f'{DETECT_LAUNCHES} per frame')

    submask = out['submask']
    unmasked = submask == 0
    check(bool(torch.isfinite(out['diff'][unmasked]).all()),
          'diff not finite where unmasked')
    check(bool(torch.isfinite(out['rms'][unmasked]).all()),
          'rms not finite where unmasked')
    check(bool((out['fit_stamps_ok'] > 0).all()), 'no stamp survived the fit')
    check_planted(out, planted, 'slice')

    # the deblend's load per frame, from the port's own functions
    loads = []
    for b in range(B):
        load = detect.deblend_load(out['diff'][b], out['rms'][b],
                                   (submask[b] & BAD_SUM) == 0,
                                   nsigma=cfg.nsigma, max_det=cfg.max_det,
                                   det_cap=cfg.det_cap, deb_cap=cfg.deb_cap)
        check(int(load['deblend_overflow'])
              == int(out['det_deblend_overflow'][b]),
              'deblend_load disagrees with the pipeline\'s deblend_overflow')
        loads.append(load)
        print(f'deblend load, slice frame {b}: {int(load["multi_pixels"])} '
              f'multi-cell pixels, {int(load["cells"])} cells, '
              f'{int(load["edges"])} cross-cell edges, deblend_overflow '
              f'{int(load["deblend_overflow"])}', flush=True)

    # ---- the slice with deblend=False, counted, one batch -----------------
    pipe0 = SubtractDetectPipeline(dataclasses.replace(cfg, deblend=False))
    out0, launches0, secs0 = run_counted(pipe0, targs, wrappers)
    print(f'slice (deblend=False): first run {secs0 * 1e3:.1f} ms for {B} '
          f'frames; kernel launches {launches0}', flush=True)
    for k, n in launches0.items():
        check(n > 0 or k in ('deblend_labels', 'stamp_candidates')
              or k in COADD_ONLY + PAIR_ONLY + ML_ONLY + ZOGY_ONLY
              + TRAIN_ONLY,
              f'kernel {k} was not launched with deblend=False')
    check(all(launches0[k] == n * B for k, n in DETECT_LAUNCHES.items()),
          f'the detect stage launched {launches0} with deblend=False')
    check_planted(out0, planted, 'slice deblend=False')

    # the host clock spreads with the host's other load: the median of
    # batches timed one by one, the two modes in turns, ranges beside them
    batch_ms = {True: [], False: []}
    for _ in range(5):
        for mode, p in ((True, pipe), (False, pipe0)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p(*targs)
            torch.cuda.synchronize()
            batch_ms[mode].append((time.perf_counter() - t0) * 1e3 / B)
    for mode, ms in batch_ms.items():
        med = statistics.median(ms)
        print(f'slice (deblend={mode}): {med:.1f} ms/frame, '
              f'{1e3 / med:.2f} frames/s (host clock, median of {len(ms)} '
              f'batches of {B} timed in turns with the other mode, range '
              f'{min(ms):.1f}-{max(ms):.1f}) on {name}', flush=True)

    # the slice with its five whole-frame medians per frame in H8 against
    # the plain medians (~50 small launches each), in turns
    from zuds_tpu_torch.parallel import pipeline as pipeline_mod
    med_ms = {'H8': [], 'plain': []}
    for _ in range(2):
        for mode in ('H8', 'plain'):
            pipeline_mod.frame_median = (background.frame_median
                                         if mode == 'H8' else
                                         background.frame_median_plain)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe(*targs)
            torch.cuda.synchronize()
            med_ms[mode].append((time.perf_counter() - t0) * 1e3 / B)
    pipeline_mod.frame_median = background.frame_median
    for mode, ms in med_ms.items():
        print(f'slice (deblend=True, frame medians {mode}): '
              f'{statistics.median(ms):.1f} ms/frame (median of {len(ms)} '
              f'batches of {B} in turns, range {min(ms):.1f}-{max(ms):.1f}) '
              f'on {name}', flush=True)

    # ---- each kernel against its plain version, at the main path's shapes -
    records = []

    def record(kname, err, ms, plain_ms, bnd, library_ms=None, runs=None,
               per=None, count_as=None):
        # launches: the slice's run, or the night's or the coadd's for the
        # kernels only those paths launch; a mode recorded under a name of
        # its own counts its wrapper's (count_as)
        route, source, replaces = SOURCES[kname]
        n = (runs or launches)[count_as or kname]
        records.append({'name': kname, 'route': route, 'source': source,
                        'replaces': replaces, 'launches': n,
                        'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                        'bound_ms': bnd[0], 'bound_by': bnd[1],
                        'library_ms': library_ms})
        lib = 'none' if library_ms is None else f'{library_ms:.3f} ms'
        per = per or f'{NIGHT_PAIRS if runs else B} frames'
        print(f'{kname}: max abs err {err:.3g}, kernel {ms:.3f} ms, plain '
              f'{plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, share '
              f'{bnd[0] / ms:.1%}), library {lib}; {n} launches on the main '
              f'path ({per}) on {name}', flush=True)

    # ---- the measure stage's kernels on the slice's frame 0 ---------------
    measure_records(out, record, name, targs[0][0].contiguous())

    # ---- the detect stage: H24-H27 against their plain versions ----------
    detect_phase(out, cfg, record, name)

    # ---- the night: FITS pairs -> catalogs through run_night, counted,
    # then the scoring night at ml=True and the db phase --------------------
    night_launches, night_s, night_stats, db_fluxes = night_phase(
        wrappers, name, record)

    # ---- the coadd: FITS epochs -> a stack through from_images, counted ---
    coadd_phase(wrappers, name, record)

    # ---- the reference build: queryref, makeref, scamp, counted ----------
    ref_phase(wrappers, name)

    # ---- the per-pair path: sub.do_one on rotated and unrotated pairs -----
    pair_s = pair_phase(wrappers, name, record, night_s / NIGHT_PAIRS)

    # ---- forced photometry: dophot's call on a flagship subtraction -------
    phot_phase(wrappers, name, db_fluxes)

    # ---- the alert chain and the control plane that feeds it ------------
    check(alert_phase(wrappers, name) > 0, 'alert: no alert was built')

    # ---- the ZOGY subtraction: from_images(method='zogy') on both pairs --
    zogy_phase(wrappers, name, record, pair_s)

    # ---- braai training: make_train_state and train_step, counted --------
    train_phase(wrappers, name, record)

    # ---- the rest of the surface: sextractor, archive, profiler, demo ----
    t0 = time.perf_counter()
    surface_phase(wrappers, name, pipe, targs)
    print(f'phase surface: {time.perf_counter() - t0:.1f} s (host clock) on '
          f'{name}', flush=True)

    # ---- multi-GPU: the mesh at world 1 (NCCL) and 2 ranks (gloo) -------
    t0 = time.perf_counter()
    mesh_phase(wrappers, name, pipe, targs, out,
               statistics.median(batch_ms[True]) * B / 1e3)
    print(f'phase mesh: {time.perf_counter() - t0:.1f} s (host clock) on '
          f'{name}', flush=True)

    # ---- the same path on a small input: card (kernels) vs CPU (plain) ----
    for mode in (False, True, 'watershed'):
        small_card_vs_cpu(mode, dev)

    # H1: smooth sub-pixel displacement (|du|, |dv| <= 2), random 18-bit mask
    gen = torch.Generator(device=dev).manual_seed(0)
    ref = targs[2][0]
    rmask = torch.where(
        torch.rand((H, W), generator=gen, device=dev) < 0.01,
        torch.randint(0, 1 << 18, (H, W), generator=gen, device=dev,
                      dtype=torch.int32), 0).to(torch.int32)
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    u = (xx + smooth_field(H, W, 1.9, 0.3, dev)).contiguous()
    v = (yy + smooth_field(H, W, 1.7, 1.1, dev)).contiguous()
    covb = targs[13][0]
    k = resample.warp_reference(ref, rmask, u, v, covb, cfg.max_shift)
    p = resample.warp_reference_plain(ref, rmask, u, v, covb, cfg.max_shift)
    err = close('warp pixels', k[0], p[0], 3e-5, 5e-3)
    check(torch.equal(k[1], p[1]), 'warp mask differs from the plain version')
    check(torch.equal(k[2], p[2]), 'warp coverage differs')
    again = launch.warp(ref, rmask, u, v, covb, cfg.max_shift)
    check(all(torch.equal(a, b) for a, b in zip(k, again)),
          'warp: two calls differ')
    p64 = resample.warp_reference_plain(ref.double(), rmask, u.double(),
                                        v.double(), covb.double(),
                                        cfg.max_shift)
    e64 = warp_f64('warp pixels', k[0], p[0], p64[0], p[2] > 0)
    del p64, again
    ms = graph_ms(lambda: launch.warp(ref, rmask, u, v, covb,
                                      cfg.max_shift))
    call = cuda_ms(lambda: launch.warp(ref, rmask, u, v, covb,
                                       cfg.max_shift))
    print(f'warp: {H}x{W}: {ms:.4f} ms on the card (graph replay), '
          f'{call:.4f} ms per wrapper call with its host cost; against the '
          f'float64 plain version {e64[0]:.4g} (f32 plain {e64[1]:.4g})',
          flush=True)
    record('warp', err, ms,
           cuda_ms(lambda: resample.warp_reference_plain(
               ref, rmask, u, v, covb, cfg.max_shift), 1, 3),
           warp_bound(H * W, 1))

    # H2: the slice's science frame with its bad-pixel mask
    sci = targs[0][0]
    valid = (submask[0] & BAD_SUM) == 0
    kb = launch.background_cells(sci, valid, cfg.box, 3)
    pb = background.background_cells_plain(sci, valid, cfg.box, 3)
    err = max(close('background back', kb[0], pb[0], 1e-4, 0.0),
              close('background sigma', kb[1], pb[1], 1e-4, 0.0))
    check(torch.equal(kb[2], pb[2]), 'background counts differ')
    check(torch.equal(kb[0], pb[0]) and torch.equal(kb[1], pb[1]),
          'background back or sigma not bit-equal to the plain version')
    # reads the frame and its mask (5 B/px), writes 12 B per cell; ~4
    # sums of the stride-5 subsample per clip pass plus the full pass
    ncell = kb[0].numel()
    ms = graph_ms(lambda: launch.background_cells(sci, valid, cfg.box, 3))
    call = cuda_ms(lambda: launch.background_cells(sci, valid, cfg.box, 3))
    print(f'background_cells: {H}x{W}, {ncell} cells: bit-equal to its '
          f'plain version; {ms:.4f} ms on the card (graph replay), {call:.4f}'
          f' ms per wrapper call with its host cost', flush=True)
    record('background_cells', err, ms,
           cuda_ms(lambda: background.background_cells_plain(
               sci, valid, cfg.box, 3), 1, 3),
           bound(5 * H * W + 12 * ncell, 10 * H * W))

    # H3: the slice's own fitted coefficients on its warped reference
    refw = resample.warp_reference(ref, targs[3][0], *resample.
                                   upsample_mapping(targs[4][0], targs[5][0],
                                                    (H, W), cfg.map_step),
                                   covb, cfg.max_shift)[0]
    coeffs = out['kernel_coeffs'][0]
    basis = [t[0] for t in targs[9:13]]
    km = subtract.apply_kernel_fast(refw, coeffs, *basis, order=cfg.order,
                                    nreg=cfg.nreg)
    pm = subtract.apply_kernel(refw, coeffs, *basis, order=cfg.order,
                               nreg=cfg.nreg)
    err = close('apply model', km, pm, 1e-4, 1e-3)
    # a shape past the flagship's: K = 21, order 5 (Nm = 21, two term
    # tiles), 2x2 regions, on a 512x512 crop, seeded coefficients
    crop = refw[:512, :512].contiguous()
    b21 = inputs.KernelBasis(21, 2.0 / 2.355)
    basis21 = [torch.as_tensor(a, device=dev)
               for a in (b21.gx, b21.gy, b21.sums, b21.b0_2d)]
    rng = np.random.default_rng(5)
    c21 = rng.normal(0, 0.01, (4, b21.nbasis * 21 + 1))
    c21[:, 0] += 1.0
    c21[:, -1] = rng.normal(0, 3, 4)
    c21 = torch.as_tensor(c21, dtype=torch.float32, device=dev)
    err21 = close('apply model K=21 order 5 2x2',
                  subtract.apply_kernel_fast(crop, c21, *basis21, order=5,
                                             nreg=2),
                  subtract.apply_kernel(crop, c21, *basis21, order=5,
                                        nreg=2), 1e-4, 1e-3)
    print(f'apply_model: 512x512 crop, K=21, order 5, 2x2 regions: max abs '
          f'err {err21:.3g}', flush=True)
    kd = subtract.model_kernels(coeffs, *basis, order=cfg.order,
                                nreg=cfg.nreg)
    bg = coeffs[:, -1].contiguous()
    geom = subtract.model_geometry(H, W, order=cfg.order, nreg=cfg.nreg)
    bare_ms = cuda_ms(lambda: launch.apply_model(refw, kd, bg, *geom))
    fast_ms = cuda_ms(lambda: subtract.apply_kernel_fast(
        refw, coeffs, *basis, order=cfg.order, nreg=cfg.nreg))
    plain_ms = cuda_ms(lambda: subtract.apply_kernel(
        refw, coeffs, *basis, order=cfg.order, nreg=cfg.nreg), 1, 3)
    issued, useful = apply_flops(subtract.region_edges(H, cfg.nreg),
                                 subtract.region_edges(W, cfg.nreg),
                                 cfg.ksize, kd.shape[1])
    print(f'apply_model: bare launch {bare_ms:.3f} ms, apply_kernel_fast '
          f'(kd + launch) {fast_ms:.3f} ms, plain {plain_ms:.3f} ms; '
          f'tensor cores {issued / bare_ms / 1e9:.1f} TFLOP/s issued '
          f'({issued:.3g} FLOP: 3xTF32, padded), {useful / bare_ms / 1e9:.1f}'
          f' TFLOP/s useful fp32 ({useful:.3g} FLOP) on {name}', flush=True)
    # fp32 work as three TF32 tensor-core products; reads ref and the
    # region kernels, writes the model
    record('apply_model', err, bare_ms, plain_ms,
           bound(8 * H * W + 4 * kd.numel(), 3 * useful, TF32_FLOP_S))

    # H4: the slice's difference image, noise map and weight mask
    diff, rms = out['diff'][0], out['rms'][0]
    wok = (submask[0] & BAD_SUM) == 0
    ki = detect.matched_filter(diff, rms, wok, cfg.nsigma)
    pi = detect.matched_filter_plain(diff, rms, wok, cfg.nsigma)
    # bit-equal: img (its -0 too), filt and det
    for plane, k_, p_ in zip(('img', 'filt', 'det'), ki, pi):
        check(torch.equal(k_.view(torch.uint8), p_.view(torch.uint8)),
              f'detect_filter {plane} differs from its plain version')
    print(f'detect_filter: img, filt, det bit-equal to the plain version '
          f'({int(pi[2].sum())} detected pixels)', flush=True)
    # reads diff, rms, weight (9 B/px), writes img, filt, det (9 B/px);
    # 9 taps of 2 FLOP
    h4_bnd = bound(18 * H * W, 18 * H * W)
    h4_graph = graph_ms(lambda: detect.matched_filter(diff, rms, wok,
                                                      cfg.nsigma))
    h4_call = cuda_ms(lambda: detect.matched_filter(diff, rms, wok,
                                                    cfg.nsigma))
    print(f'detect_filter: {h4_graph:.4f} ms on the card (graph replay; '
          f'{h4_call:.4f} ms per wrapper call by events; bound '
          f'{h4_bnd[0]:.4f} ms, share {h4_bnd[0] / h4_graph:.1%}) on {name}',
          flush=True)
    record('detect_filter', 0.0, h4_graph,
           cuda_ms(lambda: detect.matched_filter_plain(diff, rms, wok,
                                                       cfg.nsigma)),
           h4_bnd)
    # H5 on the tree's own edge list and H6 on the detection mask: the
    # slice's frame 0 (the record) and a busy blend field at quadrant size
    t0 = time.perf_counter()
    field = blend_field(H, W, BUSY_STARS)
    img = torch.as_tensor(field).to(dev)
    frms = torch.full_like(img, 5.0)
    print(f'blend field: {BUSY_STARS} stars at {H}x{W} made in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    fload = detect.deblend_load(img, frms, **BUSY)
    fmask = detect.matched_filter(img, frms, img == img,
                                  BUSY['nsigma'])[2].reshape(-1)
    g = fload['graph']
    print(f'blend field: {int(fmask.sum())} detected pixels, '
          f'{int(fload["multi_pixels"])} multi-cell pixels, '
          f'{int(fload["cells"])} cells (cap {g["ccap"]}), '
          f'{int(fload["edges"])} cross-cell edges (cap '
          f'{g["e_src"].numel()}), deblend_overflow '
          f'{int(fload["deblend_overflow"])}', flush=True)
    check(int(fmask.sum()) < BUSY['det_cap']
          and int(fload['deblend_overflow']) == 0
          and int(fload['cells']) <= g['ccap'],
          'blend field overflows a capacity')

    def h5_times(g, tag):
        # the tree's int64 edge list as cell_graph gives it, its live count
        e = (g['e_src'], g['e_dst'], g['e_w'])
        L, ccap, rounds = g['L'], g['ccap'], deblend._DEB_ROUNDS
        k = launch.deblend_labels(*e, ccap, L, rounds, g['nedge'])
        check(torch.equal(k, deblend.level_labels_plain(*e, ccap, L,
                                                        rounds)),
              f'deblend_labels differs from its plain version on {tag}')
        check(torch.equal(k, launch.deblend_labels(*e, ccap, L, rounds,
                                                   g['nedge'])),
              f'two deblend_labels calls differ on {tag}')
        # device time by CUDA graph; per wrapper call by events beside it;
        # the floor: one round with no slot read (launch, labels, output)
        ms = graph_ms(lambda: deblend.level_labels(*e, ccap, L, rounds,
                                                   g['nedge']))
        call = cuda_ms(lambda: deblend.level_labels(*e, ccap, L, rounds,
                                                    g['nedge']))
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        floor = graph_ms(lambda: launch.deblend_labels(*e, ccap, L, rounds,
                                                       zero))
        plain = cuda_ms(lambda: deblend.level_labels_plain(*e, ccap, L,
                                                           rounds), 1, 3)
        nedge = min(int(g['nedge']), e[0].numel())
        # reads the live slots once (24 B each: three int64), writes
        # (L, ccap) int32; one pass of integer work per level: an edge
        # test, three jumps
        bnd = bound(24 * nedge + 8 + 4 * L * ccap, L * (nedge + 3 * ccap))
        print(f'deblend_labels on {tag} ({nedge} live slots of '
              f'{e[0].numel()}): bit-equal, two calls equal; device time '
              f'(graph replay) {ms:.4f} ms ({call:.4f} ms per wrapper call '
              f'by events; floor, no slot read, {floor:.4f} ms; bound '
              f'{bnd[0]:.5f} ms, share {bnd[0] / ms:.1%}); plain '
              f'{plain:.3f} ms on {name}', flush=True)
        return ms, plain, bnd

    def h6_times(mask, size, tag, fill=None):
        n = mask.numel()
        fill = n - 1 if fill is None else fill
        kc = launch.compact(mask, size, fill)
        pc = compact.compact_indices_plain(mask, size, fill)
        check(torch.equal(kc[0], pc[0]) and torch.equal(kc[1], pc[1]),
              f'compact differs from torch.nonzero on {tag}')
        # the one PyTorch call of the same function, timed only
        lib = torch.nonzero_static(mask, size=size, fill_value=fill)
        check(torch.equal(lib.reshape(-1), kc[0]), 'nonzero_static disagrees')
        # device time by CUDA graph (a wrapper call's host cost is ~10x
        # the kernel's); per call with its host cost beside it
        ms = graph_ms(lambda: launch.compact(mask, size, fill))
        lib_ms = graph_ms(lambda: torch.nonzero_static(mask, size=size,
                                                       fill_value=fill))
        call_ms = cuda_ms(lambda: launch.compact(mask, size, fill))
        lib_call = cuda_ms(lambda: torch.nonzero_static(
            mask, size=size, fill_value=fill))
        plain = cuda_ms(lambda: compact.compact_indices_plain(mask, size,
                                                              fill))
        # reads the mask once (1 B/entry), writes the indices and count
        bnd = bound(n + 8 * size + 8, n)
        print(f'compact on {tag} ({n} entries, {int(kc[1])} set, size '
              f'{size}): bit-equal to torch.nonzero and nonzero_static; '
              f'device time (graph replay) kernel {ms:.5f} ms, '
              f'nonzero_static {lib_ms:.5f} ms ({lib_ms / ms:.2f}x), bound '
              f'{bnd[0]:.5f} ms (share {bnd[0] / ms:.1%}); per call with '
              f'its host cost kernel {call_ms:.4f} ms, nonzero_static '
              f'{lib_call:.4f} ms; plain {plain:.3f} ms on {name}',
              flush=True)
        return ms, plain, bnd, lib_ms

    h5_times(g, 'the blend field')
    h5_times(full_graph(dev), 'an all-live 65,536-slot graph')
    h6_times(fmask, BUSY['det_cap'], 'the blend field')
    h5_times(loads[1]['graph'], 'slice frame 1')
    ms, plain, bnd = h5_times(loads[0]['graph'], 'slice frame 0')
    record('deblend_labels', 0.0, ms, plain, bnd)
    ms, plain, bnd, lib_ms = h6_times(ki[2].reshape(-1), cfg.det_cap,
                                      'slice frame 0')
    record('compact', 0.0, ms, plain, bnd, lib_ms)
    # H6 at the slice's other call sites (detect.py:279, deblend.py:128 and
    # :141): their masks from one detect_sources call on frame 0
    for mask, size, fill in compact_calls(out, cfg):
        if mask.numel() != H * W:
            h6_times(mask, size, f'slice frame 0, a {mask.numel()}-entry '
                     'call site', fill)
    # and at label_components' capacity: every index of the frame mask
    h6_times(ki[2].reshape(-1), H * W, 'slice frame 0 at size H*W')

    crop_card_vs_cpu(field, dev)

    # H8 on the frame-wide medians of the main path: the stamp selector's
    # whole frame (and its |x - med|), the pipeline's ::4 views with masks
    frame = targs[0][0]
    med = background.frame_median(frame)
    for tag, args_ in (('frame', (frame,)), ('|frame - med|',
                                            (frame, None, med)),
                       ('::4 view, mask', (out['rms'][0][::4, ::4],
                                           valid[::4, ::4])),
                       ('frame, mask with holes', (frame, valid)),
                       ('frame, all masked',
                        (frame, torch.zeros_like(valid)))):
        k_ = launch.frame_median(*args_)
        p_ = background.frame_median_plain(*args_)
        check(torch.equal(k_.isnan(), p_.isnan())
              and torch.equal(torch.nan_to_num(k_), torch.nan_to_num(p_)),
              f'frame_median differs from its plain version on {tag}')
    print('frame_median: bit-equal to its plain version on the frame, '
          '|frame - med|, a ::4 view with its mask, a mask with holes and '
          'an all-masked frame', flush=True)
    n = H * W
    view, vok = out['rms'][0][::4, ::4], valid[::4, ::4]
    ms = graph_ms(lambda: launch.frame_median(frame))
    call = cuda_ms(lambda: launch.frame_median(frame))
    plain = cuda_ms(lambda: background.frame_median_plain(frame), 1, 3)
    view_ms = graph_ms(lambda: launch.frame_median(view, vok))
    view_call = cuda_ms(lambda: launch.frame_median(view, vok))
    scale_ms = cuda_ms(lambda: torch.median(frame))
    # reads the frame once (4 B/px); 13 passes of a compare and an add. The
    # ::4 view moves every 32-byte sector its elements and its mask's lie in
    bnd = bound(4 * n, 26 * n)
    vbnd = bound(sector_bytes(view) + sector_bytes(vok), 26 * view.numel())
    print(f'frame_median: frame {ms:.4f} ms on the card (graph replay; '
          f'{call:.4f} ms per wrapper call; bound {bnd[0]:.4f} ms, share '
          f'{bnd[0] / ms:.1%}), ::4 view with mask {view_ms:.4f} ms (graph '
          f'replay; {view_call:.4f} per call; bound {vbnd[0]:.4f} ms by '
          f'{vbnd[1]}, share {vbnd[0] / view_ms:.1%}), plain {plain:.3f} ms,'
          f' torch.median (exact, for scale) {scale_ms:.3f} ms; '
          f'{night_launches["frame_median"] / NIGHT_PAIRS:.1f} launches per '
          f'night frame', flush=True)
    record('frame_median', 0.0, ms, plain, bnd, runs=night_launches)

    # H7 on the same frame with its H8 medians
    sigma = 1.4826 * background.frame_median(frame, center=med)
    kf, kc = launch.stamp_candidates(frame, med, sigma, 6e4, cfg.stamp // 2
                                     + 1)
    pf, pc = measure.stamp_candidates_plain(frame, med, sigma, 6e4,
                                            cfg.stamp // 2 + 1)
    # H7 writes filt at the candidates only, the one place it is read
    ncand = int(pc.sum())
    check(torch.equal(kc, pc) and torch.equal(kf[kc], pf[pc]),
          'stamp_candidates differs from its plain version')
    print(f'stamp_candidates: bit-equal to its plain version at {H}x{W} '
          f'({ncand} candidates)', flush=True)
    margin = cfg.stamp // 2 + 1
    ms = graph_ms(lambda: launch.stamp_candidates(frame, med, sigma, 6e4,
                                                  margin))
    call = cuda_ms(lambda: launch.stamp_candidates(frame, med, sigma, 6e4,
                                                   margin))
    plain = cuda_ms(lambda: measure.stamp_candidates_plain(
        frame, med, sigma, 6e4, margin), 1, 3)
    scale_ms = cuda_ms(lambda: torch.nn.functional.max_pool2d(
        pf[None, None], 9, 1, 4))
    # reads img (4 B/px), writes cand (1 B/px) and filt at the candidates
    # (4 B each); ~40 operations per pixel
    bnd = bound(5 * n + 4 * ncand, 40 * n)
    print(f'stamp_candidates: {ms:.4f} ms on the card (graph replay; '
          f'{call:.4f} ms per wrapper call by events; bound {bnd[0]:.4f} ms, '
          f'share {bnd[0] / ms:.1%}), plain {plain:.3f} ms, max_pool2d 9x9 '
          f'(for scale) {scale_ms:.3f} ms; '
          f'{night_launches["stamp_candidates"] / NIGHT_PAIRS:.1f} launches '
          f'per night frame', flush=True)
    record('stamp_candidates', 0.0, ms, plain, bnd, runs=night_launches)

    print(json.dumps({'kernels': records}))
    print(f'card: {name}')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
