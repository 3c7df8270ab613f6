"""H23 and H26 (``kernels/measure.cu``, ``kernels/objects.cu``): the
windowed and Kron refinement and the per-object statistics, timed at the
main path's shapes and at the shapes the other paths give them.

    python3 zuds_tpu_torch/bench_detect.py [--root DIR] [--tag NAME]
        [--out FILE]

``--root`` is the checkout whose ``zuds_tpu_torch`` is imported (by
default the one this file sits in), so that two versions of the kernels
are timed by one script on one card: unpack the other version into a
directory and run the script once against each, in turns. ``--out``
appends the JSON lines to a file as well.

The inputs: the slice's flagship frame 0 (``inputs.synth_inputs`` seed 0
with three planted sources through ``SubtractDetectPipeline`` at
``night.FLAGSHIP``), its diff and rms, its ``max_det`` detection rows and
``detect.detect_taps``' statistics arguments; and a 3080x3072 field of 600
seeded stars (``bench_warp.star_field``) about its sky of 150 counts,
rms 5, whose valid detections stand for a pair catalog's rows (the pair
path measures only the valid rows). Cases:

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
- ``empty``: an empty kernel (one block of 32 threads) under the same
  CUDA graph: the launch floor of a graph's launch.

``probes``: device time of the probe builds, where the checkout's source
has their macros (a probe's result is not the function's): H23 at other
block widths (``-DZUDS_REFINE_THREADS=128/256/512/1024``), H26 stopped
after its first one, two and three launches (``-DZUDS_STATS_PROBE_STOP``)
and with a row pass that only sums the whole windows
(``-DZUDS_STATS_PROBE_ROWS=1``).

Each prints one JSON line: ``graph_ms`` (device time per call, 20 calls
captured in one CUDA graph and replayed between two CUDA events),
``call_ms`` (CUDA events around 20 calls back to back, the host's cost
included), ``bound_ms`` and ``bound_by`` (H23: the bytes of the distinct
work, each distinct row's two 33x33 windows, every row's 24 B of inputs
and 44 B of outputs, over 3.35 TB/s, and its ~135 operations a window
pixel over 67 TFLOP/s fp32, ``all_rows_bound_ms`` the same for every row;
H26: 30 B an entry and 81 B a row, 25 operations an entry and 40 a row).
Then the card's name and power limit, ptxas's registers and spills of the
checkout's measure.cu and objects.cu, and their kernels' SASS and
local-memory instruction counts. The script exits non-zero at its end if
a check failed.
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


def refine_bound(n, distinct):
    """H23's bound: the distinct rows' windows and operations, every
    row's inputs and outputs."""
    return bound(distinct * 2 * CUT * CUT * 4 + n * (24 + 44),
                 distinct * CUT * CUT * REFINE_OPS_PX)


def distinct_rows(args):
    """The number of rows with distinct bits in the six inputs."""
    bits = torch.stack([a.contiguous().view(torch.int32) for a in args], 1)
    return int(torch.unique(bits, dim=0).shape[0])


def build_probes(root, out_dir):
    """Compile each probe whose macro the checkout's source knows, and the
    empty kernel, all at once. Returns ({(source, name): library}, the
    empty kernel's library)."""
    import ctypes
    from zuds_tpu_torch.kernels import build
    kdir = Path(root) / 'zuds_tpu_torch' / 'kernels'
    procs = {}
    for (src, name), extra in PROBES.items():
        macro = extra[0][2:].split('=')[0]
        if macro not in (kdir / src).read_text():
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
    args = ap.parse_args(argv)
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
        libs, empty = build_probes(args.root, tmp)
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
        for rec in refine_cases(cfg, sci, out, dev, libs):
            emit(rec)
        emit(stats_case(cfg, out, libs))
    lib_path = Path(build.library()._name)
    emit({'case': 'sass', 'sass': sass_counts(
        lib_path, r'refine|rank_kernel|offsets|place|tree|rows_kernel')})
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    emit({'case': 'card', 'card': card})
    for src in ('measure.cu', 'objects.cu'):
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
