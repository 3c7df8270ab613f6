"""H4 and H7 (``kernels/detect_filter.cu``, ``kernels/stamps.cu``), the
detection stage's matched filter and the stamp selector's candidate
stencil, timed at the main path's shapes.

    python3 zuds_tpu_torch/bench_stencils.py [--root DIR] [--tag NAME]

``--root`` is the checkout whose ``zuds_tpu_torch`` is imported (by
default the one this file sits in), so that two versions of the kernels
are timed by one script on one card: unpack the other version into a
directory and run the script once against each, in turns. H4 and H7 are
reached through ``ops.detect.matched_filter`` and
``kernels.launch.stamp_candidates``, whatever the checkout's kernels are.

Cases at 3080x3072, on seeded inputs:

- ``h4_slice``: the slice's frame of ``inputs.synth_inputs`` (seed 0, the
  flagship configuration): the science minus the reference frame, rms
  5 sqrt 2, every weight good;
- ``h4_holes_nan``: the same with 1% weight holes, 0.1% NaN and 0.01% +inf
  in the difference and 0.1% rms of 0;
- ``h7_selector``: the stamp selector's frame (the slice's science frame)
  at its H8 medians, ``sat`` 6e4, margin 21 (``stamp // 2 + 1``);
- ``h7_crowded``: noise 5 about 150 and 1% of the pixels a source of flux
  10^2.5-10^4.5 blurred by a Gaussian of sigma 1.5 px (some 14% of the
  pixels pass the threshold; nearly every warp has a lane that does);
- ``h7_blank``: noise alone (no candidate).

Each checks the kernel bit-equal to its plain version (H4's three planes;
H7's ``cand`` and ``filt`` at the candidates) and prints one JSON line
(the script exits non-zero at its end if a case differed):

- ``graph_ms``: device time per call, 20 calls captured in one CUDA graph
  and replayed between two CUDA events (no host cost);
- ``call_ms``: per call from Python, CUDA events around 20 calls made back
  to back (the host's cost included);
- ``bound_ms``: the bytes the call must move over 3.35 TB/s (H4: 18 B a
  pixel; H7: 5 B a pixel and 4 B a candidate);
- ``probes``: device time (as ``graph_ms``) of probe builds, where the
  checkout's source has their macro: H4 with other strip heights
  (``-DZUDS_DETECT_ROWS=``; bit-equality checked too) and H7's dense pass
  alone (``-DZUDS_STAMPS_PROBE_NO_PEAKS``: no threshold test, ring, window
  or candidate; not the function).

Then the card's name and power limit, ptxas's registers, spills and
shared memory of the checkout's detect_filter.cu and stamps.cu, and each
of their kernels' SASS instruction count and local-memory instructions
from ``cuobjdump -sass``, where the toolkit has it.
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
import ctypes  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_S = 3.35e12
SLICE = (3080, 3072)
NSIGMA = 1.5
SAT = 6e4
MARGIN = 21
# probe builds: name -> (source, nvcc flag); a probe named in TIMED_ONLY
# is not the function and is timed only
PROBES = {**{f'rows{r}': ('detect_filter.cu', f'-DZUDS_DETECT_ROWS={r}')
             for r in (16, 24, 48)},
          'no_peaks': ('stamps.cu', '-DZUDS_STAMPS_PROBE_NO_PEAKS')}
TIMED_ONLY = ('no_peaks',)


def slice_frames(H, W):
    """The slice's science and reference frames of ``synth_inputs`` (seed
    0, the flagship configuration), f32 numpy."""
    import dataclasses

    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.night import FLAGSHIP
    cfg = dataclasses.replace(FLAGSHIP, height=H, width=W)
    a = inputs.synth_inputs(1, H, W, cfg, 0)
    return a[0][0], a[2][0]


def crowded_field(H, W, seed, density=0.01):
    """Noise 5 about 150 and ``density`` H W point sources blurred by a
    Gaussian of sigma 1.5 px, made on the CPU from a seed."""
    g = torch.Generator().manual_seed(seed)
    img = 150.0 + 5.0 * torch.randn((H, W), generator=g)
    n = int(density * H * W)
    pos = torch.randint(0, H * W, (n,), generator=g)
    flux = 10 ** (2.5 + 2.0 * torch.rand((n,), generator=g))
    pts = torch.zeros(H * W, dtype=torch.float64).index_add_(
        0, pos, flux.double()).float()
    ax = torch.arange(-6, 7, dtype=torch.float32)
    k = torch.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / 4.5)
    blur = torch.nn.functional.conv2d(pts.reshape(1, 1, H, W),
                                      (k / k.sum())[None, None], padding=6)
    return (img + blur[0, 0]).contiguous()


def bits_equal(a, b):
    return bool(torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def probe_builds(root, flags, out_dir):
    """Each probe of PROBES whose macro the checkout's source has, built
    alone into a shared library, all at once. {name: (source, path)}."""
    from zuds_tpu_torch.kernels import build
    kdir = Path(root) / 'zuds_tpu_torch' / 'kernels'
    nvcc = build._nvcc()
    procs = {}
    for name, (src, flag) in PROBES.items():
        macro = flag[2:].split('=')[0]
        if not (kdir / src).exists() or macro not in (kdir / src).read_text():
            continue
        out = Path(out_dir) / f'{name}.so'
        procs[name] = (src, out, subprocess.Popen(
            [nvcc, *flags, flag, '-shared', '-o', str(out), str(kdir / src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (src, out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on probe {name}:\n{err}')
        built[name] = (src, out)
    return built


def load_probe(path, fn):
    from zuds_tpu_torch.kernels import build
    lib = ctypes.CDLL(str(path))
    getattr(lib, fn).argtypes = build.SIGNATURES[fn]
    getattr(lib, fn).restype = ctypes.c_int
    return lib


def probe_filter(lib, diff, rms, wok):
    """launch.detect_filter through a probe build."""
    from zuds_tpu_torch.kernels import build
    H, W = diff.shape
    img = torch.empty_like(diff)
    filt = torch.empty_like(diff)
    det = torch.empty((H, W), dtype=torch.bool, device=diff.device)
    err = lib.zuds_detect_filter(
        diff.data_ptr(), rms.data_ptr(), wok.data_ptr(), H, W, NSIGMA,
        img.data_ptr(), filt.data_ptr(), det.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    build.check(err, 'probe zuds_detect_filter')
    return img, filt, det


def probe_stamps(lib, img, med, sigma):
    """launch.stamp_candidates through a probe build."""
    from zuds_tpu_torch.kernels import build
    H, W = img.shape
    filt = torch.empty_like(img)
    cand = torch.empty((H, W), dtype=torch.bool, device=img.device)
    err = lib.zuds_stamp_candidates(
        img.data_ptr(), H, W, med.data_ptr(), sigma.data_ptr(), SAT, MARGIN,
        filt.data_ptr(), cand.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    build.check(err, 'probe zuds_stamp_candidates')
    return filt, cand


def h4_cases(sci, ref, probes, dev):
    from zuds_tpu_torch.bench_compact import call_ms, graph_ms
    from zuds_tpu_torch.ops import detect
    H, W = sci.shape
    diff = torch.as_tensor(sci - ref, device=dev).contiguous()
    rms = torch.full((H, W), float(np.float32(5.0 * np.sqrt(2.0))),
                     device=dev)
    wok = torch.ones((H, W), dtype=torch.bool, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    u = torch.rand((H, W), generator=g, device=dev)
    holes = (diff.clone(), rms.clone(), u > 0.01)
    holes[0][u < 1e-3] = float('nan')
    holes[0][(u > 0.5) & (u < 0.5001)] = float('inf')
    holes[1][(u > 0.7) & (u < 0.701)] = 0.0
    for tag, (d, r, w) in {'h4_slice': (diff, rms, wok),
                           'h4_holes_nan': holes}.items():
        k = detect.matched_filter(d, r, w, NSIGMA)
        p = detect.matched_filter_plain(d, r, w, NSIGMA)
        rec = {'case': tag, 'shape': [H, W],
               'detected': int(p[2].sum()),
               'bit_equal': all(bits_equal(a, b) for a, b in zip(k, p))}
        rec['graph_ms'] = graph_ms(
            lambda: detect.matched_filter(d, r, w, NSIGMA))
        rec['call_ms'] = call_ms(
            lambda: detect.matched_filter(d, r, w, NSIGMA))
        rec['bound_ms'] = 18 * H * W / HBM_BYTES_S * 1e3
        prec = {}
        for name, (src, lib) in probes.items():
            if src != 'detect_filter.cu':
                continue
            q = probe_filter(lib, d, r, w)
            prec[name] = graph_ms(lambda: probe_filter(lib, d, r, w))
            rec['bit_equal'] &= all(bits_equal(a, b) for a, b in zip(q, p))
        rec['probes'] = prec
        yield rec


def h7_cases(sci, probes, dev):
    from zuds_tpu_torch.bench_compact import call_ms, graph_ms
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import background, measure
    H, W = sci.shape
    g = torch.Generator().manual_seed(6)
    frames = {
        'h7_selector': torch.as_tensor(sci, device=dev).contiguous(),
        'h7_crowded': crowded_field(H, W, 5).to(dev),
        'h7_blank': (150.0 + 5.0 * torch.randn((H, W), generator=g)).to(
            dev)}
    for tag, img in frames.items():
        med = background.frame_median(img)
        sigma = 1.4826 * background.frame_median(img, center=med)
        kf, kc = launch.stamp_candidates(img, med, sigma, SAT, MARGIN)
        pf, pc = measure.stamp_candidates_plain(img, med, sigma, SAT,
                                                MARGIN)
        from zuds_tpu_torch.ops.convolve import DEFAULT_FILTER, conv2_same
        from zuds_tpu_torch.ops.ordered import fma
        thr = fma(torch.tensor(10.0, device=dev), sigma, med)
        ncand = int(pc.sum())
        rec = {'case': tag, 'shape': [H, W], 'candidates': ncand,
               'above_threshold': int((conv2_same(img, DEFAULT_FILTER)
                                       > thr).sum()),
               'bit_equal': bool(torch.equal(kc, pc)
                                 and bits_equal(kf[kc], pf[pc]))}
        rec['graph_ms'] = graph_ms(lambda: launch.stamp_candidates(
            img, med, sigma, SAT, MARGIN))
        rec['call_ms'] = call_ms(lambda: launch.stamp_candidates(
            img, med, sigma, SAT, MARGIN))
        rec['bound_ms'] = (5 * H * W + 4 * ncand) / HBM_BYTES_S * 1e3
        prec = {}
        for name, (src, lib) in probes.items():
            if src != 'stamps.cu':
                continue
            qf, qc = probe_stamps(lib, img, med, sigma)
            prec[name] = graph_ms(lambda: probe_stamps(lib, img, med, sigma))
            if name not in TIMED_ONLY:
                rec['bit_equal'] &= bool(torch.equal(qc, pc)
                                         and bits_equal(qf[qc], pf[pc]))
        rec['probes'] = prec
        yield rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=str(_HERE.parent))
    ap.add_argument('--tag', default='')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit('bench_stencils: no CUDA device')
    sys.path.insert(0, args.root)
    from zuds_tpu_torch.bench_stats import sass_counts
    from zuds_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    print(f'{args.tag}: library built and loaded in '
          f'{time.perf_counter() - t0:.1f} s from {args.root}', flush=True)
    dev = torch.device('cuda')
    t0 = time.perf_counter()
    sci, ref = slice_frames(*SLICE)
    print(f'{args.tag}: slice frames made in {time.perf_counter() - t0:.1f}'
          ' s', flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = {'detect_filter.cu': 'zuds_detect_filter',
               'stamps.cu': 'zuds_stamp_candidates'}
        probes = {name: (src, load_probe(path, fns[src])) for name, (src, path)
                  in probe_builds(args.root, build.FLAGS, tmp).items()}
        differ = []
        for rec in [*h4_cases(sci, ref, probes, dev),
                    *h7_cases(sci, probes, dev)]:
            rec['tag'] = args.tag
            print(json.dumps(rec), flush=True)
            if not rec['bit_equal']:
                differ.append(rec['case'])
    lib_path = Path(build.library()._name)
    print(json.dumps({'tag': args.tag, 'sass': sass_counts(
        lib_path, r'detect_filter|stamp_cand')}), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kdir = Path(args.root) / 'zuds_tpu_torch' / 'kernels'
    for src in ('detect_filter.cu', 'stamps.cu'):
        if (kdir / src).exists():
            report = build.ptxas_report(src)
            print(src, ' '.join(line.strip() for line in report.splitlines()
                                if 'Compiling' in line or 'registers' in line
                                or 'spill' in line), flush=True)
    if differ:
        sys.exit(f'bench_stencils: differs from the plain version: {differ}')


if __name__ == '__main__':
    main()
