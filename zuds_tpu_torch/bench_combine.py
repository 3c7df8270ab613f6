"""H3 at one term and H9 (``kernels/apply.cu``, ``kernels/coadd.cu``): the
pair's variance propagation and order-0 model, and the clipped combine of
a stack, timed at the main path's shapes and on deeper stacks.

    python3 zuds_tpu_torch/bench_combine.py [--root DIR] [--tag NAME]
        [--out FILE]

``--root`` is the checkout whose ``zuds_tpu_torch`` is imported (by
default the one this file sits in), so that two versions of the kernels
are timed by one script on one card: unpack the other version into a
directory and run the script once against each, in turns. ``--out``
appends the JSON lines to a file as well.

Cases, on seeded inputs:

- ``h3_variance_K{9,15,31}``, ``h3_model_K{9,15,31}``: H3 at one term on
  a 3080x3072 star field (``bench_warp.star_field``) with 3x3 regions and
  seeded order-0 coefficients: ``launch.apply_model_variance`` on the
  rms squared with the squared centre kernels, ``launch.apply_model``
  with the order-0 model kernels and background. Max abs error against
  the plain version (``propagate_ref_var_plain``, ``apply_kernel``) and
  against the plain version in float64, beside the f32 plain version's
  (gated at rtol 1e-4, atol 1e-3 of the variance's scale or of 1 count,
  but for the model past K = 9);
  ``gemm``: the same launch with a zero second term, which runs the
  tensor-core GEMM of two or more terms (the one-term design before the
  direct kernel), its time (by CUDA events) and its float64 error;
- ``h3_model_nm15``: H3 at the flagship's 15 terms (K = 15, order 4, 3x3
  regions), the output's sha256, to show it bit-identical between two
  checkouts;
- ``h9_N{8,33,50,64}``: H9 on a 3200x3200 canvas of N seeded epochs
  (``deep_stack`` of eight dithered star fields, each at its own zero
  point: noise, cosmic rays, NaN and +-inf at weight > 0, epochs without
  weight), with FLXSCALE; all five outputs against the
  plain version on the first 512 rows, bit-equal (NaN where it has NaN);
- ``h9_nan_order``: a small stack whose pixels hold NaN at weight > 0 at
  and beside the median, epochs without weight and +inf at weight > 0,
  through the kernel and the plain version: the pixels where each output
  differs.

``probes``: device time of H9's probe builds, where the checkout's source
has their macros (a probe's result is not the function's): its loads,
divisions and mask AND only (``-DZUDS_COMBINE_PROBE_LOADS_ONLY``), without
the sorting network (``-DZUDS_COMBINE_PROBE_NO_SORT``) and without the
scaled weights' divisions (``-DZUDS_COMBINE_PROBE_NO_DIV``).

Each prints one JSON line: ``graph_ms`` (device time per call, 20 calls
captured in one CUDA graph and replayed between two CUDA events),
``call_ms`` (CUDA events around 20 calls back to back, the host's cost
included), ``bound_ms`` and ``bound_by`` (the larger of the bytes each
input read once and each output written once over 3.35 TB/s, and the
operations over 67 TFLOP/s fp32: H3 2 K^2 a pixel, its ``tf32_ms`` the
three TF32 products of the GEMM's design over 495 TFLOP/s; H9 the sorting
network's 2 a comparator and 12 a pixel and epoch). Then the card's name
and power limit, ptxas's registers, spills and shared memory of the
checkout's apply.cu and coadd.cu, and each of their kernels' SASS
instruction and local-memory instruction (``LDL``/``STL``) counts from
``cuobjdump -sass``. The script exits non-zero at its end if a gate
failed.
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
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
TF32_FLOP_S = 495e12
SLICE = (3080, 3072)
CANVAS = (3200, 3200)
NREG = 3
BAND = 512
# Batcher's odd-even merge sort pruned to each bucket of 8k keys,
# comparators per bucket (coadd.cu kNetComparators), and H9's other
# operations a pixel and epoch
NET = {8: 19, 16: 63, 24: 132, 32: 191, 40: 305, 48: 384, 56: 464,
       64: 543}
COMBINE_OPS = 12
# probe builds: (source, name) -> extra nvcc flags (built where the
# checkout's source knows the macro)
PROBES = {('coadd.cu', 'loads_only'): ['-DZUDS_COMBINE_PROBE_LOADS_ONLY'],
          ('coadd.cu', 'no_sort'): ['-DZUDS_COMBINE_PROBE_NO_SORT'],
          ('coadd.cu', 'no_div'): ['-DZUDS_COMBINE_PROBE_NO_DIV']}


def bound(nbytes, flop):
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flop / FP32_FLOP_S * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def combine_bound(n, npix):
    """H9's bound on n epochs of npix pixels: 13 B read an epoch and
    pixel, 20 written a pixel; the network and COMBINE_OPS a pixel and
    epoch."""
    cap = next(c for c in sorted(NET) if c >= n)
    return bound((13 * n + 20) * npix + 4 * n,
                 (2 * NET[cap] + COMBINE_OPS * n) * npix)


def same(a, b):
    """Bit-equal, NaN where the other is NaN."""
    if a.is_floating_point():
        if not torch.equal(a.isnan(), b.isnan()):
            return False
        a = a.nan_to_num(0.0).view(torch.int32)
        b = b.nan_to_num(0.0).view(torch.int32)
    return bool(torch.equal(a, b))


def deep_stack(imgs, wgts, masks, cov, n, seed):
    """A stack of n epochs made from the (B, H, W) epochs ``imgs``,
    ``wgts``, ``masks``, ``cov`` (cycled): each with its own seeded noise
    of 5 counts and weight factor in [0.8, 1.2) (a ``torch.Generator``);
    a cosmic ray of 800 counts in every fifth epoch; every seventh epoch
    without weight over a band of 64 rows; NaN and +-inf at weight > 0 on
    rows 100-101 (at the median: in more than half the epochs; and in one
    epoch). Returns contiguous (n, H, W) tensors."""
    B, H, W = imgs.shape
    dev = imgs.device
    g = torch.Generator(device=dev).manual_seed(seed)
    out_i = torch.empty((n, H, W), device=dev)
    out_w = torch.empty_like(out_i)
    out_m = torch.empty((n, H, W), dtype=torch.int32, device=dev)
    out_c = torch.empty((n, H, W), dtype=torch.bool, device=dev)
    for e in range(n):
        b = e % B
        out_i[e] = imgs[b] + 5.0 * torch.randn((H, W), generator=g,
                                                device=dev)
        out_w[e] = wgts[b] * (0.8 + 0.4 * torch.rand((), generator=g,
                                                      device=dev))
        out_m[e] = masks[b]
        out_c[e] = cov[b]
        if e % 5 == 0:
            y, x = (int(v) for v in torch.randint(0, min(H, W), (2,),
                                                  generator=g, device=dev))
            out_i[e, y, x] += 800.0
        if e % 7 == 3:
            y0 = int(torch.randint(0, H - 64, (), generator=g, device=dev))
            out_w[e, y0:y0 + 64] = 0.0
    half = n // 2 + 1
    out_w[:, 100:102, 1000:1016] = 0.01
    out_i[:half, 100, 1000:1008] = float('nan')
    out_i[:half, 100, 1008:1016] = float('inf')
    out_i[n - 1, 101, 1000:1008] = float('nan')
    out_i[n - 1, 101, 1008:1016] = -float('inf')
    return out_i, out_w, out_m, out_c


def base_epochs(B, H, W, seed, dev):
    """B seeded epochs on an (H, W) canvas: a star field of 3080x3072
    dithered inside it, weight about 1/25 there and 0 outside, a mask
    with 1% set pixels, coverage where the epoch lies."""
    from zuds_tpu_torch.bench_warp import seeded_mask, star_field
    imgs = torch.zeros((B, H, W), device=dev)
    wgts = torch.zeros_like(imgs)
    cov = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
    masks = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    h, w = SLICE
    for b in range(B):
        y0, x0 = 40 + 11 * b % 80, 50 + 17 * b % 70
        imgs[b, y0:y0 + h, x0:x0 + w] = torch.as_tensor(
            star_field(h, w, seed + b), device=dev)
        wgts[b, y0:y0 + h, x0:x0 + w] = 0.04
        cov[b, y0:y0 + h, x0:x0 + w] = True
        masks[b] = seeded_mask(H, W, seed + 100 + b, dev)
    return imgs, wgts, masks, cov


def nvcc_variants(root, out_dir):
    """Compile each probe whose macro the checkout's source knows, all at
    once, each into its own shared library. Returns {(source, name):
    loaded library}."""
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
    libs = {}
    for key, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on probe {key}:\n{err}')
        lib = ctypes.CDLL(str(out))
        lib.zuds_clipped_combine.argtypes = \
            build.SIGNATURES['zuds_clipped_combine']
        lib.zuds_clipped_combine.restype = ctypes.c_int
        libs[key] = lib
    return libs


def variant_combine(lib, imgs, w, m, c, scales):
    """H9 through a probe build of coadd.cu."""
    from zuds_tpu_torch.constants import MASK_BIT_NODATA_ALIGN
    from zuds_tpu_torch.kernels import launch
    N, H, W = imgs.shape
    outs = [torch.empty((H, W), dtype=dt, device=imgs.device)
            for dt in (torch.float32, torch.float32, torch.int32,
                       torch.int32, torch.int32)]
    err = lib.zuds_clipped_combine(
        *(launch._ptr(t) for t in (imgs, w, m, c, scales)),
        *(launch._ptr(t) for t in outs), N, H * W, 4.0, 0.3,
        MASK_BIT_NODATA_ALIGN, launch._stream())
    if err:
        raise RuntimeError(f'probe zuds_clipped_combine: CUDA error {err}')
    return outs


def _timed(rec, fn):
    from zuds_tpu_torch.bench_compact import call_ms, graph_ms
    try:
        rec['graph_ms'] = graph_ms(fn)
    except RuntimeError as e:    # a launcher that cannot be captured
        rec['graph_ms'], rec['graph_error'] = None, str(e)[:200]
        torch.cuda.synchronize()
    rec['call_ms'] = call_ms(fn)


def h3_cases(dev):
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.bench_warp import star_field
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import subtract
    from zuds_tpu_torch.bench_compact import call_ms
    H, W = SLICE
    ref = torch.as_tensor(star_field(H, W, 3), device=dev)
    rms = (3.0 + ref.abs().sqrt() / 10.0).contiguous()
    R2 = NREG * NREG
    for K in (9, 15, 31):
        b = inputs.KernelBasis(K, seeing_sigma=K / 10.0)
        tables = [torch.as_tensor(a, device=dev)
                  for a in (b.gx, b.gy, b.sums, b.b0_2d)]
        rng = np.random.default_rng(K)
        c = rng.normal(0, 0.01, (R2, b.nbasis + 1))
        c[:, 0] += 1.0
        c[:, -1] = rng.normal(0, 3, R2)
        coeffs = torch.as_tensor(c, dtype=torch.float32, device=dev)
        cx, cy, pexp, qexp, wx, wy = subtract.model_geometry(
            H, W, order=0, nreg=NREG)
        for kind in ('variance', 'model'):
            if kind == 'variance':
                kerns = subtract.center_kernels(coeffs, *tables, order=0,
                                                nreg=NREG)
                src = (rms ** 2).contiguous()
                kd = (kerns ** 2).reshape(R2, 1, K, K).contiguous()
                bg = torch.zeros(R2, device=dev)

                def plain(dtype=torch.float32):
                    return subtract.propagate_ref_var_plain(
                        rms.to(dtype), kerns.to(dtype))
            else:
                src = ref
                kd = subtract.model_kernels(coeffs, *tables, order=0,
                                            nreg=NREG)
                bg = coeffs[:, -1].contiguous()

                def plain(dtype=torch.float32):
                    return subtract.apply_kernel(
                        ref.to(dtype), coeffs.to(dtype),
                        *(t.to(dtype) for t in tables), order=0, nreg=NREG)

            def kernel():
                return launch.apply_model(src, kd, bg, cx, cy, pexp, qexp,
                                          wx, wy)
            # the GEMM of two or more terms with a zero second term
            kd2 = torch.cat([kd, torch.zeros_like(kd)], 1).contiguous()

            def gemm():
                return launch.apply_model(src, kd2, bg, cx, cy, (0, 1),
                                          (0, 0), wx, wy)
            k = kernel()
            p = plain()
            p64 = plain(torch.float64)
            scale = float(p.abs().max())
            err = float((k - p).abs().max())
            rec = {'case': f'h3_{kind}_K{K}', 'shape': [H, W], 'K': K,
                   'max_abs_err': err, 'scale': scale,
                   'gate_ok': bool(((k - p).abs() <= 1e-3 * (
                       scale if kind == 'variance' else 1.0)
                       + 1e-4 * p.abs()).all()),
                   'f64_err': float((k.double() - p64).abs().max()),
                   'plain_f64_err': float((p.double() - p64).abs().max()),
                   'repeat_equal': bool(torch.equal(kernel(), k))}
            g2 = gemm()
            rec['gemm_f64_err'] = float((g2.double() - p64).abs().max())
            rec['gemm_ms'] = call_ms(gemm)
            del g2, p64
            _timed(rec, kernel)
            rec['plain_ms'] = call_ms(plain, 1, 3)
            bnd = bound(8 * H * W + 4 * kd.numel() + 4 * R2,
                        2 * K * K * H * W)
            rec['bound_ms'], rec['bound_by'] = bnd
            rec['tf32_ms'] = 3 * 2 * K * K * H * W / TF32_FLOP_S * 1e3
            # the model past K = 9 on this field's brightest stars sits at
            # the edge of the gate in any f32 form: printed, not gated
            rec['ok'] = rec['repeat_equal'] and (
                rec['gate_ok'] or (kind == 'model' and K > 9))
            yield rec
    # the flagship's fifteen terms: bit-identical between checkouts
    b = inputs.KernelBasis(15, seeing_sigma=2.0 / 2.355)
    tables = [torch.as_tensor(a, device=dev)
              for a in (b.gx, b.gy, b.sums, b.b0_2d)]
    rng = np.random.default_rng(15)
    c = rng.normal(0, 0.01, (R2, b.nbasis * 15 + 1))
    c[:, 0] += 1.0
    c[:, -1] = rng.normal(0, 3, R2)
    coeffs = torch.as_tensor(c, dtype=torch.float32, device=dev)

    def nm15():
        return subtract.apply_kernel_fast(ref, coeffs, *tables, order=4,
                                          nreg=NREG)
    k = nm15()
    rec = {'case': 'h3_model_nm15', 'shape': [H, W], 'K': 15,
           'sha256': hashlib.sha256(k.cpu().numpy().tobytes()).hexdigest(),
           'repeat_equal': bool(torch.equal(nm15(), k))}
    _timed(rec, nm15)
    rec['ok'] = rec['repeat_equal']
    yield rec


def h9_cases(dev, libs):
    from zuds_tpu_torch.bench_compact import graph_ms
    from zuds_tpu_torch.constants import MASK_BIT_NODATA_ALIGN
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import coadd
    H, W = CANVAS
    imgs, w, m, c = base_epochs(8, H, W, 40, dev)
    # each epoch at its own zero point: FLXSCALE brings it back
    g = torch.Generator(device=dev).manual_seed(41)
    scales8 = 0.5 + torch.rand(8, generator=g, device=dev)
    base = (imgs / scales8[:, None, None], w * scales8[:, None, None] ** 2,
            m, c)
    del imgs, w, m, c
    for n in (8, 16, 33, 50, 64):
        imgs, w, m, c = deep_stack(*base, n, 500 + n)
        scales = scales8[torch.arange(n, device=dev) % 8].contiguous()

        def kernel():
            return launch.clipped_combine(imgs, w, m, c, scales, 4.0, 0.3,
                                          MASK_BIT_NODATA_ALIGN)
        k = kernel()
        p = coadd.clipped_combine_plain(imgs[:, :BAND], w[:, :BAND],
                                        m[:, :BAND], c[:, :BAND], scales)
        equal = {key: same(k[key][:BAND], p[key]) for key in p}
        rec = {'case': f'h9_N{n}', 'shape': [n, H, W], 'band_rows': BAND,
               'bit_equal': equal,
               'nan_coadd': int(k['coadd'].isnan().sum()),
               'clipped': int((k['nclip'] > 0).sum())}
        _timed(rec, kernel)
        rec['bound_ms'], rec['bound_by'] = combine_bound(n, H * W)
        rec['probes'] = {name: graph_ms(
            lambda: variant_combine(lib, imgs, w, m, c, scales))
            for (s_, name), lib in libs.items() if s_ == 'coadd.cu'}
        rec['ok'] = all(equal.values())
        del k, p, imgs, w, m, c
        torch.cuda.empty_cache()
        yield rec


def nan_order_case(dev):
    """Pixels with NaN at weight > 0 at and beside the median, epochs
    without weight, +inf at weight > 0: the kernel against the plain
    version."""
    from zuds_tpu_torch.constants import MASK_BIT_NODATA_ALIGN
    from zuds_tpu_torch.kernels import launch
    from zuds_tpu_torch.ops import coadd
    nan, inf = float('nan'), float('inf')
    cols = [[1.0, nan, nan], [nan, 1.0, 2.0], [nan, 2.0, 1.0],
            [1.0, 2.0, nan], [nan, nan, 1.0], [inf, 5.0, 3.0],
            [5.0, inf, inf]]
    valid = [[1, 1, 1], [1, 1, 0], [1, 1, 1], [1, 1, 1], [1, 1, 1],
             [1, 0, 1], [0, 1, 1]]
    imgs = torch.tensor(cols, device=dev).T.reshape(3, 1, -1).contiguous()
    w = 0.04 * torch.tensor(valid, dtype=torch.float32,
                            device=dev).T.reshape(3, 1, -1).contiguous()
    m = torch.zeros(imgs.shape, dtype=torch.int32, device=dev)
    c = torch.ones(imgs.shape, dtype=torch.bool, device=dev)
    k = launch.clipped_combine(imgs, w, m, c, None, 4.0, 0.3,
                               MASK_BIT_NODATA_ALIGN)
    p = coadd.clipped_combine_plain(imgs, w, m, c)
    diff = {}
    for key in p:
        a, b = k[key][0], p[key][0]
        if a.is_floating_point():
            d = ~((a == b) | (a.isnan() & b.isnan()))
        else:
            d = a != b
        diff[key] = [int(i) for i in torch.nonzero(d).flatten()]
    rec = {'case': 'h9_nan_order', 'pixels': len(cols), 'differ': diff,
           'kernel_coadd': [float(v) for v in k['coadd'][0]],
           'plain_coadd': [float(v) for v in p['coadd'][0]]}
    rec['ok'] = not any(diff.values())
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=str(_HERE.parent))
    ap.add_argument('--tag', default='')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit('bench_combine: no CUDA device')
    sys.path.insert(0, args.root)
    from zuds_tpu_torch.bench_stats import sass_counts
    from zuds_tpu_torch.kernels import build
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
        libs = nvcc_variants(args.root, tmp)
        print(f'{args.tag}: {len(libs)} probe builds in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
        emit(nan_order_case(dev))
        for rec in h3_cases(dev):
            emit(rec)
        for rec in h9_cases(dev, libs):
            emit(rec)
    lib_path = Path(build.library()._name)
    emit({'case': 'sass', 'sass': sass_counts(
        lib_path, r'apply|combine')})
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    emit({'case': 'card', 'card': card})
    for src in ('apply.cu', 'coadd.cu'):
        report = build.ptxas_report(src)
        emit({'case': f'ptxas_{src}', 'report': [
            line.strip() for line in report.splitlines()
            if 'Compiling' in line or 'registers' in line
            or 'spill' in line]})
    if sink:
        sink.close()
    if failed:
        sys.exit(f'bench_combine: gates failed: {failed}')


if __name__ == '__main__':
    main()
