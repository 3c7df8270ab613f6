#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from the sources in this checkout,
drives the port's main path (``SubtractDetectPipeline``, the quadrant
subtract -> detect slice with the reference's default ``deblend=True``) on
two 3080x3072 ZTF-sized frames from a seed, then the same path with
``deblend=False``, both timed in turns, and holds each kernel against its
plain PyTorch version on the card at the shapes the main path gives it
(H3 also at K = 21, order 5, 2x2 regions, and its bare launch timed with
its tensor-core rate; H5 and H6 also on a quadrant-size busy blend
field). Small inputs run on the
card and on the CPU for each deblend mode, and a 1024^2 crop of the blend
field through ``detect_sources`` on both. Prints the card, per-kernel
errors and times, the slice's ms/frame and the deblend's load, then one
JSON line of kernel records and, last, ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero; a machine without a CUDA card fails at
once.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

FLAGSHIP = dict(height=3080, width=3072, ksize=15, stamp=41, smax=384,
                order=4, nreg=3, max_det=4096, det_cap=1 << 16,
                deb_cap=1 << 16)
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
    'detect_filter': ('triton', 'zuds_tpu_torch/kernels/detect_filter.py',
                      'zuds_tpu/ops/detect.py:607'),
    'deblend_labels': ('cuda', 'zuds_tpu_torch/kernels/deblend.cu',
                       'zuds_tpu/ops/detect.py:487'),
    'compact': ('cuda', 'zuds_tpu_torch/kernels/compact.cu',
                'zuds_tpu/ops/detect.py:86'),
}
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


def blend_field(H, W, nstar, seed=5):
    """tests/test_detect.py's busy blend field (stars of flux 2e3-3e4 and
    sigma 1.5-2.5 px, half with a companion within 6 px, noise 5) at any
    size, in numpy from a seed."""
    import numpy as np
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
    versions). det_n within 1 with deblend=False; with the tree, within 1
    plus twice the CPU's own spread under 1e-7 relative perturbations of
    ``sci`` (the card's diff differs from the CPU's at the ulp level, and
    the tree's splits in noise follow that spread)."""
    import numpy as np
    import torch
    from zuds_tpu_torch import inputs
    from zuds_tpu_torch.parallel import (PipelineConfig,
                                         SubtractDetectPipeline)
    small = PipelineConfig(**SMALL, deblend=mode)
    sargs, splanted = inputs.plant_sources(
        inputs.synth_inputs(2, small.height, small.width, small, seed=0),
        n=3, flux=2e4, seed=1)
    spipe = SubtractDetectPipeline(small)
    on_card = spipe(*inputs.to_torch(sargs, dev))
    on_cpu = spipe(*inputs.to_torch(sargs, 'cpu'))
    spread = np.zeros(2, int)
    if mode is not False:
        for e in (1e-7, -1e-7, 2e-7):
            pert = ((sargs[0] * np.float32(1 + e)).astype('f4'),) + sargs[1:]
            n = spipe(*inputs.to_torch(pert, 'cpu'))['det_n'].numpy()
            spread = np.maximum(spread, np.abs(n - on_cpu['det_n'].numpy()))
    for k, v in on_cpu.items():
        check(tuple(on_card[k].shape) == tuple(v.shape), f'{k}: shape')
    check(torch.equal(on_card['submask'].cpu(), on_cpu['submask']),
          f'small input, deblend={mode!r}: submask differs')
    dn = []
    for b in range(2):
        dn.append(int(on_card['det_n'][b]) - int(on_cpu['det_n'][b]))
        check(abs(dn[-1]) <= 1 + 2 * int(spread[b]),
              f'small input, deblend={mode!r}: detection counts differ by '
              f'{dn[-1]} (CPU spread {int(spread[b])})')
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
          f'(<= 0.01 px); det_n card - CPU {dn}, CPU own spread '
          f'{spread.tolist()}', flush=True)


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


def main():
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this check needs one CUDA card')
    from zuds_tpu_torch import inputs, kernels
    from zuds_tpu_torch.constants import BAD_SUM
    from zuds_tpu_torch.kernels import build, launch
    from zuds_tpu_torch.ops import (background, compact, deblend, detect,
                                    resample, subtract)
    from zuds_tpu_torch.parallel import (PipelineConfig,
                                         SubtractDetectPipeline)

    dev = torch.device('cuda')
    name = card()
    print(f'card: {name}', flush=True)

    t0 = time.perf_counter()
    build.library()
    print(f'build: kernel library built and loaded in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    # ---- the slice: the port's main path, counted -------------------------
    cfg = PipelineConfig(**FLAGSHIP)
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
    for k, n in launches.items():
        check(n > 0, f'kernel {k} was not launched by the main path')

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
    pipe0 = SubtractDetectPipeline(PipelineConfig(**FLAGSHIP, deblend=False))
    out0, launches0, secs0 = run_counted(pipe0, targs, wrappers)
    print(f'slice (deblend=False): first run {secs0 * 1e3:.1f} ms for {B} '
          f'frames; kernel launches {launches0}', flush=True)
    for k, n in launches0.items():
        check(n > 0 or k == 'deblend_labels',
              f'kernel {k} was not launched with deblend=False')
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

    # ---- the same path on a small input: card (kernels) vs CPU (plain) ----
    for mode in (False, True, 'watershed'):
        small_card_vs_cpu(mode, dev)

    # ---- each kernel against its plain version, at the main path's shapes -
    records = []

    def record(kname, err, ms, plain_ms, bnd, library_ms=None):
        route, source, replaces = SOURCES[kname]
        records.append({'name': kname, 'route': route, 'source': source,
                        'replaces': replaces, 'launches': launches[kname],
                        'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                        'bound_ms': bnd[0], 'bound_by': bnd[1],
                        'library_ms': library_ms})
        lib = 'none' if library_ms is None else f'{library_ms:.3f} ms'
        print(f'{kname}: max abs err {err:.3g}, kernel {ms:.3f} ms, plain '
              f'{plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), '
              f'library {lib}; {launches[kname]} launches on the main path '
              f'({B} frames) on {name}', flush=True)

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
    # reads ref, mask, u, v, writes refw, refm, cov: 28 B/px; ~120 FLOP/px
    # (36 weighted taps, 36 weight products, 6 normaliser terms, 12
    # Lanczos weights)
    record('warp', err,
           cuda_ms(lambda: launch.warp(ref, rmask, u, v, covb,
                                       cfg.max_shift)),
           cuda_ms(lambda: resample.warp_reference_plain(
               ref, rmask, u, v, covb, cfg.max_shift), 1, 3),
           bound(28 * H * W, 120 * H * W))

    # H2: the slice's science frame with its bad-pixel mask
    sci = targs[0][0]
    valid = (submask[0] & BAD_SUM) == 0
    kb = launch.background_cells(sci, valid, cfg.box, 3)
    pb = background.background_cells_plain(sci, valid, cfg.box, 3)
    err = max(close('background back', kb[0], pb[0], 1e-4, 0.0),
              close('background sigma', kb[1], pb[1], 1e-4, 0.0))
    check(torch.equal(kb[2], pb[2]), 'background counts differ')
    # reads the frame and its mask (5 B/px), writes 12 B per cell; ~4
    # sums of the stride-5 subsample per clip pass plus the full pass
    ncell = kb[0].numel()
    record('background_cells', err,
           cuda_ms(lambda: launch.background_cells(sci, valid, cfg.box, 3)),
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
    check(torch.equal(ki[0], pi[0]), 'detect_filter img differs')
    err = close('detect_filter filt', ki[1], pi[1], 1e-6, 0.0)
    thr = cfg.nsigma * rms
    edge = (pi[1] - thr).abs() <= 1e-6 * thr.abs()
    ndiff = int((ki[2] != pi[2]).sum())
    nedge_diff = int(((ki[2] != pi[2]) & edge).sum())
    print(f'detect_filter: det differs at {ndiff} pixels, {nedge_diff} '
          f'within 1e-6 of the threshold ({int(edge.sum())} such pixels)',
          flush=True)
    check(ndiff == nedge_diff, 'detect_filter det differs off the threshold')
    # reads diff, rms, weight (9 B/px), writes img, filt, det (9 B/px);
    # 9 taps of 2 FLOP
    record('detect_filter', err,
           cuda_ms(lambda: detect.matched_filter(diff, rms, wok,
                                                 cfg.nsigma)),
           cuda_ms(lambda: detect.matched_filter_plain(diff, rms, wok,
                                                       cfg.nsigma)),
           bound(18 * H * W, 18 * H * W))
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

    def h5_times(load, tag):
        g = load['graph']
        e = [t.to(torch.int32).contiguous() for t in (g['e_src'],
                                                      g['e_dst'], g['e_w'])]
        L, ccap, rounds = g['L'], g['ccap'], deblend._DEB_ROUNDS
        check(torch.equal(launch.deblend_labels(*e, ccap, L, rounds),
                          deblend.level_labels_plain(*e, ccap, L, rounds)),
              f'deblend_labels differs from its plain version on {tag}')
        ms = cuda_ms(lambda: launch.deblend_labels(*e, ccap, L, rounds))
        plain = cuda_ms(lambda: deblend.level_labels_plain(*e, ccap, L,
                                                           rounds), 1, 3)
        print(f'deblend_labels on {tag}: bit-equal, kernel {ms:.4f} ms, '
              f'plain {plain:.3f} ms', flush=True)
        nedge = min(int(load['edges']), e[0].numel())
        # reads the live edges once (12 B each), writes (L, ccap) int32;
        # one pass of integer work per level: an edge test, three jumps
        return ms, plain, bound(12 * nedge + 4 * L * ccap,
                                L * (nedge + 3 * ccap))

    def h6_times(mask, size, tag):
        n = mask.numel()
        kc = launch.compact(mask, size, n - 1)
        pc = compact.compact_indices_plain(mask, size, n - 1)
        check(torch.equal(kc[0], pc[0]) and torch.equal(kc[1], pc[1]),
              f'compact differs from torch.nonzero on {tag}')
        ms = cuda_ms(lambda: launch.compact(mask, size, n - 1))
        plain = cuda_ms(lambda: compact.compact_indices_plain(mask, size,
                                                              n - 1))
        # the one PyTorch call of the same function, timed only
        lib = torch.nonzero_static(mask, size=size, fill_value=n - 1)
        check(torch.equal(lib.reshape(-1), kc[0]), 'nonzero_static disagrees')
        lib_ms = cuda_ms(lambda: torch.nonzero_static(mask, size=size,
                                                      fill_value=n - 1))
        print(f'compact on {tag}: bit-equal to torch.nonzero, kernel '
              f'{ms:.4f} ms, plain {plain:.3f} ms, nonzero_static '
              f'{lib_ms}', flush=True)
        # reads the mask once (1 B/entry), writes the indices and count
        return ms, plain, bound(n + 8 * size + 8, n), lib_ms

    h5_times(fload, 'the blend field')
    h6_times(fmask, BUSY['det_cap'], 'the blend field')
    ms, plain, bnd = h5_times(loads[0], 'slice frame 0')
    record('deblend_labels', 0.0, ms, plain, bnd)
    ms, plain, bnd, lib_ms = h6_times(ki[2].reshape(-1), cfg.det_cap,
                                      'slice frame 0')
    record('compact', 0.0, ms, plain, bnd, lib_ms)

    crop_card_vs_cpu(field, dev)

    print(json.dumps({'kernels': records}))
    print(f'card: {name}')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
