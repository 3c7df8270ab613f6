#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on a CUDA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from the sources in this checkout,
drives the port's main path (``SubtractDetectPipeline``, the quadrant
subtract -> detect slice with ``deblend=False``) on two 3080x3072 ZTF-sized
frames from a seed, and holds each kernel against its plain PyTorch
version on the card at the shapes the main path gives it (H3 also at
K = 21, order 5, 2x2 regions, and its bare launch timed with its
tensor-core rate). Prints the card, per-kernel errors and times, the
slice's ms/frame, then one JSON line of kernel records and, last,
``{"ok": true, "device": {...}}``. Any failed check exits non-zero; a
machine without a CUDA card fails at once.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

FLAGSHIP = dict(height=3080, width=3072, ksize=15, stamp=41, smax=384,
                order=4, nreg=3, max_det=4096, det_cap=1 << 16,
                deb_cap=1 << 16, deblend=False)
# the CPU parity tests' configuration (tests/test_torch_pipeline.py)
SMALL = dict(height=256, width=256, ksize=9, stamp=25, smax=32, order=2,
             nreg=2, max_det=128, box=64, deblend=False)
SOURCES = {
    'warp': ('cuda', 'zuds_tpu_torch/kernels/warp.cu',
             'zuds_tpu/ops/resample.py:275'),
    'background_cells': ('cuda', 'zuds_tpu_torch/kernels/background.cu',
                         'zuds_tpu/ops/background.py:108'),
    'apply_model': ('cuda', 'zuds_tpu_torch/kernels/apply.cu',
                    'tools/bench_apply.py:218'),
    'detect_filter': ('triton', 'zuds_tpu_torch/kernels/detect_filter.py',
                      'zuds_tpu/ops/detect.py:607'),
}


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
    import torch
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    check(bad == 0, f'{name}: {bad} elements past rtol={rtol} atol={atol}'
          f' (max abs err {float(err.max()):.3g})')
    return float(err.max())


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
    from zuds_tpu_torch.ops import background, detect, resample, subtract
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
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe(*targs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f'slice: first run {first_s * 1e3:.1f} ms for {B} frames; kernel '
          f'launches {launches}', flush=True)
    for k, n in launches.items():
        check(n > 0, f'kernel {k} was not launched by the main path')

    submask = out['submask']
    unmasked = submask == 0
    check(bool(torch.isfinite(out['diff'][unmasked]).all()),
          'diff not finite where unmasked')
    check(bool(torch.isfinite(out['rms'][unmasked]).all()),
          'rms not finite where unmasked')
    check(bool((out['fit_stamps_ok'] > 0).all()), 'no stamp survived the fit')
    for b in range(B):
        v = out['det_valid'][b]
        xy = torch.stack([out['det_x'][b][v], out['det_y'][b][v]], 1).cpu()
        for px, py in planted[b]:
            dist = float((xy - torch.tensor([px, py])).norm(dim=1).min()) \
                if len(xy) else float('inf')
            check(dist <= 1.0, f'frame {b}: planted source at ({px:.2f}, '
                  f'{py:.2f}) not recovered (nearest {dist:.2f} px)')
        print(f'slice frame {b}: {int(out["det_n"][b])} detections, '
              f'{int(out["fit_stamps_ok"][b])} stamps kept, 3/3 planted '
              f'sources within 1 px', flush=True)

    # the host clock spreads with the host's other load: the median of
    # batches timed one by one, with the range beside it
    batch_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(*targs)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3 / B)
    ms_frame = statistics.median(batch_ms)
    print(f'slice: {ms_frame:.1f} ms/frame, {1e3 / ms_frame:.2f} frames/s '
          f'(host clock, median of {len(batch_ms)} batches of {B}, range '
          f'{min(batch_ms):.1f}-{max(batch_ms):.1f}) on {name}', flush=True)

    # ---- the same path on a small input: card (kernels) vs CPU (plain) ----
    small = PipelineConfig(**SMALL)
    sargs, splanted = inputs.plant_sources(
        inputs.synth_inputs(2, small.height, small.width, small, seed=0),
        n=3, flux=2e4, seed=1)
    spipe = SubtractDetectPipeline(small)
    on_card = spipe(*inputs.to_torch(sargs, dev))
    on_cpu = spipe(*inputs.to_torch(sargs, 'cpu'))
    for k, v in on_cpu.items():
        check(tuple(on_card[k].shape) == tuple(v.shape), f'{k}: shape')
    check(torch.equal(on_card['submask'].cpu(), on_cpu['submask']),
          'small input: submask differs between card and CPU')
    for b in range(2):
        check(abs(int(on_card['det_n'][b]) - int(on_cpu['det_n'][b])) <= 1,
              'small input: detection counts differ by more than 1')
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
    print('small input (256x256, order 2, 2x2 regions): card and CPU agree '
          'on submask, detection counts (+-1) and the 6 planted sources '
          '(<= 0.01 px)', flush=True)

    # ---- each kernel against its plain version, at the main path's shapes -
    records = []

    def record(kname, err, ms, plain_ms):
        route, source, replaces = SOURCES[kname]
        records.append({'name': kname, 'route': route, 'source': source,
                        'replaces': replaces, 'launches': launches[kname],
                        'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms})
        print(f'{kname}: max abs err {err:.3g}, kernel {ms:.3f} ms, plain '
              f'{plain_ms:.3f} ms on {name}', flush=True)

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
    record('warp', err,
           cuda_ms(lambda: launch.warp(ref, rmask, u, v, covb,
                                       cfg.max_shift)),
           cuda_ms(lambda: resample.warp_reference_plain(
               ref, rmask, u, v, covb, cfg.max_shift), 1, 3))

    # H2: the slice's science frame with its bad-pixel mask
    sci = targs[0][0]
    valid = (submask[0] & BAD_SUM) == 0
    kb = launch.background_cells(sci, valid, cfg.box, 3)
    pb = background.background_cells_plain(sci, valid, cfg.box, 3)
    err = max(close('background back', kb[0], pb[0], 1e-4, 0.0),
              close('background sigma', kb[1], pb[1], 1e-4, 0.0))
    check(torch.equal(kb[2], pb[2]), 'background counts differ')
    record('background_cells', err,
           cuda_ms(lambda: launch.background_cells(sci, valid, cfg.box, 3)),
           cuda_ms(lambda: background.background_cells_plain(
               sci, valid, cfg.box, 3), 1, 3))

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
    record('apply_model', err, bare_ms, plain_ms)

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
    record('detect_filter', err,
           cuda_ms(lambda: detect.matched_filter(diff, rms, wok,
                                                 cfg.nsigma)),
           cuda_ms(lambda: detect.matched_filter_plain(diff, rms, wok,
                                                       cfg.nsigma)))

    print(json.dumps({'kernels': records}))
    print(f'card: {name}')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
