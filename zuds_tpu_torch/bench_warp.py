"""H1 and H10 (``kernels/warp.cu``), the Lanczos-3 warps, timed at the main
path's shapes, with the probes that price their parts.

    python3 zuds_tpu_torch/bench_warp.py [--root DIR] [--tag NAME]

``--root`` is the checkout whose ``zuds_tpu_torch`` is imported (by
default the one this file sits in), so that two versions of the warps are
timed by one script on one card: unpack the other version into a directory
and run the script once against each, in turns.

Three cases, each on seeded inputs (a star field with noise, a 1% 18-bit
mask): H1 at the slice's 3080x3072 frame (window 2, the smooth
|du|, |dv| <= 2 field of ``chip_smoke.py``), H1 with two planes at the
stack's 3200x3200 canvas (pixels and a weight map, a 1.5 px field), and
H10 on the 0.5 degree pair's mapping at 3080x3072 (one plane and a mask;
and with a second plane). For each it checks the kernel against the plain
version (pixels rtol 3e-5, atol 5e-3; mask and coverage equal), prints the
largest error of the kernel and of the f32 plain version against the plain
version run in float64, and one JSON line:

- ``graph_ms``: device time per call, 20 calls captured in one CUDA graph
  and replayed between two CUDA events (no host cost);
- ``call_ms``: per call from Python, CUDA events around 20 calls made back
  to back (the host's cost included); both timed as ``bench_compact.py``
  times H6;
- ``bound_ms``: the bytes each output pixel needs (inputs read once,
  outputs written once) over 3.35 TB/s;
- ``probes``: device time of variants of ``warp.cu`` compiled only here,
  with ``-D`` flags that the library never sets (where the checkout's
  source has them): the 36 weights held constant (prices the gathers),
  H1 without its mask path (H10 without a mask is its library instance),
  and a copy kernel that reads and writes the same bytes (the byte floor
  on this card); beside each (but the copy) its largest error against the
  float64 plain version.

Then the card's name and power limit, ptxas's registers and spills of the
checkout's ``warp.cu``, and each kernel's SASS instruction count (all,
and ``MUFU`` ones: the special-function unit's sine and reciprocal) from
``cuobjdump -sass``, where the toolkit has it.
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
import re  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_S = 3.35e12
SLICE = (3080, 3072)
STACK = (3200, 3200)
WINDOW = 2                  # PipelineConfig.max_shift
PAIR_ROT = 0.5              # degrees
# probe builds of warp.cu: name -> extra nvcc flags
PROBES = {'const_weights': ['-DZUDS_WARP_PROBE_CONST_WEIGHTS'],
          'no_mask': ['-DZUDS_WARP_PROBE_NO_MASK'],
          'copy': ['-DZUDS_WARP_PROBE_COPY']}


def star_field(H, W, seed, nstar=600):
    """Noise 5 about 150 counts and ``nstar`` Gaussian stars of flux
    1e3-1e5, sigma 1.2-2.5 px, f32."""
    rng = np.random.default_rng(seed)
    img = 150.0 + 5.0 * rng.standard_normal((H, W))
    r = 10
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    for _ in range(nstar):
        x0, y0 = rng.uniform(r, W - r - 1), rng.uniform(r, H - r - 1)
        ix, iy = int(x0), int(y0)
        s = rng.uniform(1.2, 2.5)
        flux = 10 ** rng.uniform(3, 5)
        g = np.exp(-((xx + ix - x0) ** 2 + (yy + iy - y0) ** 2)
                   / (2 * s * s))
        img[iy - r:iy + r + 1, ix - r:ix + r + 1] += flux * g / g.sum()
    return img.astype(np.float32)


def seeded_mask(H, W, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    bits = torch.randint(0, 1 << 18, (H, W), generator=g, device=dev,
                         dtype=torch.int32)
    return torch.where(torch.rand((H, W), generator=g, device=dev) < 0.01,
                       bits, 0).to(torch.int32)


def smooth_mapping(H, W, amp_u, amp_v, dev):
    """chip_smoke.py's smooth field: x + amp sin(x / 410 + p) cos(y / 530 -
    p), and the same for y."""
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]

    def field(amp, p):
        return amp * torch.sin(xx / 410.0 + p) * torch.cos(yy / 530.0 - p)
    return ((xx + field(amp_u, 0.3)).contiguous(),
            (yy + field(amp_v, 1.1)).contiguous())


def rotated_mapping(H, W, deg, dev):
    """A rotation by ``deg`` about the frame's centre, and a sub-pixel
    offset."""
    yy = torch.arange(H, device=dev, dtype=torch.float64)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float64)[None, :]
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    xc, yc = (W - 1) / 2, (H - 1) / 2
    u = c * (xx - xc) - s * (yy - yc) + xc + 0.37
    v = s * (xx - xc) + c * (yy - yc) + yc - 0.21
    return (u.to(torch.float32).contiguous(),
            v.to(torch.float32).contiguous())


def close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    if bad:
        raise AssertionError(f'{name}: {bad} elements past rtol={rtol} '
                             f'atol={atol} (max abs err {float(err.max())})')
    return float(err.max())


def err64(got, want64, covered):
    return float((got.double() - want64).abs()[covered].max())


def nvcc_variants(root, flags, out_dir):
    """Compile the checkout's warp.cu once per probe, all at once, each into
    its own shared library. Returns {name: path} for the probes the source
    knows (a source without the probe macros builds none)."""
    kdir = Path(root) / 'zuds_tpu_torch' / 'kernels'
    src = (kdir / 'warp.cu').read_text()
    from zuds_tpu_torch.kernels import build
    nvcc = build._nvcc()
    procs = {}
    for name, extra in PROBES.items():
        macro = extra[0][2:].split('=')[0]
        if macro not in src:
            continue
        out = Path(out_dir) / f'warp_{name}.so'
        procs[name] = (out, subprocess.Popen(
            [nvcc, *flags, *extra, '-shared', '-o', str(out),
             str(kdir / 'warp.cu')], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on probe {name}:\n{err}')
        built[name] = out
    return built


def load_variant(path):
    from zuds_tpu_torch.kernels import build
    lib = ctypes.CDLL(str(path))
    for fn in ('zuds_warp', 'zuds_warp_gather'):
        getattr(lib, fn).argtypes = build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    if hasattr(lib, 'zuds_warp_probe_copy'):
        P = ctypes.c_void_p
        lib.zuds_warp_probe_copy.argtypes = (P,) * 9 + (ctypes.c_longlong, P)
        lib.zuds_warp_probe_copy.restype = ctypes.c_int
    return lib


def _p(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def variant_warp(lib, ref, mask, u, v, covb, window, ref2, outs):
    err = lib.zuds_warp(_p(ref), _p(ref2), _p(mask), _p(u), _p(v), _p(covb),
                        _p(outs[0]), _p(outs[1] if ref2 is not None else None),
                        _p(outs[2]), _p(outs[3]), ref.shape[0], ref.shape[1],
                        window, _stream())
    if err:
        raise RuntimeError(f'probe zuds_warp: CUDA error {err}')


def variant_gather(lib, img, mask, u, v, img2, outs):
    Hs, Ws = img.shape
    Ho, Wo = u.shape
    err = lib.zuds_warp_gather(_p(img), _p(img2), _p(mask), _p(u), _p(v),
                               _p(outs[0]), _p(outs[1]), _p(outs[2]),
                               _p(outs[3]), Hs, Ws, Ho, Wo, _stream())
    if err:
        raise RuntimeError(f'probe zuds_warp_gather: CUDA error {err}')


def copy_probe(lib, planes_in, planes_out):
    a, b, c, d, e = planes_in
    o1, o2, o3, o4 = planes_out
    err = lib.zuds_warp_probe_copy(_p(a), _p(b), _p(c), _p(d), _p(e), _p(o1),
                                   _p(o2), _p(o3), _p(o4), a.numel(),
                                   _stream())
    if err:
        raise RuntimeError(f'probe copy: CUDA error {err}')


def sass_counts(so):
    """{kernel: (instructions, MUFU instructions)} of a shared library, from
    ``cuobjdump -sass``; {} without the tool."""
    from zuds_tpu_torch.kernels import build
    tool = Path(build._nvcc()).with_name('cuobjdump')
    if not tool.exists():
        return {}
    out = subprocess.run([str(tool), '-sass', str(so)], capture_output=True,
                         text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
        elif name and re.search(r'/\*[0-9a-f]{4,}\*/\s+\S', line):
            counts[name][0] += 1
            if 'MUFU' in line:
                counts[name][1] += 1
    return {k: tuple(v) for k, v in counts.items() if 'warp' in k}


def h1_case(tag, launch, resample, libs, dev, shape, two, seed):
    from zuds_tpu_torch.bench_compact import call_ms, graph_ms
    H, W = shape
    ref = torch.as_tensor(star_field(H, W, seed), device=dev)
    mask = seeded_mask(H, W, seed + 1, dev)
    amp = (1.5, 1.5) if two else (1.9, 1.7)
    u, v = smooth_mapping(H, W, *amp, dev)
    covb = torch.tensor([16.0, W - 17.0, 16.0, H - 17.0], device=dev)
    ref2 = None
    if two:
        g = torch.Generator(device=dev).manual_seed(seed + 2)
        ref2 = (0.01 + 0.04 * torch.rand((H, W), generator=g, device=dev))
        ref2 = torch.where(mask > 0, 0.0, ref2).contiguous()
    k = launch.warp(ref, mask, u, v, covb, WINDOW, ref2=ref2)
    if two:
        p = resample.warp_epoch_plain(ref, ref2, mask, u, v, covb, WINDOW)
        kp, km, kc = k[0], k[2], k[3] > 0
        pp, pm, pc = p[0], p[2], p[3]
        p64 = resample.warp_epoch_plain(ref.double(), ref2.double(), mask,
                                        u.double(), v.double(),
                                        covb.double(), WINDOW)
        close(f'{tag} weight plane', torch.clamp(k[1], min=0.0), p[1], 3e-5,
              1e-6)
    else:
        p = resample.warp_reference_plain(ref, mask, u, v, covb, WINDOW)
        kp, km, kc = k
        pp, pm, pc = p
        p64 = resample.warp_reference_plain(ref.double(), mask, u.double(),
                                            v.double(), covb.double(), WINDOW)
    err = close(f'{tag} pixels', kp, pp, 3e-5, 5e-3)
    if not (torch.equal(km, pm) and torch.equal(kc, pc)):
        raise AssertionError(f'{tag}: mask or coverage differs from the plain '
                             'version')
    covered = pc > 0
    rec = {'case': tag, 'shape': [H, W], 'planes': 2 if two else 1,
           'max_abs_err': err, 'err64_kernel': err64(kp, p64[0], covered),
           'err64_plain': err64(pp, p64[0], covered)}
    again = launch.warp(ref, mask, u, v, covb, WINDOW, ref2=ref2)
    rec['repeat_bit_equal'] = all(torch.equal(a, b) for a, b in zip(k, again))
    rec['graph_ms'] = graph_ms(lambda: launch.warp(ref, mask, u, v, covb,
                                                   WINDOW, ref2=ref2))
    rec['call_ms'] = call_ms(lambda: launch.warp(ref, mask, u, v, covb, WINDOW,
                                                 ref2=ref2))
    nbytes = (36 if two else 28) * H * W
    rec['bound_ms'] = nbytes / HBM_BYTES_S * 1e3
    outs = [torch.empty_like(ref), torch.empty_like(ref),
            torch.empty_like(mask), torch.empty_like(ref)]
    probes = {}
    for name, lib in libs.items():
        if name == 'copy':
            fn = (lambda: copy_probe(lib, (u, v, ref, mask, ref2),
                                     (outs[0], outs[1] if two else None,
                                      outs[2], outs[3])))
        else:
            fn = (lambda lib=lib: variant_warp(lib, ref, mask, u, v, covb,
                                               WINDOW, ref2, outs))
        probes[name] = graph_ms(fn)
        if name != 'copy':
            fn()
            probes[name + '_err64'] = err64(outs[0], p64[0], covered)
    rec['probes'] = probes
    return rec


def h10_case(tag, launch, resample, libs, dev, seed):
    from zuds_tpu_torch.bench_compact import call_ms, graph_ms
    H, W = SLICE
    img = torch.as_tensor(star_field(H, W, seed), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    img2 = (4.0 + torch.rand((H, W), generator=g, device=dev)).contiguous()
    mask = seeded_mask(H, W, seed + 1, dev)
    u, v = rotated_mapping(H, W, PAIR_ROT, dev)
    k = launch.warp_gather(img, mask, u, v)
    (pp,), pm, pc = resample._gather_plain([img], mask, u, v)
    err = close(f'{tag} pixels', k[0], pp, 3e-5, 5e-3)
    if not (torch.equal(k[2], pm) and torch.equal(k[3], pc)):
        raise AssertionError(f'{tag}: mask or coverage differs from the plain '
                             'version')
    k2 = launch.warp_gather(img, mask, u, v, img2=img2)
    (_, pb), _, _ = resample._gather_plain([img, img2], mask, u, v)
    close(f'{tag} second plane', k2[1], pb, 3e-5, 5e-3)
    if not torch.equal(k2[0], k[0]):
        raise AssertionError(f'{tag}: the two-plane launch differs on its '
                             'first plane')
    (p64,), _, _ = resample._gather_plain([img.double()], None, u.double(),
                                          v.double())
    covered = pc > 0
    rec = {'case': tag, 'shape': [H, W], 'planes': 1, 'max_abs_err': err,
           'err64_kernel': err64(k[0], p64, covered),
           'err64_plain': err64(pp, p64, covered)}
    again = launch.warp_gather(img, mask, u, v)
    rec['repeat_bit_equal'] = all(
        torch.equal(a, b) for a, b in zip(k, again) if a is not None)
    rec['graph_ms'] = graph_ms(lambda: launch.warp_gather(img, mask, u, v))
    rec['call_ms'] = call_ms(lambda: launch.warp_gather(img, mask, u, v))
    rec['graph_ms_two_planes'] = graph_ms(
        lambda: launch.warp_gather(img, mask, u, v, img2=img2))
    rec['bound_ms'] = 28 * H * W / HBM_BYTES_S * 1e3
    rec['bound_ms_two_planes'] = 36 * H * W / HBM_BYTES_S * 1e3
    outs = [torch.empty_like(img), torch.empty_like(img),
            torch.empty_like(mask), torch.empty_like(img)]
    probes = {'no_mask': graph_ms(lambda: launch.warp_gather(img, None, u,
                                                             v))}
    for name, lib in libs.items():
        if name == 'no_mask':
            continue
        if name == 'copy':
            fn = (lambda: copy_probe(lib, (u, v, img, mask, None),
                                     (outs[0], None, outs[2], outs[3])))
        else:
            fn = (lambda lib=lib: variant_gather(lib, img, mask, u, v, None,
                                                 [outs[0], None, outs[2],
                                                  outs[3]]))
        probes[name] = graph_ms(fn)
        if name != 'copy':
            fn()
            probes[name + '_err64'] = err64(outs[0], p64, covered)
    rec['probes'] = probes
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=str(_HERE.parent))
    ap.add_argument('--tag', default='')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit('bench_warp: no CUDA device')
    sys.path.insert(0, args.root)
    from zuds_tpu_torch.kernels import build, launch
    from zuds_tpu_torch.ops import resample
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.library()
    print(f'{args.tag}: library built and loaded in '
          f'{time.perf_counter() - t0:.1f} s from {args.root}', flush=True)
    dev = torch.device('cuda')
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = nvcc_variants(args.root, build.FLAGS, tmp)
        libs = {name: load_variant(p) for name, p in paths.items()}
        print(f'{args.tag}: {len(libs)} probe builds in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
        for rec in (h1_case('h1_slice', launch, resample, libs, dev, SLICE,
                            False, 0),
                    h1_case('h1_stack_two_planes', launch, resample, libs,
                            dev, STACK, True, 10),
                    h10_case('h10_pair', launch, resample, libs, dev, 20)):
            rec['tag'] = args.tag
            print(json.dumps(rec), flush=True)
        lib_path = Path(build.library()._name)
        print(json.dumps({'tag': args.tag,
                          'sass': sass_counts(lib_path)}), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    report = build.ptxas_report('warp.cu')
    print(' '.join(line.strip() for line in report.splitlines()
                   if 'Compiling' in line or 'registers' in line
                   or 'spill' in line), flush=True)


if __name__ == '__main__':
    main()
