"""H8 and H2 (``kernels/median.cu``, ``kernels/background.cu``), the frame
medians and the background-mesh cell statistics, timed at the main path's
shapes, with the probes that price their parts.

    python3 zuds_tpu_torch/bench_stats.py [--root DIR] [--tag NAME]

``--root`` is the checkout whose ``zuds_tpu_torch`` is imported (by
default the one this file sits in), so that two versions of the kernels
are timed by one script on one card: unpack the other version into a
directory and run the script once against each, in turns.

Cases, on seeded inputs (a star field with noise about 150 counts, a mask
with 1% holes and a masked band): H8 on the slice's 3080x3072 frame (the
stamp selector's median), on the frame about its median (``center``), on
the frame with its mask, and on a ::4 view of the frame with the view of
its mask (the pipeline's reference rms and rms_med: 770x768 read in
place); H2 at box 128 on that frame and on a 3200x3200 coadd canvas (an
epoch of 3080x3072 inside it, the rest invalid). Each checks the kernel
bit-equal to its plain version (H8's NaN-aware; H2's back, sigma and n)
and prints one JSON line (the script exits non-zero at its end if a case
differed):

- ``graph_ms``: device time per call, 20 calls captured in one CUDA graph
  and replayed between two CUDA events (no host cost);
- ``call_ms``: per call from Python, CUDA events around 20 calls made back
  to back (the host's cost included); both timed as ``bench_compact.py``
  times H6;
- ``bound_ms``: the bytes the call must read over 3.35 TB/s (H8: its
  values and mask once, for a strided view every 32-byte sector its
  elements lie in; H2: 5 B a pixel and 12 B a cell);
- ``probes``: device time of variants (where the checkout's source has
  them): H8 at one round (``iters=1``, through the wrapper) and without
  its counting (``-DZUDS_MEDIAN_PROBE_NO_COUNT``: the search alone, no
  buckets, no histogram); ``background.cu`` with its bisections cut to
  one pass (``-DZUDS_BG_PROBE_ONE_PASS``: one round in a kernel that
  settles one a reduction) and without its moments
  (``-DZUDS_BG_PROBE_NO_MOMENTS``: sigma 1, no sums). A probe's result is
  not the function's.

Then the card's name and power limit, ptxas's registers, spills and
shared memory of the checkout's median.cu and background.cu, and each of
their kernels' SASS instruction count and local-memory instructions
(``LDL``/``STL``) from ``cuobjdump -sass``, where the toolkit has it.
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

import torch  # noqa: E402

HBM_BYTES_S = 3.35e12
SLICE = (3080, 3072)
CANVAS = (3200, 3200)
BOX = 128
CLIP_ITERS = 3
# probe builds: (source, name) -> extra nvcc flags
PROBES = {('median.cu', 'no_count'): ['-DZUDS_MEDIAN_PROBE_NO_COUNT'],
          ('background.cu', 'one_pass'): ['-DZUDS_BG_PROBE_ONE_PASS'],
          ('background.cu', 'no_moments'): ['-DZUDS_BG_PROBE_NO_MOMENTS']}


def sector_bytes(t):
    """Bytes of the distinct 32-byte sectors the elements of the strided
    tensor ``t`` lie in: what one read of it moves from memory."""
    idx = torch.zeros((), dtype=torch.int64, device=t.device)
    for n, s in zip(t.shape, t.stride()):
        idx = idx[..., None] + torch.arange(n, device=t.device) * s
    addr = t.data_ptr() + idx.reshape(-1) * t.element_size()
    return 32 * int(torch.unique(addr // 32).numel())


def scene(H, W, seed, dev):
    """A star field (``bench_warp.star_field``) and a mask with 1% seeded
    holes and a masked band of 64 rows."""
    from zuds_tpu_torch.bench_warp import star_field
    img = torch.as_tensor(star_field(H, W, seed), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    ok = torch.rand((H, W), generator=g, device=dev) > 0.01
    ok[H // 3:H // 3 + 64] = False
    return img, ok


def nvcc_variants(root, flags, out_dir):
    """Compile each probe whose macro the checkout's source knows, all at
    once, each into its own shared library. Returns {(source, name):
    path}."""
    from zuds_tpu_torch.kernels import build
    kdir = Path(root) / 'zuds_tpu_torch' / 'kernels'
    nvcc = build._nvcc()
    procs = {}
    for (src, name), extra in PROBES.items():
        macro = extra[0][2:].split('=')[0]
        if macro not in (kdir / src).read_text():
            continue
        out = Path(out_dir) / f'{src[:-3]}_{name}.so'
        procs[src, name] = (out, subprocess.Popen(
            [nvcc, *flags, *extra, '-shared', '-o', str(out),
             str(kdir / src)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    built = {}
    for key, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on probe {key}:\n{err}')
        built[key] = out
    return built


def load_variant(path):
    from zuds_tpu_torch.kernels import build
    lib = ctypes.CDLL(str(path))
    for fn in ('zuds_frame_median', 'zuds_background_cells'):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
    if hasattr(lib, 'zuds_frame_median_scratch'):
        lib.zuds_frame_median_scratch.argtypes = (ctypes.c_int,) * 2
        lib.zuds_frame_median_scratch.restype = ctypes.c_longlong
    return lib


def _p(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def variant_median(lib, launch, x, ok=None, center=None, iters=12):
    """launch.frame_median through a probe build of median.cu."""
    n = x.numel()
    nb = max(1, min(launch.MEDIAN_BLOCKS, -(-n // launch.MEDIAN_PER_BLOCK)))
    scratch = torch.empty(lib.zuds_frame_median_scratch(nb, iters),
                          dtype=torch.uint8, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    err = lib.zuds_frame_median(
        _p(x), _p(ok), _p(center), x.shape[0], x.shape[1], *x.stride(),
        *(ok.stride() if ok is not None else (0, 0)), nb, iters, _p(scratch),
        _p(out), _stream())
    if err:
        raise RuntimeError(f'probe zuds_frame_median: CUDA error {err}')
    return out


def variant_cells(lib, img, valid, box=BOX, iters=CLIP_ITERS):
    """launch.background_cells through a probe build of background.cu."""
    H, W = img.shape
    ncy, ncx = -(-H // box), -(-W // box)
    back = torch.empty((ncy, ncx), dtype=torch.float32, device=img.device)
    sigma = torch.empty_like(back)
    n = torch.empty((ncy, ncx), dtype=torch.int32, device=img.device)
    err = lib.zuds_background_cells(_p(img), _p(valid), _p(back), _p(sigma),
                                    _p(n), H, W, box, iters, _stream())
    if err:
        raise RuntimeError(f'probe zuds_background_cells: CUDA error {err}')
    return back, sigma, n


def same_median(a, b):
    return bool(torch.equal(a.isnan(), b.isnan())
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def sass_counts(so, pattern):
    """{kernel: (instructions, local-memory instructions)} of the kernels
    whose name matches ``pattern``, from ``cuobjdump -sass``; {} without
    the tool."""
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
            if re.search(r'\b(LDL|STL)\b', line):
                counts[name][1] += 1
    return {k: tuple(v) for k, v in counts.items() if re.search(pattern, k)}


def h8_cases(launch, background, libs, dev):
    from zuds_tpu_torch.bench_compact import call_ms, graph_ms
    img, ok = scene(*SLICE, 0, dev)
    med = launch.frame_median(img)
    cases = {'h8_frame': (img, None, None),
             'h8_center': (img, None, med),
             'h8_frame_mask': (img, ok, None),
             'h8_view_mask': (img[::4, ::4], ok[::4, ::4], None)}
    for tag, (x, o, c) in cases.items():
        k = launch.frame_median(x, o, c)
        p = background.frame_median_plain(x, o, c)
        rec = {'case': tag, 'shape': list(x.shape), 'median': float(k),
               'bit_equal': same_median(k, p)}
        rec['graph_ms'] = graph_ms(lambda: launch.frame_median(x, o, c))
        rec['call_ms'] = call_ms(lambda: launch.frame_median(x, o, c))
        rec['bound_ms'] = (sector_bytes(x) + (0 if o is None else
                                              sector_bytes(o))) \
            / HBM_BYTES_S * 1e3
        probes = {'one_round': graph_ms(
            lambda: launch.frame_median(x, o, c, iters=1))}
        for (src, name), lib in libs.items():
            if src == 'median.cu':
                probes[name] = graph_ms(lambda: variant_median(lib, launch,
                                                               x, o, c))
        rec['probes'] = probes
        yield rec


def h2_cases(launch, background, libs, dev):
    from zuds_tpu_torch.bench_compact import call_ms, graph_ms
    img, ok = scene(*SLICE, 10, dev)
    H, W = CANVAS
    canvas = torch.zeros((H, W), device=dev)
    cvalid = torch.zeros((H, W), dtype=torch.bool, device=dev)
    e_img, e_ok = scene(*SLICE, 20, dev)
    canvas[60:60 + SLICE[0], 64:64 + SLICE[1]] = e_img
    cvalid[60:60 + SLICE[0], 64:64 + SLICE[1]] = e_ok
    for tag, (x, v) in {'h2_slice': (img, ok),
                        'h2_canvas': (canvas, cvalid)}.items():
        k = launch.background_cells(x, v, BOX, CLIP_ITERS)
        p = background.background_cells_plain(x, v, BOX, CLIP_ITERS)
        equal = [bool(torch.equal(a, b)) for a, b in zip(k, p)]
        err = float(max((k[0] - p[0]).abs().max(),
                        (k[1] - p[1]).abs().max()))
        rec = {'case': tag, 'shape': [x.shape[0], x.shape[1]],
               'cells': k[0].numel(), 'bit_equal': equal,
               'max_abs_err': err}
        try:
            rec['graph_ms'] = graph_ms(lambda: launch.background_cells(
                x, v, BOX, CLIP_ITERS))
        except RuntimeError as e:    # a launcher that cannot be captured
            rec['graph_ms'], rec['graph_error'] = None, str(e)[:200]
            torch.cuda.synchronize()
        rec['call_ms'] = call_ms(lambda: launch.background_cells(
            x, v, BOX, CLIP_ITERS))
        rec['bound_ms'] = (5 * x.numel() + 12 * k[0].numel()) \
            / HBM_BYTES_S * 1e3
        probes = {}
        for (src, name), lib in libs.items():
            if src == 'background.cu':
                probes[name] = graph_ms(lambda: variant_cells(lib, x, v))
        rec['probes'] = probes
        rec['bit_equal'] = all(equal)
        yield rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=str(_HERE.parent))
    ap.add_argument('--tag', default='')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit('bench_stats: no CUDA device')
    sys.path.insert(0, args.root)
    from zuds_tpu_torch.kernels import build, launch
    from zuds_tpu_torch.ops import background
    t0 = time.perf_counter()
    build.library()
    print(f'{args.tag}: library built and loaded in '
          f'{time.perf_counter() - t0:.1f} s from {args.root}', flush=True)
    dev = torch.device('cuda')
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = nvcc_variants(args.root, build.FLAGS, tmp)
        libs = {key: load_variant(p) for key, p in paths.items()}
        print(f'{args.tag}: {len(libs)} probe builds in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
        differ = []
        for cases in (h8_cases, h2_cases):
            for rec in cases(launch, background, libs, dev):
                rec['tag'] = args.tag
                print(json.dumps(rec), flush=True)
                if not rec['bit_equal']:
                    differ.append(rec['case'])
        lib_path = Path(build.library()._name)
        print(json.dumps({'tag': args.tag, 'sass': sass_counts(
            lib_path, r'median|minmax|count_kernel|round_kernel|finish|'
            r'background')}), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for src in ('median.cu', 'background.cu'):
        report = build.ptxas_report(src)
        print(src, ' '.join(line.strip() for line in report.splitlines()
                            if 'Compiling' in line or 'registers' in line
                            or 'spill' in line), flush=True)
    if differ:
        sys.exit(f'bench_stats: differs from the plain version: {differ}')


if __name__ == '__main__':
    main()
