"""H6 (``kernels/compact.cu``) beside ``torch.nonzero_static``, the one
PyTorch call of the same function, on two yardsticks.

    python3 zuds_tpu_torch/bench_compact.py [--root DIR] [--tag NAME]

``--root`` is the checkout whose ``zuds_tpu_torch`` is imported (by
default the one this file sits in), so that two versions of H6 are timed
by one script on one card: unpack the other version into a directory and
run the script once against each, in turns.

For each mask, at the sizes and set counts of the slice's H6 calls on a
flagship frame (a 3080x3072 frame mask at the detect stage's capacity and
at ``label_components``' size H*W, the deblend stage's 65,536- and
524,288-entry lists; set entries at seeded positions), it checks H6
bit-equal to ``nonzero_static`` and prints one JSON line:

- ``graph_ms``, ``lib_graph_ms``: device time per call, 20 calls captured
  in one CUDA graph and replayed between two CUDA events (no host cost);
- ``call_ms``, ``lib_call_ms``: per call from Python, CUDA events around
  20 calls made back to back (the host's cost included: where it exceeds
  the device time, this is the host's pace);
- ``host_us``: the host's microseconds per call of the wrapper's parts,
  by ``time.perf_counter`` over 2000 calls (the stream lookup, the
  allocation, the two views it returns), and of the whole wrapper and of
  ``nonzero_static``, synchronised every 100 calls.

Then the card's name and power limit, and ptxas's registers and spills of
the checkout's compact.cu.
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
import json  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

FRAME = 3080 * 3072
# (entries, set entries, size) of the slice's H6 calls on frame 0
# (chip_smoke.py prints them from one detect_sources run)
MASKS = ((FRAME, 34253, 65536), (65536, 32367, 65536), (65536, 2541, 8192),
         (524288, 28266, 65536), (FRAME, 34253, FRAME))


def graph_ms(fn, reps=20):
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


def call_ms(fn, warmup=3, reps=20):
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


def host_us(fn, reps=2000, sync_every=0):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn()
        if sync_every and i % sync_every == sync_every - 1:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def make_mask(n, k, seed):
    rng = np.random.default_rng(seed)
    m = np.zeros(n, bool)
    m[rng.choice(n, k, replace=False)] = True
    return torch.as_tensor(m, device='cuda')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=str(_HERE.parent))
    ap.add_argument('--tag', default='')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit('bench_compact: no CUDA device')
    sys.path.insert(0, args.root)
    from zuds_tpu_torch.kernels import build, launch
    t0 = time.perf_counter()
    build.library()
    print(f'{args.tag}: library built and loaded in '
          f'{time.perf_counter() - t0:.1f} s from {args.root}', flush=True)
    dev = torch.device('cuda')
    for j, (n, k, size) in enumerate(MASKS):
        mask = make_mask(n, k, j)
        fill = n - 1
        idx, cnt = launch.compact(mask, size, fill)
        lib = torch.nonzero_static(mask, size=size, fill_value=fill)
        if not (torch.equal(lib.reshape(-1), idx) and int(cnt) == k):
            raise AssertionError(f'H6 differs from nonzero_static at {n}')
        rec = {'tag': args.tag, 'entries': n, 'set': k, 'size': size,
               'graph_ms': graph_ms(lambda: launch.compact(mask, size,
                                                           fill)),
               'lib_graph_ms': graph_ms(lambda: torch.nonzero_static(
                   mask, size=size, fill_value=fill)),
               'call_ms': call_ms(lambda: launch.compact(mask, size, fill)),
               'lib_call_ms': call_ms(lambda: torch.nonzero_static(
                   mask, size=size, fill_value=fill))}
        buf = torch.empty(size + 8, dtype=torch.int64, device=dev)
        rec['host_us'] = {
            'wrapper': host_us(lambda: launch.compact(mask, size, fill),
                               sync_every=100),
            'nonzero_static': host_us(lambda: torch.nonzero_static(
                mask, size=size, fill_value=fill), sync_every=100),
            'current_stream': host_us(
                lambda: torch.cuda.current_stream().cuda_stream),
            'raw_stream': host_us(
                lambda: torch._C._cuda_getCurrentRawStream(
                    torch._C._cuda_getDevice())),
            'empty': host_us(lambda: torch.empty(
                size + 8, dtype=torch.int64, device=dev)),
            'two_views': host_us(lambda: (buf[:size], buf[size]))}
        print(json.dumps(rec), flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    report = build.ptxas_report('compact.cu')
    print(' '.join(line.strip() for line in report.splitlines()
                   if 'Compiling' in line or 'registers' in line
                   or 'spill' in line), flush=True)


if __name__ == '__main__':
    main()
