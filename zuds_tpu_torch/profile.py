"""Where one frame of the slice spends its time on the card.

    python -m zuds_tpu_torch.profile [--frames N] [--deblend MODE]

Runs ``SubtractDetectPipeline`` at the flagship configuration (the
reference's default ``deblend=True``) on synthetic frames, warms up, then
traces ``N`` frames with ``torch.profiler`` and prints, next to the card's
name and power limit: host wall time per frame, the device's busy share, each
pipeline stage's host and device time (``deblend`` is the part of
``detect`` spent in the deblend tree), and the kernels that take the most
device time. Needs a CUDA card.
"""
import argparse
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .inputs import synth_inputs, to_torch
from .parallel import PipelineConfig, SubtractDetectPipeline

STAGES = ('warp', 'background', 'fit', 'apply', 'noise', 'detect',
          'deblend', 'measure')
FLAGSHIP = dict(height=3080, width=3072, ksize=15, stamp=41, smax=384,
                order=4, nreg=3, max_det=4096, det_cap=1 << 16,
                deb_cap=1 << 16)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--frames', type=int, default=2)
    ap.add_argument('--deblend', choices=('true', 'watershed', 'false'),
                    default='true', help="the detect stage's deblend mode")
    opt = ap.parse_args()
    frames = opt.frames
    if not torch.cuda.is_available():
        raise SystemExit('profile: needs a CUDA card')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    mode = {'true': True, 'watershed': 'watershed',
            'false': False}[opt.deblend]
    cfg = PipelineConfig(**FLAGSHIP, deblend=mode)
    args = to_torch(synth_inputs(1, cfg.height, cfg.width, cfg, seed=0))
    pipe = SubtractDetectPipeline(cfg)
    for _ in range(2):
        pipe(*args)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            pipe(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / frames
    mem1 = torch.cuda.memory_stats()
    events = prof.key_averages()
    # device activity: kernels, copies and memsets (one stream, so they do
    # not overlap); the stages' device-side ranges only span them
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and e.name not in STAGES) / frames / 1e3
    print(f'card: {card}; deblend={mode!r}')
    print(f'wall {wall * 1e3:.1f} ms/frame; device busy {busy:.1f} ms/frame '
          f'({100 * busy / (wall * 1e3):.1f}%; idle '
          f'{100 * (1 - busy / (wall * 1e3)):.1f}%)')
    # the caching allocator: device mallocs/frees in the window (each
    # cudaFree waits for the card) and retries after a failed malloc
    print('allocator per frame: ' + ', '.join(
        f'{k} {(mem1.get(k, 0) - mem0.get(k, 0)) / frames:g}'
        for k in ('num_device_alloc', 'num_device_free',
                  'num_alloc_retries')))
    # each stage range appears twice: on the host (its wall time, syncs
    # included) and on the device (first to last kernel launched in it)
    span = {}
    for e in prof.events():
        if e.name in STAGES:
            on = 'cpu' if e.device_type == DeviceType.CPU else 'dev'
            span[e.name, on] = (span.get((e.name, on), 0.0)
                                + e.time_range.elapsed_us())
    print('stage        host ms/frame  device span ms/frame')
    for s in STAGES:
        print(f'{s:12s} {span.get((s, "cpu"), 0) / frames / 1e3:13.2f} '
              f'{span.get((s, "dev"), 0) / frames / 1e3:21.2f}')
    print(events.table(sort_by='self_cuda_time_total', row_limit=25))


if __name__ == '__main__':
    main()
