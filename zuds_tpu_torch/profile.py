"""Where one frame of the slice, one pair of a night, one epoch of a
stack, or one pair of the per-pair chain spends its time on the card.

    python -m zuds_tpu_torch.profile [--frames N] [--deblend MODE]
    python -m zuds_tpu_torch.profile --night N
    python -m zuds_tpu_torch.profile --coadd N
    python -m zuds_tpu_torch.profile --sub [ROT_DEG]

Runs ``SubtractDetectPipeline`` at the flagship configuration (the
reference's default ``deblend=True``) on synthetic frames, warms up, then
traces ``N`` frames with ``torch.profiler`` and prints, next to the card's
name and power limit: host wall time per frame, the device's busy share, each
pipeline stage's host and device time (``ccl``, ``deblend``, ``stats`` and
``clean`` are the parts of ``detect``: the base components, the deblend
tree, the per-object statistics and CLEAN), the host waits inside the
detect stage's ``ccl``, ``stats`` and ``clean`` ranges, and the kernels
that take the most device time. With ``--night N`` it writes N flagship FITS pairs
(``inputs.write_night_pairs``, the real ZTF header of
``tests/data/ztf_real_header.json``) to a temporary directory and traces
``night.run_night`` over them after a warm-up, with the night's phases
(load, prepare, pipeline, commit) in place of the stages. With
``--coadd N`` it writes N epochs of one quadrant
(``inputs.write_coadd_epochs``) and traces ``ScienceCoadd.from_images``
over them after a warm-up, per epoch: the stack's phases (load, prepare,
pipeline, fetch, write), the epoch stages (background, weight, warp) and
the combine. With ``--sub`` it writes one flagship pair whose reference is
rotated by ``ROT_DEG`` (default 0.5: the gather warp runs; 0 takes the
planned warp) and traces ``sub.do_one`` on a fresh copy after a warm-up on
another: the chain's phases (load, subtract, catalog, filter) and the host
seconds of ``from_images``' steps. Needs a CUDA card.
"""
import argparse
import dataclasses
import subprocess
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .inputs import synth_inputs, to_torch
from .night import FLAGSHIP
from .parallel import SubtractDetectPipeline

STAGES = ('warp', 'background', 'fit', 'apply', 'noise', 'detect', 'ccl',
          'deblend', 'stats', 'clean', 'measure')
# the detect stage's ranges that read nothing back to the host on the card
NO_WAIT_RANGES = ('ccl', 'stats', 'clean')
# host calls that wait for the card (or copy through the host)
SYNC_CALLS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
              'cudaEventSynchronize', 'aten::_local_scalar_dense',
              'aten::item', 'aten::equal')
NIGHT_RANGES = ('load', 'prepare', 'pipeline', 'commit') + STAGES
COADD_RANGES = ('load', 'prepare', 'pipeline', 'fetch', 'write',
                'background', 'weight', 'warp', 'combine')


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--frames', type=int, default=2)
    ap.add_argument('--deblend', choices=('true', 'watershed', 'false'),
                    default='true', help="the detect stage's deblend mode")
    ap.add_argument('--night', type=int, default=0, metavar='N',
                    help='trace run_night over N flagship FITS pairs')
    ap.add_argument('--coadd', type=int, default=0, metavar='N',
                    help='trace ScienceCoadd.from_images over N epochs')
    ap.add_argument('--sub', type=float, nargs='?', const=0.5, default=None,
                    metavar='ROT_DEG', help='trace sub.do_one on one pair '
                    'whose reference is rotated by ROT_DEG')
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile: needs a CUDA card')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    if opt.sub is not None:
        from .sub import PHASES
        with tempfile.TemporaryDirectory(prefix='zuds_sub_') as d:
            report(card, f'sub.do_one, reference rotated by {opt.sub} deg, '
                   'per pair', 1, PHASES, *trace_sub(d, FLAGSHIP, opt.sub),
                   unit='pair')
        return
    if opt.coadd:
        with tempfile.TemporaryDirectory(prefix='zuds_coadd_') as d:
            report(card, f'ScienceCoadd.from_images of {opt.coadd} epochs, '
                   'per epoch', opt.coadd, COADD_RANGES,
                   *trace_coadd(d, FLAGSHIP, opt.coadd), unit='epoch')
        return
    mode = {'true': True, 'watershed': 'watershed',
            'false': False}[opt.deblend]
    cfg = dataclasses.replace(FLAGSHIP, deblend=mode)
    pipe = SubtractDetectPipeline(cfg)
    if opt.night:
        with tempfile.TemporaryDirectory(prefix='zuds_night_') as d:
            report(card, f'deblend={mode!r}, run_night, batch 2, per pair',
                   opt.night, NIGHT_RANGES, *trace_night(d, cfg, pipe,
                                                         opt.night))
        return
    frames = opt.frames
    args = to_torch(synth_inputs(1, cfg.height, cfg.width, cfg, seed=0))
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
    report(card, f'deblend={mode!r}, per frame', frames, STAGES, prof, wall,
           mem0, mem1)


def trace_night(d, cfg, pipe, npairs):
    """Write ``npairs`` flagship pairs into ``d``, warm up on two, then
    trace run_night over all of them: (profile, wall s per pair, allocator
    stats before and after)."""
    from .inputs import write_night_pairs
    from .night import run_night
    work, _ = write_night_pairs(
        d, npairs, cfg.height, cfg.width,
        header_json=Path(__file__).resolve().parent.parent / 'tests'
        / 'data' / 'ztf_real_header.json')
    run_night(work[:2], batch=2, ml=False, cfg=cfg, pipe=pipe)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_night(work, batch=2, ml=False, cfg=cfg, pipe=pipe)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / npairs
    bad = [r for _, r in res if isinstance(r, Exception)]
    if bad:
        raise SystemExit(f'profile: run_night failed: {bad}')
    return prof, wall, mem0, torch.cuda.memory_stats()


def trace_coadd(d, cfg, nepochs):
    """Write ``nepochs`` epochs of one quadrant into ``d``, build the stack
    once to warm up, then trace a second build, files to saved stack:
    (profile, wall s per epoch, allocator stats before and after)."""
    from .coadd import ScienceCoadd
    from .image import ScienceImage
    from .inputs import write_coadd_epochs
    paths, _ = write_coadd_epochs(d, nepochs, cfg.height, cfg.width)

    def build(out):
        with torch.profiler.record_function('load'):
            images = [ScienceImage.from_file(p) for p in paths]
            for im in images:       # from_file is lazy: read the files here
                im.data, im.mask_image.data
        return ScienceCoadd.from_images(images, f'{d}/{out}',
                                        calculate_seeing=False)

    build('warm.fits')
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        coadd = build('stack.fits')
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / nepochs
    if coadd.header['NCOADD'] != nepochs:
        raise SystemExit('profile: the stack lost an epoch')
    return prof, wall, mem0, torch.cuda.memory_stats()


def trace_sub(d, cfg, rot_deg):
    """Write one flagship pair into ``d`` with its reference rotated by
    ``rot_deg``, run ``sub.do_one`` on one copy to warm up, then trace it on
    a fresh copy (a pair's products are cached beside it): (profile, wall s,
    allocator stats before and after). Prints the host seconds of the
    chain's steps."""
    import shutil
    from .inputs import write_night_pairs
    from .sub import do_one
    src = Path(d) / 'src'
    src.mkdir()
    work, _ = write_night_pairs(
        str(src), 1, cfg.height, cfg.width, ref_rot_deg=(rot_deg,),
        header_json=Path(__file__).resolve().parent.parent / 'tests'
        / 'data' / 'ztf_real_header.json')
    lines = {}
    for name in ('warm', 'traced'):
        shutil.copytree(src, Path(d) / name)
        lines[name] = work[0].replace(str(src), str(Path(d) / name))
    do_one(lines['warm'], ml=False)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_stats()
    stats = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        do_one(lines['traced'], ml=False, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print('host seconds: ' + ', '.join(f'{k[:-2]} {v:.3f}'
                                       for k, v in stats.items()))
    return prof, wall, mem0, torch.cuda.memory_stats()


def host_waits(prof, ranges=NO_WAIT_RANGES):
    """Per range of ``ranges``: how many host copies (``cudaMemcpy*``
    calls, any direction) and waits for the card (SYNC_CALLS) started
    inside it, from the profiler's host events."""
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.name in ranges and e.device_type == DeviceType.CPU]
    out = {r: {'copies': 0, 'syncs': 0} for r in ranges}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        kind = ('copies' if e.name.startswith('cudaMemcpy') else
                'syncs' if e.name in SYNC_CALLS else None)
        if kind is None:
            continue
        for name, t0, t1 in spans:
            if t0 <= e.time_range.start <= t1:
                out[name][kind] += 1
    return out


def report(card, what, frames, ranges, prof, wall, mem0, mem1, unit='frame'):
    """Print wall and device busy time per frame (or ``unit``), the
    allocator's device mallocs, each range's host time and device span, and
    the kernels by device time."""
    events = prof.key_averages()
    # device activity: kernels, copies and memsets (one stream, so they do
    # not overlap); the stages' device-side ranges only span them
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and e.name not in ranges) / frames / 1e3
    print(f'card: {card}; {what}')
    print(f'wall {wall * 1e3:.1f} ms/{unit}; device busy {busy:.1f} ms/{unit} '
          f'({100 * busy / (wall * 1e3):.1f}%; idle '
          f'{100 * (1 - busy / (wall * 1e3)):.1f}%)')
    # the caching allocator: device mallocs/frees in the window (each
    # cudaFree waits for the card) and retries after a failed malloc
    print(f'allocator per {unit}: ' + ', '.join(
        f'{k} {(mem1.get(k, 0) - mem0.get(k, 0)) / frames:g}'
        for k in ('num_device_alloc', 'num_device_free',
                  'num_alloc_retries')))
    # each stage range appears twice: on the host (its wall time, syncs
    # included) and on the device (first to last kernel launched in it)
    span = {}
    for e in prof.events():
        if e.name in ranges:
            on = 'cpu' if e.device_type == DeviceType.CPU else 'dev'
            span[e.name, on] = (span.get((e.name, on), 0.0)
                                + e.time_range.elapsed_us())
    print(f'range        host ms/{unit}  device span ms/{unit}')
    for s in ranges:
        print(f'{s:12s} {span.get((s, "cpu"), 0) / frames / 1e3:13.2f} '
              f'{span.get((s, "dev"), 0) / frames / 1e3:21.2f}')
    if 'ccl' in ranges:
        print('host copies and waits in the detect ranges: '
              + ', '.join(f'{r} {c["copies"]} and {c["syncs"]}'
                          for r, c in host_waits(prof).items()))
    print(events.table(sort_by='self_cuda_time_total', row_limit=25))


if __name__ == '__main__':
    main()
