"""Batched night driver of the port (twin of ``scripts/donight.py``): FITS
pairs on disk -> filtered catalogs, through ``SubtractDetectPipeline`` on
the card.

    python -m zuds_tpu_torch.night <worklist> [batch]

``<worklist>`` holds one "sci_path ref_path" pair per line; this process
takes its share (``mpi.get_my_share_of_work``). Per batch:

  FITS reads in a thread pool (the port's numpy codec)
    -> prepare_frame_inputs (mapping grid, stamps on the card with H8, H7
       and H6, kernel basis; the reference kept on the card)
    -> SubtractDetectPipeline (align, background, A&L fit, subtract,
       detect, photometer: H1-H6, H8)
    -> one bulk copy of the small outputs to the host
    -> catalog (``PipelineFITSCatalog.from_pipeline``) -> ``filter_sexcat``
       (at ``ml=True``: the frame's diff fetched from the card, the science
       frame and the diff aligned to the reference, the triplets H12 and
       braai H13 on the card, the ``RB_CUT`` cut)
       -> the GOODCUT rows, the ``MAX_DETS`` quality guard.

Batch k+1 is prepared and its pipeline enqueued before batch k's outputs
are copied back and committed. ``diff``/``rms``/``submask`` stay on the
card behind each subtraction's thunk.

A pair the batched chain cannot take (``prepare_frame_inputs`` refuses a
mapping past the ``max_shift`` bucket, the frame is not the bucket's shape,
or its commit raises) runs the per-pair chain ``sub.do_one`` instead (the
planned or the gather warp, H10), and its count is recorded; a failure
inside the fallback is recorded as that exception.

At ``db=True`` (the default, as in the reference) and with a database bound
(``model_util.init_db()``), each committed frame also writes its products
to disk (the frames fetched from the card once), a ``sesub`` ``ZTFFile``
record carrying the science and reference images' ids (None for images
built from HDUs, as the reference's night builds them), its ``Detection``
rows and three thumbnails a detection (``sub``, ``new``, ``ref``), in the
thread that runs the commit. With no database bound it writes nothing, as
in the reference.
"""
from __future__ import annotations

import concurrent.futures
import os
import sys
import time
import traceback

import numpy as np
import torch

from .commit import COMMIT_SPANS, commit_subtraction
from .constants import KERNEL_SPATIAL_ORDER
from .fits import read_fits
from .inputs import INPUT_NAMES, resolve_device
from .parallel.pipeline import (REF_CACHE_SIZE, PipelineConfig,
                                SubtractDetectPipeline, prepare_frame_inputs)

__all__ = ['MAX_DETS', 'TooManyDetections', 'NightLoader', 'run_night',
           'FLAGSHIP']

MAX_DETS = 50  # image-quality guard (donight.py:35)

# the production configuration of donight.py:234-238
FLAGSHIP = PipelineConfig(height=3080, width=3072, ksize=15, stamp=41,
                          smax=384, order=KERNEL_SPATIAL_ORDER, nreg=3,
                          max_det=4096, det_cap=1 << 16, deb_cap=1 << 16)

FRAME_KEYS = ('diff', 'rms', 'submask')
# the night's phases as torch.profiler ranges (python -m
# zuds_tpu_torch.profile --night); they record only while a profiler runs
PHASES = ('load', 'prepare', 'pipeline', 'commit')
_phase = torch.profiler.record_function


class TooManyDetections(RuntimeError):
    """The MAX_DETS image-quality guard fired after the batched chain
    succeeded: the frame is recorded as failed (donight.py:38-43)."""


class NightLoader:
    """FITS reads in a pool of threads: ``submit(path)`` queues a read,
    ``get(ticket)`` blocks for its first HDU with data."""

    def __init__(self, workers=4):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=workers)

    def submit(self, path):
        return self._pool.submit(_read_image, path)

    def get(self, ticket):
        return ticket.result()

    def close(self):
        self._pool.shutdown(wait=True)


def _read_image(path):
    return next(h for h in read_fits(path) if h.data is not None)


def _sibling_mask_path(path):
    """Mask file next to a science/reference frame, if present."""
    for cand in (path.replace('sciimg', 'mskimg'),
                 path.replace('.fits', '.mask.fits')):
        if cand != path and os.path.exists(cand):
            return cand
    return None


def _image_from_hdu(cls, path, hdu, mask_hdu=None):
    """An image object from an HDU already in memory (no re-read)."""
    from .mask import MaskImage

    obj = cls()
    obj.header = hdu.header
    obj.data = np.ascontiguousarray(hdu.data)
    obj.basename = os.path.basename(path)
    obj.map_to_local_file(path)
    h = hdu.header
    obj.field = h.get('FIELDID')
    obj.ccdid = h.get('CCDID')
    obj.qid = h.get('QID')
    obj.fid = h.get('FILTERID')
    if mask_hdu is not None:
        m = MaskImage()
        m.header = mask_hdu.header
        m.data = np.ascontiguousarray(mask_hdu.data)
        m.basename = os.path.basename(path).replace('.fits', '.mask.fits')
        m.parent_image = obj
        obj.mask_image = m
    return obj


def _load_pair(loader, tickets, sci_path, ref_path, ref_objs=None):
    """(sci, ref) images of a work line; each distinct reference is
    decoded once and kept (at most REF_CACHE_SIZE, oldest evicted)."""
    from .coadd import ReferenceImage
    from .image import ScienceImage

    t_sci, t_scimask, t_ref, t_refmask = tickets
    sci = _image_from_hdu(
        ScienceImage, sci_path, loader.get(t_sci),
        loader.get(t_scimask) if t_scimask is not None else None)
    if ref_objs is not None and ref_path in ref_objs:
        return sci, ref_objs[ref_path]
    if t_ref is None:      # submitted once but evicted since: re-read
        t_ref = loader.submit(ref_path)
        rm = _sibling_mask_path(ref_path)
        t_refmask = loader.submit(rm) if rm else None
    ref = _image_from_hdu(
        ReferenceImage, ref_path, loader.get(t_ref),
        loader.get(t_refmask) if t_refmask is not None else None)
    if ref_objs is not None:
        if len(ref_objs) >= REF_CACHE_SIZE:
            ref_objs.pop(next(iter(ref_objs)))
        ref_objs[ref_path] = ref
    return sci, ref


def _commit_frame(sci, ref, small, b, frames_thunk, cfg, ml=True,
                  db=True, device=None, stats=None):
    """Subtraction product, catalog and filter for frame ``b`` of a batch,
    and at ``db=True`` with a database bound the commit (donight.py:
    157-205). ``small``: host copies of the pipeline's fixed-size outputs.
    Returns (sub, GOODCUT rows), the rows ``Detection.from_catalog(cat,
    filter=True)`` keeps. ``device``: where the ML step runs (the card
    unless ``'cpu'``); ``stats`` gains its ``ml_s`` and ``scored``, and at
    a commit the host seconds of ``commit.COMMIT_SPANS``."""
    from .catalog import PipelineFITSCatalog
    from .filterobjects import filter_sexcat
    from .subtraction import SingleEpochSubtraction

    sub = SingleEpochSubtraction.assemble_deferred(
        sci, ref, frames_thunk, method='hotpants-fused',
        spatial_order=cfg.order, nreg_side=cfg.nreg)
    cat = PipelineFITSCatalog.from_pipeline(sub, small, frame=b)
    filter_sexcat(cat, ml=ml, device=device, stats=stats)
    detections = cat.data[cat.data['GOODCUT'] == 1]
    if len(detections) > MAX_DETS:
        raise TooManyDetections(
            f'{sub.basename}: {len(detections)} detections exceeds '
            f'MAX_DETS={MAX_DETS}; bad image quality')
    if db:
        commit_subtraction(sub, sci, ref, cat, stats=stats)
    return sub, detections


def _bulk_to_host(tensors):
    """name -> numpy array of every tensor in ``tensors``, fetched in one
    device-to-host copy (each entry padded to 8 bytes in one buffer)."""
    names = list(tensors)
    parts = []
    for k in names:
        b = tensors[k].contiguous().reshape(-1).view(torch.uint8)
        parts.append(torch.nn.functional.pad(b, (0, (-b.numel()) % 8)))
    buf = torch.cat(parts).cpu().numpy()
    out, off = {}, 0
    for k, part in zip(names, parts):
        t = tensors[k]
        nbytes = t.numel() * t.element_size()
        npdt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[k] = buf[off:off + nbytes].view(npdt).reshape(tuple(t.shape))
        off += part.numel()
    return out


def run_night(work, batch=4, ml=True, db=True, cfg=None, loader=None,
              pipe=None, device=None, stats=None):
    """Process "sci_path ref_path" work lines through the batched pipeline
    (donight.py:208-365). Returns per-pair (sci_path, number of GOODCUT
    detections | Exception) tuples.

    ``cfg`` defaults to :data:`FLAGSHIP`; ``pipe`` is an optional
    ``SubtractDetectPipeline`` to share; ``device`` is the card unless
    ``'cpu'``. ``stats`` (dict, optional) is filled with the host seconds
    of each phase (``load_s``, ``prepare_s``, ``upload_s`` within
    prepare, ``pipeline_s``, ``commit_s``), ``upload_bytes``,
    ``ref_cache_hits``/``ref_cache_misses``, ``fallbacks`` and
    ``fallback_s`` (the pairs that took the per-pair chain and their host
    seconds), and ``detections``, ``seeing`` (the SEEING the kernel
    basis used), ``scored`` (candidates braai scored) and ``ml_s`` (host
    seconds of the ML step) per committed frame, and at a database commit
    the host seconds of ``commit.COMMIT_SPANS`` per committed frame."""
    device = resolve_device(device)
    work = [str(w).split() for w in work]
    own_loader = loader is None
    if own_loader:
        loader = NightLoader()
    cfg = cfg or FLAGSHIP
    if pipe is None:
        pipe = SubtractDetectPipeline(cfg)
    st = stats if stats is not None else {}
    for k in ('load_s', 'prepare_s', 'upload_s', 'pipeline_s', 'commit_s',
              'fallback_s'):
        st.setdefault(k, 0.0)
    for k in ('upload_bytes', 'ref_cache_hits', 'ref_cache_misses',
              'fallbacks'):
        st.setdefault(k, 0)
    for k in ('detections', 'seeing', 'scored', 'ml_s'):
        st.setdefault(k, [])
    results = []

    def fallback(i):
        """The per-pair chain for work line ``i`` (donight.py:244-249,
        281-284, 331-335): its count, or the exception it raised."""
        from .sub import do_one
        sci_path, ref_path = work[i]
        t0 = time.perf_counter()
        try:
            _, dets = do_one(f'{sci_path} {ref_path}', ml=ml, device=device)
            results.append((sci_path, len(dets)))
        except Exception as e2:
            results.append((sci_path, e2))
        st['fallbacks'] += 1
        st['fallback_s'] += time.perf_counter() - t0

    def process(meta, pout, t_dispatch):
        """Commit one batch: ONE bulk copy of the fixed-size outputs;
        frames stay on the card behind per-frame thunks."""
        t0 = time.perf_counter()
        with _phase('commit'):
            small = _bulk_to_host({k: v for k, v in pout.items()
                                   if k not in FRAME_KEYS})
            dt = time.perf_counter() - t_dispatch
            print(f'batch of {len(meta)}: device+host {dt:.2f}s '
                  f'({len(meta) / max(dt, 1e-9):.2f} q/s)', flush=True)
            for bi, (i, sci, ref) in enumerate(meta):
                commit_one(bi, i, sci, ref, small, pout)
        st['commit_s'] += time.perf_counter() - t0

    def commit_one(bi, i, sci, ref, small, pout):
        def frames_thunk(b=bi, p=pout):
            return (p['diff'][b].cpu().numpy(), p['rms'][b].cpu().numpy(),
                    p['submask'][b].cpu().numpy().astype(np.uint32))

        sci_path = work[i][0]
        fst = {}
        try:
            _, dets = _commit_frame(sci, ref, small, bi, frames_thunk, cfg,
                                    ml=ml, db=db, device=device, stats=fst)
            results.append((sci_path, len(dets)))
            st['detections'].append(len(dets))
            st['seeing'].append(float(sci.header['SEEING']))
            st['scored'].append(fst.get('scored', 0))
            st['ml_s'].append(fst.get('ml_s', 0.0))
            for k in COMMIT_SPANS:
                if k in fst:
                    st.setdefault(k, []).append(fst[k])
        except TooManyDetections as e:
            print(f'quality guard: {e}', flush=True)
            results.append((sci_path, e))
        except Exception:
            traceback.print_exc()
            fallback(i)

    try:
        # the whole window is submitted up front: the pool reads ahead
        # while the card computes
        tickets = []
        seen_refs = set()
        for sci_path, ref_path in work:
            sm = _sibling_mask_path(sci_path)
            rm = _sibling_mask_path(ref_path)
            first = ref_path not in seen_refs
            seen_refs.add(ref_path)
            tickets.append((loader.submit(sci_path),
                            loader.submit(sm) if sm else None,
                            loader.submit(ref_path) if first else None,
                            loader.submit(rm) if (rm and first) else None))

        pending = None
        ref_cache = {}
        ref_objs = {}
        for b0 in range(0, len(work), batch):
            frames, meta = [], []
            for i in range(b0, min(b0 + batch, len(work))):
                sci_path, ref_path = work[i]
                try:
                    t0 = time.perf_counter()
                    with _phase('load'):
                        sci, ref = _load_pair(loader, tickets[i], sci_path,
                                              ref_path, ref_objs=ref_objs)
                    t1 = time.perf_counter()
                    st['load_s'] += t1 - t0
                    if sci.data.shape != (cfg.height, cfg.width):
                        raise ValueError(
                            f'shape {sci.data.shape} != pipeline bucket')
                    hit = str(ref.local_path) in ref_cache
                    with _phase('prepare'):
                        inputs = prepare_frame_inputs(sci, ref, cfg,
                                                      ref_cache=ref_cache,
                                                      device=device,
                                                      stats=st)
                    st['prepare_s'] += time.perf_counter() - t1
                    st['ref_cache_hits' if hit else 'ref_cache_misses'] += 1
                    frames.append(inputs)
                    meta.append((i, sci, ref))
                except Exception:
                    traceback.print_exc()
                    fallback(i)
            if not frames:
                continue
            # the last partial batch repeats its last frame (its outputs
            # are dropped: meta holds the real frames only)
            while len(frames) < batch:
                frames.append(frames[-1])
            t0 = time.perf_counter()
            with _phase('pipeline'):
                args = [torch.stack([f[k] for f in frames])
                        for k in INPUT_NAMES]
                pout = pipe(*args)
            st['pipeline_s'] += time.perf_counter() - t0
            if pending is not None:
                process(*pending)       # overlaps the card's work
            pending = (meta, pout, t0)
        if pending is not None:
            process(*pending)
    finally:
        if own_loader:
            loader.close()
    return results


def main(argv):
    from .mpi import get_my_share_of_work

    if len(argv) < 2:
        print(__doc__)
        return 2
    work = get_my_share_of_work(argv[1])
    batch = int(argv[2]) if len(argv) > 2 else 4
    res = run_night(work, batch=batch)
    nok = sum(1 for _, r in res if not isinstance(r, Exception))
    print(f'night: {nok}/{len(res)} pairs OK', flush=True)
    for path, r in res:
        if isinstance(r, Exception):
            print(f'  FAILED {path}: {r}', flush=True)
    return 0 if nok == len(res) else 1


if __name__ == '__main__':
    sys.exit(main(sys.argv))
