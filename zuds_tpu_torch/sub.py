"""Per-pair subtraction worker of the port (twin of ``scripts/dosub.py``):
one science frame and one reference on disk -> the subtraction, its
catalog and its filtered candidates, through
``SingleEpochSubtraction.from_images`` on the card.

    python -m zuds_tpu_torch.sub <worklist>

``<worklist>`` holds one "sci_path ref_path" pair per line; this process
takes its share (``mpi.get_my_share_of_work``). A pair that fails is
reported and the next one runs; the exit code is 1 if any failed.

This is the path of a pair the batched night run cannot take (a rotated
or badly dithered reference): ``night.run_night`` falls back to
:func:`do_one`. At ``ml=True`` (the default) the filter scores its
survivors with braai on the card. Not ported yet: the database commit and
the thumbnails (ROADMAP queue 1, item 5), which are skipped.
"""
from __future__ import annotations

import sys
import time
import traceback

import torch

__all__ = ['MAX_DETS', 'do_one', 'main', 'PHASES']

MAX_DETS = 50  # image-quality guard (dosub.py:15)
# the chain's phases as torch.profiler ranges (python -m
# zuds_tpu_torch.profile --sub); they record only while a profiler runs
PHASES = ('load', 'subtract', 'catalog', 'filter')
_phase = torch.profiler.record_function


def do_one(line, sub_class=None, ml=True, device=None, stats=None):
    """The chain for one science/reference pair (dosub.py:18-74, no
    database): load, subtract, catalog, filter (at ``ml=True`` with the
    braai score), the ``MAX_DETS`` guard. Returns (sub, GOODCUT rows), the
    rows ``Detection.from_catalog(cat, filter=True)`` would keep.
    ``device``: the card unless ``'cpu'``. ``stats`` (dict, optional)
    gains the host seconds of ``load_s``, of ``from_images``' steps, of
    ``catalog_s`` and ``filter_s`` of the subtraction, and the filter's
    ``ml_s`` and ``scored``."""
    from .coadd import ReferenceImage
    from .filterobjects import filter_sexcat
    from .image import ScienceImage
    from .inputs import resolve_device
    from .subtraction import SingleEpochSubtraction

    device = resolve_device(device)
    sub_class = sub_class or SingleEpochSubtraction
    parts = str(line).split()
    sci_path, ref_path = parts[0], parts[1]
    st = stats if stats is not None else {}

    tstart = time.time()
    with _phase('load'):
        sci = ScienceImage.from_file(sci_path)
        ref = ReferenceImage.from_file(ref_path)
        sci.data, ref.data              # from_file is lazy: read here
    st['load_s'] = st.get('load_s', 0.0) + time.time() - tstart
    print(f'took {time.time() - tstart:.2f} sec to load {sci.basename}',
          flush=True)

    t0 = time.time()
    with _phase('subtract'):
        sub = sub_class.from_images(sci, ref, device=device, stats=st)
    print(f'took {time.time() - t0:.2f} sec to make {sub.basename}',
          flush=True)

    t0 = time.time()
    with _phase('catalog'):
        cat = sub.catalog
    t1 = time.time()
    with _phase('filter'):
        filter_sexcat(cat, ml=ml, device=device, stats=st)
    detections = cat.data[cat.data['GOODCUT'] == 1]
    st['catalog_s'] = st.get('catalog_s', 0.0) + t1 - t0
    st['filter_s'] = st.get('filter_s', 0.0) + time.time() - t1
    print(f'took {time.time() - t0:.2f} sec to detect {len(detections)} '
          f'objects on {sub.basename}', flush=True)

    # image-quality guard: too many candidates = bad subtraction
    if len(detections) > MAX_DETS:
        raise RuntimeError(
            f'{sub.basename}: {len(detections)} detections exceeds '
            f'MAX_DETS={MAX_DETS}; bad image quality')
    return sub, detections


def main(argv):
    from .mpi import get_my_share_of_work

    if len(argv) < 2:
        print(__doc__)
        return 2
    failed = 0
    for line in get_my_share_of_work(argv[1]):
        try:
            do_one(str(line))
        except Exception:
            traceback.print_exc()
            failed += 1
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
