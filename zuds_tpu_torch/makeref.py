"""Reference-build worker of the port (twin of ``scripts/makeref.py``):
FITS epochs of one quadrant on disk -> the quality-cut epochs -> one
``ReferenceImage``, stacked through ``CoaddPipeline`` on the card.

    python -m zuds_tpu_torch.makeref <worklist>

``<worklist>`` holds one "outname scipath1 scipath2 ..." job per line, as
``queryref`` prints them; this process takes its share
(``mpi.get_my_share_of_work``). An epoch is kept when its seeing is
1.7-2.5 arcsec (the SEEING card in pixels times the pixel scale), its
MAGLIM 19.2-22 and its INFOBITS 0; the deepest MAX_IMAGES are stacked,
and at least MIN_IMAGES must survive. A job that fails is reported, the
database session rolled back and the next one runs; the exit code is 1 if
any failed. With a database bound (``model_util.init_db()``) the
reference's ``ref`` record and its ``CoaddImage`` joins are committed.
"""
from __future__ import annotations

import sys
import traceback

__all__ = ['MIN_IMAGES', 'MAX_IMAGES', 'SEEING_RANGE_ARCSEC', 'MAGLIM_RANGE',
           'quality_cut', 'do_one', 'main']

MIN_IMAGES = 14
MAX_IMAGES = 50
SEEING_RANGE_ARCSEC = (1.7, 2.5)
MAGLIM_RANGE = (19.2, 22.0)


def quality_cut(images):
    """The epochs that pass the cuts, deepest (largest MAGLIM) first, at
    most MAX_IMAGES (makeref.py:22-40). An epoch without a SEEING or a
    MAGLIM card is dropped; one without INFOBITS counts as 0."""
    good = []
    for im in images:
        seeing_px = im.header.get('SEEING')
        maglim = im.header.get('MAGLIM')
        infobits = im.header.get('INFOBITS', 0)
        if seeing_px is None or maglim is None:
            continue
        seeing_arcsec = seeing_px * im.pixel_scale
        if not (SEEING_RANGE_ARCSEC[0] <= seeing_arcsec
                <= SEEING_RANGE_ARCSEC[1]):
            continue
        if not (MAGLIM_RANGE[0] <= maglim <= MAGLIM_RANGE[1]):
            continue
        if infobits != 0:
            continue
        good.append(im)
    good.sort(key=lambda im: -im.header['MAGLIM'])   # deepest first
    return good[:MAX_IMAGES]


def do_one(line, enforce_cuts=True, device=None, stats=None, **kwargs):
    """The reference of one work line (makeref.py:43-54): the epochs read
    by ``ScienceImage.from_file``, cut (``enforce_cuts``), and stacked by
    ``ReferenceImage.from_images`` on ``device`` (the card unless
    ``'cpu'``); ``stats`` and ``kwargs`` (``solve_astrometry`` among them)
    go to ``from_images``. Raises ``RuntimeError`` when fewer than
    MIN_IMAGES epochs survive. Returns the reference."""
    from .coadd import ReferenceImage
    from .image import ScienceImage

    parts = str(line).split()
    outname, paths = parts[0], parts[1:]
    images = [ScienceImage.from_file(p) for p in paths]
    if enforce_cuts:
        images = quality_cut(images)
    if len(images) < MIN_IMAGES:
        raise RuntimeError(
            f'{outname}: only {len(images)} epochs survive quality cuts '
            f'(need >= {MIN_IMAGES})')
    return ReferenceImage.from_images(images, outname, device=device,
                                      stats=stats, **kwargs)


def main(argv):
    from .core import DBSession
    from .mpi import get_my_share_of_work

    if len(argv) < 2:
        print(__doc__)
        return 2
    failed = 0
    for line in get_my_share_of_work(argv[1]):
        try:
            do_one(line)
        except Exception:
            traceback.print_exc()
            DBSession().rollback()
            failed += 1
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
