"""Science-coadd (time-bin stack) worker of the port (twin of
``scripts/dostack.py``): FITS epochs on disk -> one ``ScienceCoadd`` per
work line, through ``CoaddPipeline`` on the card.

    python -m zuds_tpu_torch.stack <worklist>

``<worklist>`` holds one "outname binleft binright scipath1 scipath2 ..."
job per line; this process takes its share (``mpi.get_my_share_of_work``).
A job that fails is reported and the next one runs; the exit code is 1 if
any failed.
"""
from __future__ import annotations

import sys
import traceback

from .coadd import ScienceCoadd
from .image import ScienceImage

__all__ = ['do_one', 'main']


def do_one(line, device=None):
    """Build the stack of one work line and save it with its bin edges in
    the header (dostack.py:14-25). ``device``: the card unless ``'cpu'``."""
    parts = str(line).split()
    outname, binleft, binright = parts[0], parts[1], parts[2]
    paths = parts[3:]
    images = [ScienceImage.from_file(p) for p in paths]
    coadd = ScienceCoadd.from_images(images, outname, device=device)
    coadd.binleft = binleft
    coadd.binright = binright
    coadd.header.set('BINLEFT', binleft)
    coadd.header.set('BINRIGHT', binright)
    coadd.save()
    return coadd


def main(argv):
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
            failed += 1
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
