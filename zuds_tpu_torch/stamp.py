"""Best-detection stamp worker of the port (twin of
``scripts/dostamp.py``): a thumbnail of each source's best detection.

    python -m zuds_tpu_torch.stamp <worklist>

binds the configured database (``model_util.init_db()``); ``<worklist>``
holds one source id per line, of which this process takes its share
(``mpi.get_my_share_of_work``). A source that fails is reported, the
session rolled back and the next one runs; the exit code is 1 if any
failed. The thumbnails are committed as gzip-FITS rows; ``python -m
zuds_tpu_torch.thumb`` renders them to PNG (``Thumbnail.persist``).
"""
from __future__ import annotations

import sys
import traceback

__all__ = ['do_one', 'main']


def do_one(source_id):
    """A ``sub`` thumbnail of the source's best detection (the highest
    S/N), cut from the detection's ``image`` and committed with the
    source's id (dostamp.py:11-29). Raises ``ValueError`` for an unknown
    source; returns None when the source has no detection or its best one
    carries no image (a detection read back from the database has only its
    ``image_id``, as in the reference), else the thumbnail."""
    from .core import DBSession
    from .source import Source
    from .thumbnails import Thumbnail
    sess = DBSession()
    src = sess.query(Source).filter_by(id=str(source_id)).first()
    if src is None:
        raise ValueError(f'no source {source_id}')
    best = src.best_detection
    if best is None:
        return None
    image = getattr(best, 'image', None)
    if image is None:
        return None
    t = Thumbnail.from_detection(best, image)
    t.source_id = src.id
    sess.add(t)
    sess.commit()
    return t


def main(argv):
    from .core import DBSession
    from .model_util import init_db
    from .mpi import get_my_share_of_work

    if len(argv) < 2:
        print(__doc__)
        return 2
    init_db()
    failed = 0
    for sid in get_my_share_of_work(argv[1]):
        try:
            do_one(sid)
        except Exception:
            traceback.print_exc()
            DBSession().rollback()
            failed += 1
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
