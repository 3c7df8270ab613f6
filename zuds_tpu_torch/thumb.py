"""Thumbnail persistence worker of the port (twin of
``scripts/dothumb.py``): render the database's unpersisted thumbnails to
PNG, in batches.

    python -m zuds_tpu_torch.thumb

binds the configured database (``model_util.init_db()``) and persists every
thumbnail whose ``file_uri`` is null, ``BATCH`` at a time, into the
configured ``base_data_directory`` (``Thumbnail.persist``). A thumbnail that
fails is reported and left unpersisted; each batch is committed.
"""
from __future__ import annotations

import sys
import traceback

__all__ = ['persist_all', 'main', 'BATCH']

BATCH = 50


def persist_all(directory=None):
    """Persist every unpersisted thumbnail of the bound database
    (dothumb.py:10-28); returns the number persisted. A batch in which
    nothing was persisted ends the loop, so a failing thumbnail is not
    tried again forever."""
    from .core import DBSession
    from .thumbnails import Thumbnail
    sess = DBSession()
    done = 0
    while True:
        rows = sess.query(Thumbnail).filter('file_uri IS NULL') \
            .limit(BATCH).all()
        if not rows:
            break
        ok = 0
        for t in rows:
            try:
                t.persist(directory)
                sess.add(t)
                ok += 1
            except Exception:
                traceback.print_exc()
        sess.commit()
        print(f'persisted {ok} of {len(rows)} thumbnails', flush=True)
        done += ok
        if ok == 0:
            break
    return done


def main(argv=None):
    from .model_util import init_db
    init_db()
    persist_all()
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
