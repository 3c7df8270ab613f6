"""Reference-build work lists (twin of ``scripts/queryref.py``): the
quadrants with at least ``min_epochs`` science records and no reference of
the port's ``REFERENCE_VERSION``, one ``makeref`` line each.

    python -m zuds_tpu_torch.queryref [min_epochs]

binds the configured database (``model_util.init_db()``) and prints one
"outname basename1 basename2 ..." line a quadrant, the epochs by their
record's basename (``makeref`` opens them from the working directory).
"""
from __future__ import annotations

import sys

from .constants import REFERENCE_VERSION

__all__ = ['main']


def main(min_epochs=14):
    """Print and return the work lines (queryref.py:9-30): per (field,
    ccdid, qid, fid) with at least ``min_epochs`` ``sci`` records and no
    ``ref`` record of ``REFERENCE_VERSION``, the reference's name
    ``ref_<field>_c<ccdid>_q<qid>_<fid>_<version>.fits`` and the
    epochs' basenames."""
    from .core import DBSession
    sess = DBSession()
    rows = sess.execute(
        'SELECT field, ccdid, qid, fid, COUNT(*) as n FROM ztffiles '
        'WHERE type = \'sci\' GROUP BY field, ccdid, qid, fid '
        'HAVING n >= ? ', (min_epochs,)).fetchall()
    lines = []
    for field, ccdid, qid, fid, n in rows:
        has_ref = sess.execute(
            'SELECT 1 FROM ztffiles WHERE type = \'ref\' AND field = ? AND '
            'ccdid = ? AND qid = ? AND fid = ? AND version = ? LIMIT 1',
            (field, ccdid, qid, fid, REFERENCE_VERSION)).fetchone()
        if has_ref:
            continue
        paths = [r[0] for r in sess.execute(
            'SELECT basename FROM ztffiles WHERE type = \'sci\' AND '
            'field = ? AND ccdid = ? AND qid = ? AND fid = ?',
            (field, ccdid, qid, fid)).fetchall()]
        outname = (f'ref_{field:06d}_c{ccdid:02d}_q{qid}_{fid}_'
                   f'{REFERENCE_VERSION}.fits')
        lines.append(' '.join([outname] + paths))
        print(lines[-1])
    return lines


if __name__ == '__main__':
    from .model_util import init_db
    init_db()
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 14)
