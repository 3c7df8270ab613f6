"""Science-stack work lists (twin of ``scripts/querystack.py``): the
``sci`` records of each quadrant binned into 7-day windows, one
``stack`` line a window with at least two epochs.

    python -m zuds_tpu_torch.querystack

binds the configured database (``model_util.init_db()``) and prints one
"outname binleft binright basename1 basename2 ..." line a window, the
lines ``python -m zuds_tpu_torch.stack`` takes.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

__all__ = ['WINDOW_DAYS', 'stack_windows', 'main']

WINDOW_DAYS = 7.0


def stack_windows(rows):
    """The work lines of ``rows``, (basename, field, ccdid, qid, fid, mjd,
    path) tuples (querystack.py:11-34): per quadrant, windows of
    WINDOW_DAYS from the floor of its first MJD; a window with fewer than
    two epochs is skipped. Lines are sorted by quadrant, then window; the
    epochs of a window by MJD."""
    groups = defaultdict(list)
    for basename, field, ccdid, qid, fid, mjd, path in rows:
        groups[(field, ccdid, qid, fid)].append((mjd, path))
    lines = []
    for (field, ccdid, qid, fid), items in sorted(groups.items()):
        items.sort()
        mjds = np.array([m for m, _ in items])
        start = np.floor(mjds.min())
        nbins = int(np.ceil((mjds.max() - start + 1e-9) / WINDOW_DAYS)) or 1
        for b in range(nbins):
            lo = start + b * WINDOW_DAYS
            hi = lo + WINDOW_DAYS
            sel = [(m, p) for m, p in items if lo <= m < hi]
            if len(sel) < 2:
                continue
            outname = (f'stack_{field:06d}_c{ccdid:02d}_q{qid}_{fid}_'
                       f'{int(lo)}_{int(hi)}.fits')
            lines.append(' '.join([outname, f'{lo:.1f}', f'{hi:.1f}']
                                  + [p for _, p in sel]))
    return lines


def main():
    """Print and return the work lines of the bound database's ``sci``
    records that have an ``obsjd`` (querystack.py:37-46)."""
    from .core import DBSession
    sess = DBSession()
    rows = sess.execute(
        'SELECT basename, field, ccdid, qid, fid, obsjd - 2400000.5, '
        'basename FROM ztffiles WHERE type = \'sci\' AND obsjd IS NOT NULL'
    ).fetchall()
    lines = stack_windows(rows)
    for line in lines:
        print(line)
    return lines


if __name__ == '__main__':
    from .model_util import init_db
    init_db()
    main()
