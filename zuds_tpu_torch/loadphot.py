"""Bulk load of forced photometry into the database (twin of
``scripts/loadphot.py``): the CSV that ``phot.main`` merges
(``phot.all.csv``) -> ``forcedphotometry`` rows, closing dophot's chain.

    python -m zuds_tpu_torch.loadphot <csv>

binds the configured database (``model_util.init_db()``). The rows go in
with ``INSERT OR REPLACE`` inside one transaction: a (source, image) pair
measured again replaces its row (``forcedphotometry``'s unique index).
This is the sqlite dialect, as in the reference; its postgres table swap
has no counterpart here.
"""
from __future__ import annotations

import csv
import sys

__all__ = ['load']


def load(csv_path):
    """Insert or replace one ``forcedphotometry`` row a line of
    ``csv_path`` (its ``source_id``, ``image_id``, ``flux``, ``fluxerr``,
    ``zp``, ``filtercode``, ``obsjd`` and ``flags`` columns; the others are
    ignored), in one transaction (loadphot.py:13-33). Returns the number
    of rows. Raises ``RuntimeError`` when no database is bound."""
    from .core import DBSession
    sess = DBSession()
    if sess.conn is None:
        raise RuntimeError('init_db() first')
    conn = sess.conn
    with open(csv_path) as f:
        reader = csv.DictReader(f)
        rows = [(r['source_id'], r['image_id'], r['flux'], r['fluxerr'],
                 r['zp'], r['filtercode'], r['obsjd'], r['flags'])
                for r in reader]
    conn.execute('BEGIN')
    conn.executemany(
        'INSERT OR REPLACE INTO forcedphotometry '
        '(source_id, image_id, flux, fluxerr, zp, filtercode, obsjd, flags) '
        'VALUES (?, ?, ?, ?, ?, ?, ?, ?)', rows)
    conn.commit()
    print(f'loaded {len(rows)} measurements from {csv_path}', flush=True)
    return len(rows)


if __name__ == '__main__':
    if len(sys.argv) < 2:
        print(__doc__)
        sys.exit(2)
    from .model_util import init_db
    init_db()
    load(sys.argv[1])
