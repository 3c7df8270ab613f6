"""Forced-photometry worker of the port (twin of ``scripts/dophot.py``):
subtractions on disk and the sources in the database -> one CSV row a
(source, subtraction) pair lacking a measurement, through H22 on the card.

    python -m zuds_tpu_torch.phot <worklist> [outdir] [--device DEV]

``<worklist>`` holds one subtraction path per line; this process takes its
share (``mpi.get_my_share_of_work``). For each subtraction it lists the
sources inside its footprint with no ``forcedphotometry`` row for it (an
anti-join), measures them all in one ``aperture_photometry`` call and
writes the rows to ``phot.rank<R>.csv``; after the barrier rank 0 merges
the ranks' files into ``phot.all.csv`` under a header line. A rank stops
taking subtractions after TIME_BUDGET_S of wall clock (dophot.py:104).
The subtraction's id comes from its newest ``ZTFFile`` record
(``ScienceImage.from_file``), so a database must be bound
(``model_util.init_db()``, which the process entry :func:`cli` calls);
without one no source is listed. The process runs on the card unless
``--device`` names another device.
"""
from __future__ import annotations

import csv
import os
import sys
import time
import traceback

import numpy as np

__all__ = ['TIME_BUDGET_S', 'unphotometered_sources', 'do_one', 'main',
           'cli']

TIME_BUDGET_S = 45 * 60


def unphotometered_sources(image_id, footprint_corners):
    """(id, ra, dec) of the sources inside this image's footprint lacking
    forced photometry on it (anti-join; dophot.py:24-44)."""
    from .core import DBSession
    from .spatial import HasPoly
    sess = DBSession()
    if sess.conn is None:
        return []
    rows = sess.execute(
        'SELECT s.id, s.ra, s.dec FROM sources s WHERE NOT EXISTS '
        '(SELECT 1 FROM forcedphotometry fp WHERE fp.source_id = s.id '
        'AND fp.image_id = ?)', (image_id,)).fetchall()
    out = []
    corners = np.asarray(footprint_corners, dtype=float)
    for sid, ra, dec in rows:
        if ra is None:
            continue
        if HasPoly.poly_contains(corners, ra, dec):
            out.append((sid, ra, dec))
    return out


def do_one(path, writer, device=None, stats=None):
    """Forced photometry of the unphotometered sources on the subtraction
    at ``path`` (dophot.py:47-67): one ``aperture_photometry`` call (one H22
    launch on ``device``, the card unless ``'cpu'``), one CSV row a source
    to ``writer``. Returns the number of rows. ``stats`` (dict, optional)
    gains the host seconds of ``query_s`` (the record and the anti-join),
    ``phot_s`` (the call, the lazy read of the frames in it) and
    ``write_s``."""
    from .image import ScienceImage
    from .photometry import aperture_photometry

    st = stats if stats is not None else {}
    t0 = time.perf_counter()
    sub = ScienceImage.from_file(path)
    image_id = getattr(sub, 'id', None)
    sources = unphotometered_sources(image_id, sub.footprint())
    t1 = time.perf_counter()
    st['query_s'] = st.get('query_s', 0.0) + t1 - t0
    if not sources:
        return 0
    ras = np.array([s[1] for s in sources])
    decs = np.array([s[2] for s in sources])
    res = aperture_photometry(sub, ras, decs, apply_calibration=True,
                              assume_background_subtracted=True,
                              device=device)
    t2 = time.perf_counter()
    for (sid, ra, dec), f, fe, fl in zip(sources, res['flux'],
                                         res['fluxerr'], res['flags']):
        writer.writerow([sid, image_id, ra, dec, float(f), float(fe),
                         int(fl), res['zp'],
                         sub.header.get('OBSJD'),
                         sub.header.get('FILTER', '')])
    st['phot_s'] = st.get('phot_s', 0.0) + t2 - t1
    st['write_s'] = st.get('write_s', 0.0) + time.perf_counter() - t2
    return len(sources)


def main(worklist, outdir='.', device=None, stats=None):
    """This rank's share of the subtractions in ``worklist``, then the
    barrier and rank 0's merge (dophot.py:70-101). Returns the merged
    CSV's path on rank 0, else None. ``device``: the card unless
    ``'cpu'``. ``stats`` (dict, optional) gains, a subtraction each, the
    lists ``paths``, ``rows`` and ``do_one_s`` (host seconds), and
    :func:`do_one`'s sums."""
    from .mpi import barrier, get_my_share_of_work, rank_info

    rank, size = rank_info()
    st = stats if stats is not None else {}
    for k in ('paths', 'rows', 'do_one_s'):
        st.setdefault(k, [])
    t_start = time.time()
    outfile = os.path.join(outdir, f'phot.rank{rank}.csv')
    n_done = 0
    with open(outfile, 'w', newline='') as f:
        writer = csv.writer(f)
        for path in get_my_share_of_work(worklist):
            if time.time() - t_start > TIME_BUDGET_S:
                print('time budget exhausted; stopping', flush=True)
                break
            try:
                t0 = time.perf_counter()
                n = do_one(str(path), writer, device=device, stats=st)
                st['paths'].append(str(path))
                st['rows'].append(n)
                st['do_one_s'].append(time.perf_counter() - t0)
                n_done += n
            except Exception:
                traceback.print_exc()
                continue
    print(f'rank {rank}: {n_done} measurements', flush=True)

    barrier()
    if rank == 0:
        merged = os.path.join(outdir, 'phot.all.csv')
        with open(merged, 'w') as out:
            out.write('source_id,image_id,ra,dec,flux,fluxerr,flags,zp,'
                      'obsjd,filtercode\n')
            for r in range(size):
                part = os.path.join(outdir, f'phot.rank{r}.csv')
                if os.path.exists(part):
                    with open(part) as pf:
                        out.write(pf.read())
        print(f'merged -> {merged}', flush=True)
        return merged


def cli(argv):
    """The process entry: bind the configured database (its tables made
    where missing: the reference's ``dophot.py`` binds none, so a process
    of it lists no source), start on the card unless ``--device`` names
    another device (without a card it raises), then :func:`main`."""
    from .model_util import create_tables, init_db
    from .worker import report_launches, split_device, start

    argv, device = split_device(argv)
    if len(argv) < 2:
        print(__doc__)
        return 2
    device = start('phot', device)
    init_db()
    create_tables()
    main(argv[1], argv[2] if len(argv) > 2 else '.', device=device)
    report_launches('phot')
    return 0


if __name__ == '__main__':
    sys.exit(cli(sys.argv))
