"""Source association daemon of the port (twin of
``control/makesources.py``; the reference is nersc/makesources.py).

    python -m zuds_tpu_torch.control.makesources [--once]

binds the configured database and, every ``poll_s`` seconds, associates
the GOODCUT detections that have no source:

1. each is matched to an existing source within MATCH_RADIUS_DEG (the
   reference's q3c join, makesources.py:263-286) and flagged
   ``triggers_alert``;
2. the leftovers with rb > RB_ASSOC_MIN are clustered at the same radius
   (single linkage, the membership of the reference's DBSCAN with
   min_samples 1, makesources.py:303-340); each cluster of at least
   MIN_CLUSTER detections becomes a new named source and its detections
   are flagged ``triggers_alert`` and ``triggers_phot``.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from ..constants import MATCH_RADIUS_DEG, RB_ASSOC_MIN

__all__ = ['MIN_CLUSTER', 'cluster_positions', 'generate_source_name',
           'associate', 'main']

MIN_CLUSTER = 2


def cluster_positions(ra, dec, radius_deg=MATCH_RADIUS_DEG):
    """Single-linkage labels (N,) at ``radius_deg`` (makesources.py:26-81):
    a union-find over the pairs found by hashing the unit vectors into
    cubes of side 2 sin(r / 2), the chord of ``radius_deg``, and testing
    each point against the 27 cubes around its own. Exact at every
    declination, across RA 0/360 and at the poles. A label is the index
    of the cluster's root."""
    from ..spatial import angular_distance
    n = len(ra)
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i, j):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[rj] = ri

    if n == 0:
        return parent
    ra_r = np.radians(np.asarray(ra, float))
    dec_r = np.radians(np.asarray(dec, float))
    cosd = np.cos(dec_r)
    xyz = np.stack([cosd * np.cos(ra_r), cosd * np.sin(ra_r),
                    np.sin(dec_r)], axis=1)
    cell = 2.0 * np.sin(np.radians(radius_deg) / 2.0)
    buckets = {}
    keys = np.floor(xyz / cell).astype(int)
    for i, key in enumerate(map(tuple, keys)):
        buckets.setdefault(key, []).append(i)
    for (ci, cj, ck), members in buckets.items():
        cand = []
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for dk in (-1, 0, 1):
                    cand.extend(buckets.get((ci + di, cj + dj, ck + dk), ()))
        for i in members:
            for j in cand:
                if j <= i:
                    continue
                if angular_distance(ra[i], dec[i],
                                    ra[j], dec[j]) <= radius_deg:
                    union(i, j)
    return np.array([find(i) for i in range(n)])


def generate_source_name(session):
    """``ZUDS<yy><6 letters>``: the UTC year and the count of sources in
    base 26 (makesources.py:84-95)."""
    import datetime
    yy = datetime.datetime.now(datetime.timezone.utc).strftime('%y')
    count = session.execute(
        'SELECT COUNT(*) FROM sources').fetchone()[0]
    suffix = ''
    k = count
    for _ in range(6):
        suffix = chr(ord('a') + k % 26) + suffix
        k //= 26
    return f'ZUDS{yy}{suffix}'


def associate(session):
    """One association pass (makesources.py:98-150). Returns
    (detections matched to a source, new sources)."""
    from ..detections import Detection
    from ..source import Source
    from ..spatial import cone_where

    unassigned = session.query(Detection).filter(
        'source_id IS NULL AND goodcut = 1').all()
    if not unassigned:
        return 0, 0

    # stage 1: match against existing sources
    matched = 0
    leftovers = []
    for det in unassigned:
        where, params = cone_where(det.ra, det.dec, MATCH_RADIUS_DEG)
        src = session.query(Source).filter(where, *params).first()
        if src is not None:
            det.source_id = src.id
            det.triggers_alert = 1
            session.add(det)
            matched += 1
        else:
            leftovers.append(det)
    session.commit()

    # stage 2: cluster high-rb leftovers into new sources
    clusterable = [d for d in leftovers
                   if d.rb is not None and d.rb > RB_ASSOC_MIN]
    n_new = 0
    if len(clusterable) >= MIN_CLUSTER:
        ra = np.array([d.ra for d in clusterable])
        dec = np.array([d.dec for d in clusterable])
        labels = cluster_positions(ra, dec)
        for lab in np.unique(labels):
            members = [clusterable[i] for i in np.nonzero(labels == lab)[0]]
            if len(members) < MIN_CLUSTER:
                continue
            name = generate_source_name(session)
            src = Source(id=name,
                         ra=float(np.mean([m.ra for m in members])),
                         dec=float(np.mean([m.dec for m in members])),
                         origin='zuds-tpu')
            session.add(src)
            session.commit()
            for m in members:
                m.source_id = name
                m.triggers_alert = 1
                m.triggers_phot = 1
                session.add(m)
            session.commit()
            n_new += 1
    return matched, n_new


def main(once=False, poll_s=60):
    """Bind the configured database, then one :func:`associate` pass every
    ``poll_s`` seconds (one with ``once``); a pass that raises is
    reported and rolled back."""
    from ..core import DBSession
    from ..model_util import init_db
    init_db()
    while True:
        sess = DBSession()
        try:
            matched, new = associate(sess)
            print(f'associated {matched} detections; named {new} new '
                  f'sources', flush=True)
        except Exception:
            import traceback
            traceback.print_exc()
            sess.rollback()
        if once:
            break
        time.sleep(poll_s)


if __name__ == '__main__':
    main(once='--once' in sys.argv)
