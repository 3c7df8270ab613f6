"""The database commit of one subtraction, shared by the batched night
(``night._commit_frame``) and the per-pair chain (``sub.do_one``): the
``sesub`` record, its ``Detection`` rows and three thumbnails each
(donight.py:184-204, dosub.py:53-72)."""
from __future__ import annotations

import time

__all__ = ['COMMIT_SPANS', 'commit_subtraction']

# the host seconds a commit adds to ``stats``: the frames fetched and
# written, the detections built from the catalog, the record built, the
# record's commit, the detections' commit, their sum, the thumbnails
COMMIT_SPANS = ('frames_s', 'detect_s', 'record_s', 'record_commit_s',
                'detect_commit_s', 'db_s', 'thumb_s')


def commit_subtraction(sub, sci, ref, cat, stats=None):
    """When a database is bound: fetch the deferred frames and write the
    product files (a subtraction with nothing deferred has none to
    fetch), then the ``sesub`` record with ``target_id``/``reference_id``
    from the images' ids, the catalog's ``Detection`` rows
    (``Detection.from_catalog(cat, filter=True)``: the catalog is
    FILTERED already, so the filter and braai do not run again), and the
    ``sub``, ``new`` and ``ref`` thumbnails of each. ``stats`` gains the
    host seconds of :data:`COMMIT_SPANS` (``db_s``: detections, record
    and both commits). Returns the record, or None with no database
    bound."""
    from .core import DBSession, record_from_image
    from .detections import Detection
    from .thumbnails import Thumbnail

    sess = DBSession()
    if sess.conn is None:
        return None
    st = stats if stats is not None else {}
    t = [time.perf_counter()]
    sub._materialize_frames()
    t.append(time.perf_counter())
    detections = Detection.from_catalog(cat, filter=True)
    t.append(time.perf_counter())
    rec = record_from_image(sub, 'sesub')
    rec.target_id = getattr(sci, 'id', None)
    rec.reference_id = getattr(ref, 'id', None)
    t.append(time.perf_counter())
    sess.add(rec)
    sess.commit()
    t.append(time.perf_counter())
    for d in detections:
        d.image_id = rec.id
        sess.add(d)
    sess.commit()
    t.append(time.perf_counter())
    for d in detections:
        for stamp_type, img in [('sub', sub), ('new', sci), ('ref', ref)]:
            sess.add(Thumbnail.from_detection(d, img,
                                              stamp_type=stamp_type))
    sess.commit()
    t.append(time.perf_counter())
    spans = dict(zip(COMMIT_SPANS[:5], (b - a for a, b in zip(t, t[1:]))))
    spans['db_s'] = t[5] - t[1]
    spans['thumb_s'] = t[6] - t[5]
    for key, secs in spans.items():
        st[key] = st.get(key, 0.0) + secs
    return rec
