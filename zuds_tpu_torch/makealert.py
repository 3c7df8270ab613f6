"""Alert backfill of the port (twin of ``scripts/makealert.py``): one
``Alert`` row for every alert-ready detection that has none, built and
committed, not published.

    python -m zuds_tpu_torch.makealert

binds the configured database (``model_util.init_db()``). The detections
are read from it, so each carries its ``image_id`` and no image: their
alerts have no image metadata and no cutouts, as in the reference.
"""
from __future__ import annotations

import traceback

__all__ = ['main']


def main():
    """Bind the configured database and build and commit one alert for
    each detection with ``alert_ready = 1`` and no ``alerts`` row (the
    anti-join of makealert.py:14-17); a detection that fails is reported
    and rolled back. Returns the number of alerts committed."""
    from .alert import Alert
    from .core import DBSession
    from .detections import Detection
    from .model_util import init_db

    init_db()
    sess = DBSession()
    rows = sess.execute(
        'SELECT d.id FROM detections d WHERE d.alert_ready = 1 AND NOT '
        'EXISTS (SELECT 1 FROM alerts a WHERE a.detection_id = d.id)'
    ).fetchall()
    made = 0
    for (det_id,) in rows:
        try:
            det = sess.query(Detection).get(det_id)
            sess.add(Alert.from_detection(det))
            sess.commit()
            made += 1
        except Exception:
            traceback.print_exc()
            sess.rollback()
    return made


if __name__ == '__main__':
    main()
