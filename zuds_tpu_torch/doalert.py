"""Alert worker of the port (twin of ``scripts/doalert.py``): build,
commit and publish the alert of each detection id of a work list.

    python -m zuds_tpu_torch.doalert <worklist>

binds the configured database (``model_util.init_db()``); ``<worklist>``
holds one detection id per line and this process takes its share
(``mpi.get_my_share_of_work``). A packet goes to Kafka when
``kafka_brokers`` is configured, else to the spool,
``<base_data_directory>/alerts/<topic>/<candid>.avro``
(``send.send_alert``). An id that fails is reported and rolled back and
the next one runs; the exit code is 1 if any failed.
"""
from __future__ import annotations

import sys
import traceback

__all__ = ['do_one', 'main']


def do_one(detection_id):
    """The alert of detection ``detection_id``, read from the database
    (no image: no cutouts), committed and sent (doalert.py:10-20).
    Raises ``ValueError`` for an unknown id."""
    from .alert import Alert
    from .core import DBSession
    from .detections import Detection
    from .send import send_alert

    sess = DBSession()
    det = sess.query(Detection).get(int(detection_id))
    if det is None:
        raise ValueError(f'no detection {detection_id}')
    alert = Alert.from_detection(det)
    sess.add(alert)
    sess.commit()
    send_alert(alert)
    return alert


def main(argv):
    from .core import DBSession
    from .model_util import init_db
    from .mpi import get_my_share_of_work

    if len(argv) < 2:
        print(__doc__)
        return 2
    init_db()
    failed = 0
    for det_id in get_my_share_of_work(argv[1]):
        try:
            do_one(det_id)
        except Exception:
            traceback.print_exc()
            DBSession().rollback()
            failed += 1
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
