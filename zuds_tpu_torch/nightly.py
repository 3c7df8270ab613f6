"""Nightly per-pair subtraction worker of the port (twin of
``scripts/donightly.py``): ``sub.do_one`` on each work line, a
``FailedSubtraction`` row for each line that fails, so that a bad pair is
never queued again.

    python -m zuds_tpu_torch.nightly <worklist> [--device DEV]

``<worklist>`` holds one "sci_path ref_path" pair per line, each path
opened as written (relative paths from the working directory); this
process takes its share (``mpi.get_my_share_of_work``). As a process it
binds the configured database (``model_util.init_db()``, its tables made
where missing: the reference's ``donightly.py`` binds none, so what it
commits from a process is lost) and runs on the card unless ``--device``
names another device; without a card it raises. A failure is reported,
the session rolled back and, with a database bound, its reason (the
exception's text, at most 500 characters) committed; the next line runs.
The exit code is 1 if any line failed.
"""
from __future__ import annotations

import sys
import traceback

__all__ = ['run', 'main']


def run(worklist, device=None):
    """This process's share of ``worklist`` through ``sub.do_one`` on
    ``device`` (the card unless ``'cpu'``, resolved before the first line:
    without a card it raises; donightly.py:12-25). Returns
    (line, (sub, GOODCUT rows) or the exception) a line."""
    from .bookkeeping import FailedSubtraction
    from .core import DBSession
    from .inputs import resolve_device
    from .mpi import get_my_share_of_work
    from .sub import do_one

    device = resolve_device(device)
    out = []
    for line in get_my_share_of_work(worklist):
        try:
            out.append((str(line), do_one(str(line), device=device)))
        except Exception as e:
            traceback.print_exc()
            sess = DBSession()
            sess.rollback()
            if sess.conn is not None:
                sess.add(FailedSubtraction(reason=str(e)[:500]))
                sess.commit()
            out.append((str(line), e))
    return out


def main(argv):
    from .model_util import create_tables, init_db
    from .worker import report_launches, split_device, start

    argv, device = split_device(argv)
    if len(argv) < 2:
        print(__doc__)
        return 2
    device = start('nightly', device)
    init_db()
    create_tables()
    res = run(argv[1], device=device)
    report_launches('nightly')
    return 1 if any(isinstance(r, Exception) for _, r in res) else 0


if __name__ == '__main__':
    sys.exit(main(sys.argv))
