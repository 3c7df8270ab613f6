"""Archive and retrieval daemon of the port (twin of
``control/archive_daemon.py``; the reference is nersc/retrieve.py and
download.py).

    python -m zuds_tpu_torch.control.archive_daemon [cold_dir]

binds the configured database and tars up to TAR_SIZE unarchived science
products of the hot tier (the configured ``base_data_directory``) into one
tarball of the cold tier (``cold_dir``, default ``/tmp/zuds-tpu-cold``),
one ``TapeArchive`` row a tarball and one ``TapeCopy`` row a member.
``retrieve_from_cold`` brings products back, each tarball read once, the
tarballs in the order of their places on the medium (``media_locator``:
``hsi ls -P`` where ``hsi`` exists, else the file's device and inode).
The SQL is the reference's, its string literal in double quotes, which
sqlite reads as a string (ROADMAP section 3).
"""
from __future__ import annotations

import os
import sys
import tarfile
import time

__all__ = ['CHUNK', 'TAR_SIZE', 'archive_to_cold', 'media_locator',
           'retrieve_from_cold', 'main']

CHUNK = 256        # files per retrieval batch (reference download.py:21)
TAR_SIZE = 1024    # members per archive tarball (reference download.py:22)


def archive_to_cold(session, cold_dir):
    """Tar the science products with no ``TapeCopy`` into a new tarball
    ``zuds_<unix time>.tar`` of ``cold_dir`` (archive_daemon.py:21-53).
    Returns its path, or None when nothing was archived."""
    from ..archive import TapeArchive, TapeCopy
    from ..secrets import get_secret
    rows = session.execute(
        'SELECT z.id, z.basename FROM ztffiles z WHERE z.type = "sci" AND '
        'NOT EXISTS (SELECT 1 FROM tapecopies t WHERE t.product_id = z.id) '
        f'LIMIT {TAR_SIZE}').fetchall()
    if not rows:
        return None
    os.makedirs(cold_dir, exist_ok=True)
    name = f'zuds_{int(time.time())}.tar'
    tar_path = os.path.join(cold_dir, name)
    arc = TapeArchive(name=name, status='writing')
    session.add(arc)
    session.commit()
    hot = get_secret('base_data_directory', '/tmp/zuds-tpu-data')
    n = 0
    with tarfile.open(tar_path, 'w') as tf:
        for pid, basename in rows:
            src = os.path.join(hot, basename)
            if not os.path.exists(src):
                continue
            tf.add(src, arcname=basename)
            session.add(TapeCopy(type='tape', product_id=pid, tarname=name,
                                 member_name=basename))
            n += 1
    arc.status = 'done'
    arc.size = os.path.getsize(tar_path)
    session.add(arc)
    session.commit()
    return tar_path if n else None


def media_locator(paths):
    """{path: (tape, position)} of each archive path that exists, the sort
    key that makes sequential-media retrieval monotone
    (archive_daemon.py:56-105): ``hsi ls -P``'s FILE lines (position field
    5 as 'pos+offset', tape field 6) where ``hsi`` exists, else the
    filesystem's (device, inode)."""
    import shutil
    import subprocess
    out = {}
    hsi = shutil.which('hsi')
    if hsi:
        try:
            cmds = '\n'.join(f'ls -P {p}' for p in paths) + '\n'
            r = subprocess.run([hsi, 'in', '/dev/stdin'], input=cmds,
                               capture_output=True, text=True, timeout=600)
            # 64 = some files missing; acceptable (reference retrieve.py)
            if r.returncode in (0, 64):
                for line in (r.stdout or '').splitlines():
                    parts = line.split()
                    if len(parts) >= 6 and parts[0] == 'FILE':
                        pos = parts[4].split('+')[0]
                        tape = parts[5][:-2] if len(parts[5]) > 2 \
                            else parts[5]
                        try:
                            pos = int(pos)
                        except ValueError:
                            pass
                        out[parts[1]] = (tape, pos)
                if out:
                    return out
        except (OSError, subprocess.SubprocessError):
            pass
    for p in paths:
        try:
            st = os.stat(p)
            out[p] = (str(st.st_dev), st.st_ino)
        except OSError:
            continue
    return out


def retrieve_from_cold(session, basenames, cold_dir, dest_dir):
    """Extract ``basenames`` from the newest tarball that holds each into
    ``dest_dir``, grouped a tarball and in ``media_locator`` order
    (archive_daemon.py:108-139); returns the restored paths."""
    from collections import defaultdict
    by_tar = defaultdict(list)
    for basename in basenames:
        row = session.execute(
            'SELECT tarname FROM tapecopies WHERE member_name = ? '
            'ORDER BY id DESC LIMIT 1', (basename,)).fetchone()
        if row:
            by_tar[row[0]].append(basename)
    os.makedirs(dest_dir, exist_ok=True)
    paths = {t: os.path.join(cold_dir, t) for t in by_tar}
    loc = media_locator([p for p in paths.values() if os.path.exists(p)])
    ordered = sorted(by_tar.items(),
                     key=lambda kv: loc.get(paths[kv[0]], ('~', 1 << 62)))
    restored = []
    for tarname, members in ordered:
        path = paths[tarname]
        if not os.path.exists(path):
            continue
        with tarfile.open(path) as tf:
            for m in members:
                try:
                    tf.extract(m, dest_dir)
                    restored.append(os.path.join(dest_dir, m))
                except KeyError:
                    continue
    return restored


def main(argv=None):
    from ..core import DBSession
    from ..model_util import init_db
    argv = sys.argv if argv is None else argv
    init_db()
    cold = argv[1] if len(argv) > 1 else '/tmp/zuds-tpu-cold'
    out = archive_to_cold(DBSession(), cold)
    print(f'archived -> {out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
