"""Bulk load of external catalogs into the local crossmatch tables (twin
of ``scripts/load_catalogs.py``), onto the port's ``external`` models:

    python -m zuds_tpu_torch.load_catalogs ps1 ps1_dump.csv
    python -m zuds_tpu_torch.load_catalogs milliquas milliquas.csv
    python -m zuds_tpu_torch.load_catalogs tns tns.csv
    python -m zuds_tpu_torch.load_catalogs ztf_names names.csv
    python -m zuds_tpu_torch.load_catalogs clu clu.csv
    python -m zuds_tpu_torch.load_catalogs dr8north sweep.csv

A CSV column fills the model column of the same name (case-insensitive);
the others go into the ``extra`` JSON blob where the model has one, and
are dropped where it has none. Empty cells are skipped. Rows are
committed in chunks of CHUNK, so a catalog of millions of rows loads in
bounded memory.
"""
from __future__ import annotations

import csv
import json
import sys

__all__ = ['CHUNK', 'load_csv']

CHUNK = 5000


def _models():
    from . import external
    return {
        'ps1': external.PS1,
        'milliquas': external.Milliquas,
        'tns': external.TNSSource,
        'ztf_names': external.ZTFName,
        'clu': external.CLU,
        'dr8north': external.DR8North,
        'dr8south': external.DR8South,
    }


def load_csv(table, path, session=None):
    """Stream ``path`` into the local table ``table`` (load_catalogs.py:
    41-80); without ``session`` the configured database is bound
    (``model_util.init_db()``). Returns the number of rows loaded."""
    from .core import DBSession
    from .model_util import init_db

    model = _models()[table]
    if session is None:
        init_db()
        session = DBSession()
    cols = {c.lower(): c for c in model.__columns__}
    has_extra = 'extra' in cols
    n = 0
    with open(path, newline='') as f:
        reader = csv.DictReader(f)
        batch = []
        for row in reader:
            kw, extra = {}, {}
            for k, v in row.items():
                if v in (None, ''):
                    continue
                lk = k.strip().lower()
                if lk in cols:
                    kw[cols[lk]] = v
                else:
                    extra[k] = v
            if extra and has_extra:
                kw['extra'] = json.dumps(extra)
            batch.append(model(**kw))
            if len(batch) >= CHUNK:
                for obj in batch:
                    session.add(obj)
                session.commit()
                n += len(batch)
                batch = []
        for obj in batch:
            session.add(obj)
        session.commit()
        n += len(batch)
    print(f'loaded {n} rows into {table}', flush=True)
    return n


if __name__ == '__main__':
    if len(sys.argv) < 3 or sys.argv[1] not in _models():
        print(f'usage: python -m zuds_tpu_torch.load_catalogs '
              f'{{{"|".join(_models())}}} file.csv', file=sys.stderr)
        sys.exit(2)
    load_csv(sys.argv[1], sys.argv[2])
