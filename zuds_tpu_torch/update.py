"""IPAC metadata reflection (twin of ``scripts/update.py``): new ZTF
science-image metadata from the IRSA TAP service -> ``sci`` and ``mask``
``ZTFFile`` records, so that ``queryref``, ``querystack`` and the nightly
queues see the images before their pixels are downloaded.

    python -m zuds_tpu_torch.update

The query, the parse and the insert are the reference's; the fetch is
injected into :func:`sync`, so it runs on a canned CSV response with no
network. :func:`fetch_metatable` (one HTTP GET with ``requests``, an
optional import) runs only from :func:`main`, and only with the config's
``ipac_username`` set and ``requests`` importable.
"""
from __future__ import annotations

import csv
import io
import json
import sys
import urllib.parse

__all__ = ['QUERY_WINDOWSIZE', 'TAP_URL', 'META_TABLE', 'META_COLUMNS',
           'build_query', 'fetch_metatable', 'parse_metatable',
           'rows_to_records', 'sync', 'main']

QUERY_WINDOWSIZE = 30  # days (NID is a night id, ~1 a day)
TAP_URL = 'https://irsa.ipac.caltech.edu/TAP/sync'
META_TABLE = 'ztf.ztf_current_meta_sci'

# IRSA meta columns -> ScienceImage attributes (update.py:21-29)
META_COLUMNS = [
    'field', 'ccdid', 'qid', 'fid', 'filtercode', 'imgtypecode',
    'filefracday', 'obsjd', 'infobits', 'pid', 'nid', 'expid', 'seeing',
    'airmass', 'moonillf', 'moonesb', 'maglimit', 'crpix1', 'crpix2',
    'crval1', 'crval2', 'cd11', 'cd12', 'cd21', 'cd22', 'ra', 'dec',
    'ra1', 'dec1', 'ra2', 'dec2', 'ra3', 'dec3', 'ra4', 'dec4',
    'ipac_gid', 'exptime',
]
_INT_COLS = {'field', 'ccdid', 'qid', 'fid', 'filefracday', 'infobits',
             'pid', 'nid', 'expid', 'ipac_gid'}
_STR_COLS = {'filtercode', 'imgtypecode'}
# the header keywords each metadata column becomes (image.py's reflection)
_HDR_KEYS = {
    'obsjd': 'OBSJD', 'infobits': 'INFOBITS', 'pid': 'DBPID',
    'nid': 'DBNID', 'expid': 'DBEXPID', 'seeing': 'SEEING',
    'airmass': 'AIRMASS', 'moonillf': 'MOONILLF', 'moonesb': 'MOONESB',
    'maglimit': 'MAGLIM', 'crpix1': 'CRPIX1', 'crpix2': 'CRPIX2',
    'crval1': 'CRVAL1', 'crval2': 'CRVAL2', 'cd11': 'CD1_1',
    'cd12': 'CD1_2', 'cd21': 'CD2_1', 'cd22': 'CD2_2',
    'ipac_gid': 'PROGRMID', 'exptime': 'EXPTIME', 'field': 'FIELDID',
    'ccdid': 'CCDID', 'qid': 'QID', 'fid': 'FILTERID',
}
# the survey's first night (update.py:27-29)
_START_JD, _START_NID = 2458165.6030208, 411


def build_query(nid_lo, nid_hi):
    """ADQL for one NID window of public and partnership data
    (``ipac_gid > 0``; update.py:35-43)."""
    cols = ', '.join(META_COLUMNS)
    return (f'SELECT {cols} FROM {META_TABLE} '
            f'WHERE nid >= {int(nid_lo)} AND nid <= {int(nid_hi)} '
            f'AND ipac_gid > 0')


def fetch_metatable(nid_lo, nid_hi, auth=None):
    """The TAP service's CSV response to :func:`build_query` (one HTTP
    GET; ``requests`` is imported here, and only here)."""
    import requests
    params = {'QUERY': build_query(nid_lo, nid_hi), 'FORMAT': 'CSV'}
    url = TAP_URL + '?' + urllib.parse.urlencode(params)
    resp = requests.get(url, auth=auth, timeout=300)
    resp.raise_for_status()
    return resp.text


def parse_metatable(csv_text):
    """Typed row dicts keyed by META_COLUMNS from a TAP CSV response
    (update.py:56-73): empty and ``null`` cells None, the string columns
    stripped, the integer columns through float."""
    rows = []
    reader = csv.DictReader(io.StringIO(csv_text))
    for raw in reader:
        row = {}
        for col in META_COLUMNS:
            val = raw.get(col)
            if val is None or val == '' or val.lower() == 'null':
                row[col] = None
            elif col in _STR_COLS:
                row[col] = val.strip()
            elif col in _INT_COLS:
                row[col] = int(float(val))
            else:
                row[col] = float(val)
        rows.append(row)
    return rows


def _ipac_basename(row, suffix='sciimg.fits'):
    """The IPAC product basename of a metadata row (update.py:76-82)."""
    sffd = str(row['filefracday'])
    return (f'ztf_{sffd}_{row["field"]:06d}_{row["filtercode"]}_c'
            f'{row["ccdid"]:02d}_{row["imgtypecode"]}_q{row["qid"]}_'
            f'{suffix}')


def rows_to_records(rows):
    """(sci, mask) ``ZTFFile`` record pairs of parsed metadata rows
    (update.py:85-121). The row rides in the ``sci`` record's header JSON
    under the header keywords ``ScienceImage.from_file`` reflects, so a
    later download of the pixels gives the same record."""
    from .core import ZTFFile
    pairs = []
    for row in rows:
        base = _ipac_basename(row)
        hdr = {kw: row[col] for col, kw in _HDR_KEYS.items()
               if row.get(col) is not None}
        hdr['FILENAME'] = base
        common = {k: row[k] for k in
                  ('field', 'ccdid', 'qid', 'fid', 'ra', 'dec', 'ra1',
                   'dec1', 'ra2', 'dec2', 'ra3', 'dec3', 'ra4', 'dec4')}
        sci = ZTFFile(type='sci', basename=base, header=json.dumps(hdr),
                      seeing=row.get('seeing'), maglimit=row.get('maglimit'),
                      obsjd=row.get('obsjd'), infobits=row.get('infobits'),
                      **common)
        mask = ZTFFile(type='mask', **common,
                       basename=base.replace('sciimg', 'mskimg'))
        pairs.append((sci, mask))
    return pairs


def sync(fetch=fetch_metatable, auth=None, now_jd=None):
    """Reflect the metadata of the nights since the newest ``sci`` record
    into the bound database (update.py:124-178): windows of
    QUERY_WINDOWSIZE nights from its ``DBNID`` (the survey's first night
    without one) up to ``now_jd`` (the clock's when None), each fetched by
    ``fetch(nid_lo, nid_hi, auth=auth)``; a basename already recorded is
    skipped, also when two windows return it. Each mask record gets its
    science record's id as ``parent_id``. Returns the number of images
    inserted."""
    from .core import DBSession, ZTFFile

    session = DBSession()
    sm = session.query(ZTFFile).filter_by(type='sci') \
        .order_by('obsjd DESC').first()
    if sm is None or sm.obsjd is None:
        max_jd, max_nid = _START_JD, _START_NID
    else:
        max_jd = sm.obsjd
        try:
            max_nid = int(json.loads(sm.header or '{}').get('DBNID',
                                                            _START_NID))
        except (ValueError, TypeError):
            max_nid = _START_NID

    if now_jd is None:
        import time
        now_jd = time.time() / 86400.0 + 2440587.5
    n_chunks = int((now_jd - max_jd) // QUERY_WINDOWSIZE) + 1

    rows = []
    for i in range(n_chunks):
        nid_lo = max_nid + i * QUERY_WINDOWSIZE
        nid_hi = max_nid + (i + 1) * QUERY_WINDOWSIZE
        rows.extend(parse_metatable(fetch(nid_lo, nid_hi, auth=auth)))
    print(f'pulled {len(rows)} images', flush=True)

    existing = {r.basename for r in
                session.query(ZTFFile).filter_by(type='sci').all()}

    inserted = []
    for sci, mask in rows_to_records(rows):
        if sci.basename in existing:
            continue
        existing.add(sci.basename)
        session.add(sci)
        session.add(mask)
        inserted.append((sci, mask))
    session.commit()
    # the ids exist after the first commit: link each mask to its image
    for sci, mask in inserted:
        mask.parent_id = sci.id
        session.add(mask)
    if inserted:
        session.commit()
    print(f'inserted {len(inserted)} new images', flush=True)
    return len(inserted)


def main(start_date=None):
    """:func:`sync` from IRSA with the config's IPAC credentials into the
    configured database; returns 0 without doing anything when no
    ``ipac_username`` is configured or ``requests`` does not import
    (update.py:181-197). ``start_date`` is the reference's and unused, as
    there."""
    from .model_util import init_db
    from .secrets import get_secret
    user = get_secret('ipac_username')
    if not user:
        print('update: ipac credentials not configured; nothing to do',
              file=sys.stderr)
        return 0
    try:
        import requests  # noqa: F401
    except ImportError:
        print('update: requests not available; install it to enable the '
              'IRSA metadata sync', file=sys.stderr)
        return 0
    init_db()
    return sync(auth=(user, get_secret('ipac_password')))


if __name__ == '__main__':
    main(*sys.argv[1:])
