"""Alert crossmatches (twin of ``zuds_tpu/crossmatch.py``; the reference
is zuds/crossmatch.py).

The reference asks Kowalski (PS1 and its star/galaxy score, ZTF alerts,
Milliquas, TNS) and a DR8 postgres. Here the local tables of
``external.py`` (``PS1``, ``DR8North``/``DR8South``, ``CLU``,
``Milliquas``, ``TNSSource``, ``ZTFName``) answer through the cone search
of ``spatial.py``; Kowalski (the optional ``penquins`` client) is asked
only when a local table has nothing and credentials are configured.
``xmatch`` gathers the candidate's ps/ls/name blocks, None or '' where
nothing matched.
"""
from __future__ import annotations

import json

import numpy as np

from .secrets import get_secret
from .spatial import cone_where, angular_distance

__all__ = ['xmatch', 'xmatch_dr8', 'xmatch_clu', 'ps1_info', 'abmag',
           'xmatch_names']

# all three reference name services use a 1.5 arcsec cone
# (zuds/crossmatch.py:244-383)
NAME_RADIUS_DEG = 1.5 / 3600.0


def _cone_rows(model, ra, dec, radius):
    from .core import DBSession
    sess = DBSession()
    if sess.conn is None:
        return []
    where, params = cone_where(ra, dec, radius)
    return sess.query(model).filter(where, *params).all()


def xmatch_dr8(ra, dec, radius=30.0 / 3600.0):
    """Nearest LegacySurvey DR8 matches from the local tables (reference
    queries the desi postgres, zuds/crossmatch.py:189-241)."""
    from .external import DR8North, DR8South
    out = []
    for model, survey in [(DR8North, 'n'), (DR8South, 's')]:
        for row in _cone_rows(model, ra, dec, radius):
            d = row.to_dict()
            if d.get('extra'):
                try:
                    d.update(json.loads(d.pop('extra')))
                except (TypeError, ValueError):
                    pass
            d['survey'] = survey
            d['sep_arcsec'] = float(angular_distance(ra, dec, row.ra,
                                                     row.dec) * 3600.0)
            out.append(d)
    out.sort(key=lambda d: d['sep_arcsec'])
    return out


def xmatch_clu(ra, dec, radius=60.0 / 3600.0):
    """CLU galaxy matches from the local table."""
    from .external import CLU
    rows = _cone_rows(CLU, ra, dec, radius)
    out = []
    for row in rows:
        d = row.to_dict()
        d['sep_arcsec'] = float(angular_distance(ra, dec, row.ra, row.dec)
                                * 3600.0)
        out.append(d)
    out.sort(key=lambda d: d['sep_arcsec'])
    return out


def _kowalski():
    """Authenticated Kowalski client, or None when gated."""
    user = get_secret('kowalski_username')
    pw = get_secret('kowalski_password')
    if not user or not pw:
        return None
    try:
        from penquins import Kowalski  # pragma: no cover
        return Kowalski(username=user, password=pw)
    except Exception:
        return None


def ps1_info(ra, dec, radius=30.0 / 3600.0):
    """PS1 DR1 + star/galaxy score matches, sorted by separation
    (reference: zuds/crossmatch.py:85-186, via Kowalski + sgscore tables).

    The local ``external.PS1`` table is the offline equivalent; Kowalski
    is attempted only when that finds nothing and credentials exist."""
    from .external import PS1
    out = []
    for row in _cone_rows(PS1, ra, dec, radius):
        out.append({
            'objid': row.objid, 'sgscore': row.sgscore,
            'gMeanPSFMag': row.gmag, 'rMeanPSFMag': row.rmag,
            'iMeanPSFMag': row.imag, 'zMeanPSFMag': row.zmag,
            'sep_arcsec': float(angular_distance(ra, dec, row.ra,
                                                 row.dec) * 3600.0)})
    if out:
        out.sort(key=lambda d: d['sep_arcsec'])
        return out
    k = _kowalski()
    if k is None:
        return []
    q = {'query_type': 'cone_search',
         'query': {'object_coordinates': {
             'radec': f'[({ra}, {dec})]',
             'cone_search_radius': radius * 3600,
             'cone_search_unit': 'arcsec'},
             'catalogs': {'PS1_DR1': {'filter': {}, 'projection': {}}}}}
    try:  # pragma: no cover - network
        r = k.query(q)
        return list(r['data']['PS1_DR1'].values())[0]
    except Exception:
        return []


def _local_names(model, field, ra, dec, radius=NAME_RADIUS_DEG):
    rows = _cone_rows(model, ra, dec, radius)
    return sorted({getattr(r, field) for r in rows if getattr(r, field)})


def xmatch_names(ra, dec):
    """ztfname / mqid / tnsid enrichment: unique names within 1.5 arcsec,
    comma-joined (reference semantics: ZTF_alerts / milliquas_v6 / TNS
    Kowalski cone searches, zuds/crossmatch.py:244-383). Local Milliquas /
    TNSSource / ZTFName tables answer first; Kowalski is attempted only
    when every local table comes back empty AND credentials exist — so
    the fields populate offline instead of always degrading to ''."""
    from .external import Milliquas, TNSSource, ZTFName
    names = {
        'ztfname': ','.join(_local_names(ZTFName, 'objectid', ra, dec)),
        'mqid': ','.join(_local_names(Milliquas, 'name', ra, dec)),
        'tnsid': ','.join(_local_names(TNSSource, 'name', ra, dec)),
    }
    if not any(names.values()):
        k = _kowalski()
        if k is not None:  # pragma: no cover - network
            for key, cat, proj in [('ztfname', 'ZTF_alerts', 'objectId'),
                                   ('mqid', 'milliquas_v6', 'Name'),
                                   ('tnsid', 'TNS', 'name')]:
                q = {'query_type': 'cone_search',
                     'object_coordinates': {
                         'radec': f'[({ra}, {dec})]',
                         'cone_search_radius': '1.5',
                         'cone_search_unit': 'arcsec'},
                     'catalogs': {cat: {'filter': {},
                                        'projection': {proj: 1, '_id': 0}}}}
                try:
                    r = k.query(q)
                    hits = list(r['data'][cat].values())[0]
                    names[key] = ','.join(sorted(
                        {h[proj] for h in hits if h.get(proj)}))
                except Exception:
                    pass
    return names


def abmag(nanomaggies):
    """LegacySurvey nanomaggy flux -> AB magnitude (None-safe)."""
    if nanomaggies is None or not np.isfinite(nanomaggies) \
            or nanomaggies <= 0:
        return None
    return float(22.5 - 2.5 * np.log10(nanomaggies))


def xmatch(ra, dec, source_id=None):
    """Aggregate enrichment dict for one position: the full ps*/ls*/name
    candidate blocks of the alert schema (reference:
    zuds/crossmatch.py:386-412). Keys absent from the local tables come
    back None/'' — graceful offline degradation.
    """
    out = {}

    # PS1 blocks, 3 nearest (zuds/crossmatch.py:152-185 naming)
    ps1 = ps1_info(ra, dec)
    for i, m in enumerate(ps1[:3], start=1):
        out[f'objectidps{i}'] = m.get('objid') or m.get('_id')
        out[f'sgscore{i}'] = m.get('sgscore')
        out[f'distpsnr{i}'] = m.get('sep_arcsec')
        out[f'psgmag{i}'] = m.get('gMeanPSFMag')
        out[f'psrmag{i}'] = m.get('rMeanPSFMag')
        out[f'psimag{i}'] = m.get('iMeanPSFMag')
        out[f'pszmag{i}'] = m.get('zMeanPSFMag')

    # LegacySurvey DR8 blocks, 3 nearest (zuds/crossmatch.py:218-241)
    dr8 = xmatch_dr8(ra, dec)
    for i, m in enumerate(dr8[:3], start=1):
        out[f'lsobjectid{i}'] = m.get('objid')
        out[f'lsdistnr{i}'] = m.get('sep_arcsec')
        out[f'lstype{i}'] = m.get('type')
        out[f'lsebv{i}'] = m.get('ebv')
        out[f'lsg{i}'] = abmag(m.get('flux_g'))
        out[f'lsr{i}'] = abmag(m.get('flux_r'))
        out[f'lsz{i}'] = abmag(m.get('flux_z'))
        out[f'lsw1_{i}'] = abmag(m.get('flux_w1'))
        out[f'lsw2_{i}'] = abmag(m.get('flux_w2'))
        out[f'lsw3_{i}'] = abmag(m.get('flux_w3'))
        out[f'lsw4_{i}'] = abmag(m.get('flux_w4'))
        out[f'lsgaiag{i}'] = m.get('gaia_phot_g_mean_mag')
        out[f'lsgaiap{i}'] = m.get('parallax')
        out[f'lszphotmean{i}'] = m.get('z_phot_mean')
        out[f'lszphotmed{i}'] = m.get('z_phot_median')
        out[f'lszphotstd{i}'] = m.get('z_phot_std')
        out[f'lszphotl68{i}'] = m.get('z_phot_l68')
        out[f'lszphotu68{i}'] = m.get('z_phot_u68')
        out[f'lszphotl95{i}'] = m.get('z_phot_l95')
        out[f'lszphotu95{i}'] = m.get('z_phot_u95')
        out[f'lszspec{i}'] = m.get('z_spec')

    # name services: local tables, then Kowalski, else '' (comma-joined
    # unique names like the reference, zuds/crossmatch.py:244-383)
    out.update(xmatch_names(ra, dec))

    # CLU convenience keys (repo extension; used by filters, not the
    # broker schema)
    clu = xmatch_clu(ra, dec)
    if clu:
        best = clu[0]
        out['clu_name'] = best.get('name')
        out['clu_z'] = best.get('z')
        out['clu_distmpc'] = best.get('distmpc')
        out['clu_sep'] = best['sep_arcsec']
    return out
