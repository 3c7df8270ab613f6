"""Alert packets (twin of ``zuds_tpu/alert.py``; the reference is
zuds/alert.py).

``Alert.from_detection`` assembles the candidate record (the detection's
measurements, its image's metadata, the detection history, the forced
light curve, the crossmatch overlay and three gzip-FITS cutouts) in the
reference's shape (``zuds/alert.py:59-293``). What it cannot reach stays
at its schema default: a detection read from the database carries its
``image_id`` and no ``image``, so its candidate has no image metadata and
its packet no cutouts; only a detection that carries its subtraction (the
``Detection`` objects a commit builds, with ``image`` set) gives them.
As in the reference, a crossmatch that raises and a cutout that raises
are skipped, not reported.
"""
from __future__ import annotations

import json

import numpy as np

from .constants import MJD_TO_JD
from .db.orm import Column, Model

__all__ = ['Alert']


class Alert(Model):
    """One outgoing alert packet (the JSON payload and three cutouts)."""

    __tablename__ = 'alerts'

    detection_id = Column('INTEGER', index=True)
    alert = Column('TEXT')               # JSON candidate payload
    creation_index = Column('INTEGER')
    sent = Column('INTEGER', default=0, index=True)
    cutout_science = Column('BLOB')
    cutout_template = Column('BLOB')
    cutout_difference = Column('BLOB')

    @property
    def payload(self):
        return json.loads(self.alert) if self.alert else None

    @classmethod
    def from_detection(cls, detection, xmatch_enabled=True):
        """The alert of ``detection`` with its full 123-field (single) or
        124-field (stack) candidate record (alert.py:40-230): the stream
        from the type of ``detection.image``, the image's cards, the
        detection history and light curve of its source when a database is
        bound, the ``xmatch`` overlay, and the difference, science and
        template cutouts of an image that has pixels."""
        from .alert_fields import candidate_defaults
        from .core import DBSession
        from .detections import Detection
        from .subtraction import MultiEpochSubtraction

        image = getattr(detection, 'image', None)
        source_id = getattr(detection, 'source_id', None)

        # single vs stack stream (reference zuds/alert.py:92-99)
        alert_type = ('stack' if isinstance(image, MultiEpochSubtraction)
                      else 'single')

        candidate = candidate_defaults(alert_type)
        candidate.update({
            'alert_type': alert_type,
            'candid': getattr(detection, 'id', None) or 0,
            'isdiffpos': 't',
            'ra': detection.ra,
            'dec': detection.dec,
            'xpos': detection.x_image,
            'ypos': detection.y_image,
            'aimage': detection.a_image,
            'bimage': detection.b_image,
            'elong': detection.elongation,
            'fwhm': detection.fwhm_image,
            'aimagerat': (detection.a_image / detection.fwhm_image
                          if detection.fwhm_image else 0.0),
            'bimagerat': (detection.b_image / detection.fwhm_image
                          if detection.fwhm_image else 0.0),
            'snr': float(detection.snr) if np.isfinite(detection.snr)
            else 0.0,
            'drb': detection.rb if detection.rb is not None else 0.0,
            'drbversion': 'braai_d6_m9-flax',
        })

        target = getattr(image, 'target_image', None)
        if image is not None:
            h = image.header
            candidate['pid'] = getattr(image, 'id', None) or 0
            candidate['pdiffimfilename'] = image.basename or ''
            candidate['field'] = getattr(image, 'field', 0) or 0
            candidate['fid'] = getattr(image, 'fid', 0) or 0
            ccdid = getattr(image, 'ccdid', None)
            qid = getattr(image, 'qid', None)
            if ccdid and qid:
                candidate['rcid'] = (ccdid - 1) * 4 + (qid - 1)
            th = target.header if target is not None else h
            candidate['programid'] = int(th.get('PROGRMID', 2) or 2)
            candidate['programpi'] = str(th.get('PROGRMPI', '') or '')
            jd = h.get('OBSJD')
            if jd is None and 'OBSMJD' in h:
                jd = h['OBSMJD'] + MJD_TO_JD
            if alert_type == 'single':
                candidate['jd'] = jd or 0.0
                candidate['nid'] = int(th.get('DBNID', 0) or 0)
                candidate['diffmaglim'] = float(
                    th.get('MAGLIM', 0.0) or 0.0)
                candidate['exptime'] = float(th.get('EXPTIME', 0.0) or 0.0)
                mjdcut = (jd - MJD_TO_JD) if jd else None
            else:
                inputs = getattr(target, 'input_images', None) or []
                from .utils import mjd_from_header
                mjds = sorted(mjd_from_header(i.header) for i in inputs) \
                    if inputs else []
                if mjds:
                    candidate['jdstartstack'] = mjds[0] + MJD_TO_JD
                    candidate['jdendstack'] = mjds[-1] + MJD_TO_JD
                    candidate['jdmed'] = float(np.median(mjds)) + MJD_TO_JD
                    candidate['nframesstack'] = len(mjds)
                    candidate['exptime'] = float(sum(
                        float(i.header.get('EXPTIME', 0.0) or 0.0)
                        for i in inputs))
                    mjdcut = mjds[-1]
                else:
                    mjdcut = None

            # reference-stack provenance (zuds/alert.py:147-158)
            ref = getattr(image, 'reference_image', None)
            rinputs = getattr(ref, 'input_images', None) or []
            if rinputs:
                from .utils import mjd_from_header
                rmjds = [mjd_from_header(i.header) for i in rinputs]
                candidate['jdstartref'] = min(rmjds) + MJD_TO_JD
                candidate['jdendref'] = max(rmjds) + MJD_TO_JD
                candidate['nframesref'] = len(rinputs)
            elif ref is not None and 'NCOADD' in ref.header:
                candidate['nframesref'] = int(ref.header['NCOADD'])
        else:
            mjdcut = None

        # detection history of both streams (zuds/alert.py:190-259): the
        # subtraction records' target obsjd, so a record without a
        # target_id counts no detection
        sess = DBSession()
        if sess.conn is not None and source_id:
            for stream, key in (('sesub', 'single'), ('mesub', 'stack')):
                rows = sess.execute(
                    'SELECT s.obsjd FROM detections d '
                    'JOIN ztffiles z ON d.image_id = z.id '
                    'JOIN ztffiles s ON z.target_id = s.id '
                    'WHERE d.source_id = ? AND z.type = ? '
                    'AND s.obsjd IS NOT NULL ORDER BY s.obsjd',
                    (source_id, stream)).fetchall()
                jds = [r[0] for r in rows
                       if mjdcut is None
                       or r[0] - MJD_TO_JD < mjdcut + 0.5 / 86400.0]
                candidate[f'ndethist_{key}'] = len(jds)
                if jds:
                    candidate[f'jdstarthist_{key}'] = jds[0]
                    candidate[f'jdendhist_{key}'] = jds[-1]

        # the source's other detections and its forced light curve
        prv_candidates = []
        light_curve = []
        if sess.conn is not None and source_id:
            hist = sess.query(Detection).filter_by(source_id=source_id).all()
            for d in hist:
                if d.id == detection.id:
                    continue
                prv_candidates.append({
                    'jd': None, 'ra': d.ra, 'dec': d.dec,
                    'flux': d.flux_aper, 'fluxerr': d.fluxerr_aper,
                    'rb': d.rb, 'snr': float(d.snr)
                    if d.snr and np.isfinite(d.snr) else None,
                })
            from .source import Source
            src = sess.query(Source).filter_by(id=source_id).first()
            if src is not None:
                for row in src.light_curve():
                    light_curve.append({
                        'jd': float(row['obsjd']) if np.isfinite(
                            row['obsjd']) else None,
                        'filter': str(row['filtercode']),
                        'zp': float(row['zp']),
                        'flux': float(row['flux']) if np.isfinite(
                            row['flux']) else None,
                        'fluxerr': float(row['fluxerr']) if np.isfinite(
                            row['fluxerr']) else None,
                        'flags': int(row['flags']),
                    })

        # the crossmatch overlay: only schema fields enter the candidate
        # (the defaults carry every schema key)
        if xmatch_enabled:
            try:
                from .crossmatch import xmatch
                xmatch_info = xmatch(detection.ra, detection.dec,
                                     source_id) or {}
            except Exception:
                xmatch_info = {}
            candidate.update({k: v for k, v in xmatch_info.items()
                              if k in candidate and v is not None})

        cutouts = {}
        if image is not None and hasattr(image, 'data'):
            from .thumbnails import Thumbnail
            for name, img in [('difference', image),
                              ('science', getattr(image, 'target_image',
                                                  None)),
                              ('template', getattr(image, 'reference_image',
                                                   None))]:
                if img is None or not hasattr(img, 'data'):
                    continue
                try:
                    t = Thumbnail.from_detection(detection, img,
                                                 stamp_type=name)
                    cutouts[name] = t.bytes
                except Exception:
                    continue

        obj = cls(
            detection_id=getattr(detection, 'id', None),
            alert=json.dumps({
                'candid': getattr(detection, 'id', None),
                'objectId': source_id,
                'candidate': candidate,
                'prv_candidates': prv_candidates,
                'light_curve': light_curve,
            }),
            cutout_science=cutouts.get('science'),
            cutout_template=cutouts.get('template'),
            cutout_difference=cutouts.get('difference'),
        )
        obj.detection = detection
        return obj
