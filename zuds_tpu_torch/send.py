"""Alert publication (twin of ``zuds_tpu/send.py``; the reference is
zuds/send.py).

``send_alert`` serializes a packet with ``avro.py`` and produces it to
Kafka when ``kafka_brokers`` is configured and ``confluent_kafka`` imports;
otherwise it writes the container file to the alert spool,
``<base_data_directory>/alerts/<topic>/<candid>.avro``, for a relay to
ship. The topic is the reference's ``ztf_<YYYYMMDD>_programid2_zuds``
(``_stack`` for the stack stream), dated by the UTC clock.
"""
from __future__ import annotations

import datetime
import io
import os

from .alert_fields import candidate_fields
from .avro import write_avro
from .secrets import get_secret

__all__ = ['send_alert', 'combine_schemas', 'alert_to_record',
           'ALERT_SCHEMA', 'ALERT_SCHEMA_STACK']

_NFLOAT = ['null', 'double']
_NINT = ['null', 'long']
_NSTR = ['null', 'string']


def _record(name, fields):
    out = []
    for n, t in fields:
        f = {'name': n, 'type': t}
        if isinstance(t, list) and 'null' in t:
            f['default'] = None
        out.append(f)
    return {'type': 'record', 'name': name, 'fields': out}


def combine_schemas(schema_files=None, alert_type='single'):
    """The nested alert schema of one stream (send.py:45-83; the reference
    reads and combines avsc files, here it is built from the field
    registry): the envelope, the candidate record, the earlier candidates,
    the light curve and the three cutouts. ``schema_files`` is not
    read."""
    candidate = _record(f'candidate_{alert_type}',
                        candidate_fields(alert_type))
    prv = _record('prv_candidate', [
        ('jd', _NFLOAT), ('ra', _NFLOAT), ('dec', _NFLOAT),
        ('flux', _NFLOAT), ('fluxerr', _NFLOAT), ('rb', _NFLOAT),
        ('snr', _NFLOAT)])
    lc = _record('phot_point', [
        ('jd', _NFLOAT), ('filter', _NSTR), ('zp', _NFLOAT),
        ('flux', _NFLOAT), ('fluxerr', _NFLOAT), ('flags', _NINT)])
    return {
        # the namespace is the broker contract's, shared with the JAX
        # package: a packet's bytes do not depend on the producer
        'type': 'record', 'name': 'alert', 'namespace': 'zuds_tpu',
        'fields': [
            {'name': 'schemavsn', 'type': _NSTR, 'default': None},
            {'name': 'publisher', 'type': _NSTR, 'default': None},
            {'name': 'objectId', 'type': _NSTR, 'default': None},
            {'name': 'candid', 'type': _NINT, 'default': None},
            {'name': 'candidate', 'type': candidate},
            {'name': 'prv_candidates',
             'type': ['null', {'type': 'array', 'items': prv}],
             'default': None},
            {'name': 'light_curve',
             'type': ['null', {'type': 'array', 'items': lc}],
             'default': None},
            {'name': 'cutoutScience', 'type': ['null', 'bytes'],
             'default': None},
            {'name': 'cutoutTemplate', 'type': ['null', 'bytes'],
             'default': None},
            {'name': 'cutoutDifference', 'type': ['null', 'bytes'],
             'default': None},
        ],
    }


ALERT_SCHEMA = combine_schemas()
ALERT_SCHEMA_STACK = combine_schemas(alert_type='stack')


def alert_to_record(alert):
    """(record, schema) of one Alert (send.py:86-108), the stream from the
    candidate's ``alert_type``; a field the payload lacks takes its
    schema default."""
    from .alert_fields import candidate_defaults
    payload = alert.payload or {}
    cand = payload.get('candidate', {})
    atype = cand.get('alert_type') or 'single'
    base = candidate_defaults(atype)
    base.update({k: cand[k] for k in base if k in cand})
    record = {
        'schemavsn': '0.4',
        'publisher': 'ZUDS-TPU',
        'objectId': payload.get('objectId'),
        'candid': payload.get('candid'),
        'candidate': base,
        'prv_candidates': payload.get('prv_candidates'),
        'light_curve': payload.get('light_curve'),
        'cutoutScience': alert.cutout_science,
        'cutoutTemplate': alert.cutout_template,
        'cutoutDifference': alert.cutout_difference,
    }
    schema = ALERT_SCHEMA_STACK if atype == 'stack' else ALERT_SCHEMA
    return record, schema


def send_alert(alert, stack=False):
    """Serialize and publish one alert (send.py:111-150): to Kafka when
    ``kafka_brokers`` is configured and ``confluent_kafka`` imports, else
    to ``<base_data_directory>/alerts/<topic>/<candid>.avro``. Sets
    ``alert.sent`` and, with a database bound, commits the alert. Returns
    the topic."""
    date = datetime.datetime.now(datetime.timezone.utc).strftime('%Y%m%d')
    record, schema = alert_to_record(alert)
    stack = stack or record['candidate'].get('alert_type') == 'stack'
    topic = f'ztf_{date}_programid2_zuds' + ('_stack' if stack else '')

    try:
        from confluent_kafka import Producer
    except ImportError:
        Producer = None

    if Producer is not None and get_secret('kafka_brokers'):
        buf = io.BytesIO()
        write_avro(buf, schema, [record])
        p = Producer({'bootstrap.servers': get_secret('kafka_brokers')})
        p.produce(topic=topic, value=buf.getvalue())
        p.flush()
    else:
        spool = os.path.join(
            os.path.expanduser(str(get_secret('base_data_directory',
                                              '/tmp/zuds-tpu-data'))),
            'alerts', topic)
        os.makedirs(spool, exist_ok=True)
        path = os.path.join(spool, f'{record["candid"] or "alert"}.avro')
        write_avro(path, schema, [record])

    alert.sent = 1
    from .core import DBSession
    sess = DBSession()
    if sess.conn is not None:
        sess.add(alert)
        sess.commit()
    return topic
