"""Avro binary encoding and object container files (twin of
``zuds_tpu/avro.py``; the reference serializes alerts with fastavro,
``zuds/send.py:43-101``, which neither machine of the port has).

The subset of the Avro 1.8 spec the alert packets need, in pure Python:
zigzag varints, floats and doubles, strings and bytes, records, unions,
arrays, maps, enums and fixed, and the container framing (magic, metadata,
the 16-byte sync marker, data blocks) with the null codec. A file written
here is byte-for-byte the JAX package's from the same schema and records,
and any standard Avro reader reads it.
"""
from __future__ import annotations

import io
import json
import os
import struct

__all__ = ['write_avro', 'read_avro', 'encode', 'decode', 'SCHEMA_MAGIC']

SCHEMA_MAGIC = b'Obj\x01'


def _zigzag(n):
    return (n << 1) ^ (n >> 63)


def _write_long(buf, n):
    n = _zigzag(int(n))
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            break


def _write_bytes(buf, b):
    _write_long(buf, len(b))
    buf.write(b)


def _write_str(buf, s):
    _write_bytes(buf, s.encode('utf-8'))


def encode(buf, schema, datum, named=None):
    """Encode ``datum`` per ``schema`` (parsed JSON) into ``buf``."""
    if named is None:
        named = {}
    # resolve named-type references and collect definitions
    if isinstance(schema, dict) and schema.get('type') in ('record', 'enum',
                                                           'fixed'):
        named[schema['name']] = schema
    if isinstance(schema, str) and schema in named:
        schema = named[schema]

    if isinstance(schema, list):                      # union
        for i, branch in enumerate(schema):
            if _matches(branch, datum, named):
                _write_long(buf, i)
                encode(buf, branch, datum, named)
                return
        raise TypeError(f'datum {datum!r} matches no union branch {schema}')

    stype = schema['type'] if isinstance(schema, dict) else schema
    if stype == 'null':
        return
    if stype == 'boolean':
        buf.write(b'\x01' if datum else b'\x00')
    elif stype in ('int', 'long'):
        _write_long(buf, datum)
    elif stype == 'float':
        buf.write(struct.pack('<f', float(datum)))
    elif stype == 'double':
        buf.write(struct.pack('<d', float(datum)))
    elif stype == 'string':
        _write_str(buf, str(datum))
    elif stype == 'bytes':
        _write_bytes(buf, bytes(datum))
    elif stype == 'record':
        for f in schema['fields']:
            if f['name'] in datum:
                value = datum[f['name']]
            elif 'default' in f:
                value = f['default']
            else:
                raise KeyError(f"record field {f['name']} missing")
            encode(buf, f['type'], value, named)
    elif stype == 'array':
        items = list(datum)
        if items:
            _write_long(buf, len(items))
            for item in items:
                encode(buf, schema['items'], item, named)
        _write_long(buf, 0)
    elif stype == 'map':
        entries = dict(datum)
        if entries:
            _write_long(buf, len(entries))
            for k, v in entries.items():
                _write_str(buf, k)
                encode(buf, schema['values'], v, named)
        _write_long(buf, 0)
    elif stype == 'enum':
        _write_long(buf, schema['symbols'].index(datum))
    elif stype == 'fixed':
        buf.write(bytes(datum))
    else:
        raise TypeError(f'unsupported avro type {stype!r}')


def _matches(branch, datum, named):
    if isinstance(branch, str) and branch in named:
        branch = named[branch]
    btype = branch['type'] if isinstance(branch, dict) else branch
    if btype == 'null':
        return datum is None
    if datum is None:
        return False
    if btype == 'boolean':
        return isinstance(datum, bool)
    if btype in ('int', 'long'):
        return isinstance(datum, int) and not isinstance(datum, bool)
    if btype in ('float', 'double'):
        return isinstance(datum, (int, float)) and not isinstance(datum, bool)
    if btype == 'string':
        return isinstance(datum, str)
    if btype == 'bytes':
        return isinstance(datum, (bytes, bytearray))
    if btype == 'record':
        return isinstance(datum, dict)
    if btype == 'array':
        return isinstance(datum, (list, tuple))
    if btype == 'map':
        return isinstance(datum, dict)
    return True


def _read_long(buf):
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError('truncated avro varint')
        acc |= (b[0] & 0x7F) << shift
        if not b[0] & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)          # un-zigzag


def _read_bytes(buf):
    n = _read_long(buf)
    return buf.read(n)


def decode(buf, schema, named=None):
    """Decode one datum per ``schema`` from ``buf`` (inverse of encode)."""
    if named is None:
        named = {}
    if isinstance(schema, dict) and schema.get('type') in ('record', 'enum',
                                                           'fixed'):
        named[schema['name']] = schema
    if isinstance(schema, str) and schema in named:
        schema = named[schema]

    if isinstance(schema, list):                      # union
        idx = _read_long(buf)
        return decode(buf, schema[idx], named)

    stype = schema['type'] if isinstance(schema, dict) else schema
    if stype == 'null':
        return None
    if stype == 'boolean':
        return buf.read(1) == b'\x01'
    if stype in ('int', 'long'):
        return _read_long(buf)
    if stype == 'float':
        return struct.unpack('<f', buf.read(4))[0]
    if stype == 'double':
        return struct.unpack('<d', buf.read(8))[0]
    if stype == 'string':
        return _read_bytes(buf).decode('utf-8')
    if stype == 'bytes':
        return _read_bytes(buf)
    if stype == 'record':
        return {f['name']: decode(buf, f['type'], named)
                for f in schema['fields']}
    if stype == 'array':
        out = []
        while True:
            n = _read_long(buf)
            if n == 0:
                break
            if n < 0:                       # block with byte-size prefix
                _read_long(buf)
                n = -n
            for _ in range(n):
                out.append(decode(buf, schema['items'], named))
        return out
    if stype == 'map':
        out = {}
        while True:
            n = _read_long(buf)
            if n == 0:
                break
            if n < 0:
                _read_long(buf)
                n = -n
            for _ in range(n):
                k = _read_bytes(buf).decode('utf-8')
                out[k] = decode(buf, schema['values'], named)
        return out
    if stype == 'enum':
        return schema['symbols'][_read_long(buf)]
    if stype == 'fixed':
        return buf.read(schema['size'])
    raise TypeError(f'unsupported avro type {stype!r}')


def read_avro(path_or_buf):
    """Read an Avro object container file -> (schema, records).

    Null codec only (what write_avro and the reference's fastavro default
    produce)."""
    close = False
    if isinstance(path_or_buf, (str, os.PathLike)):
        f = open(path_or_buf, 'rb')
        close = True
    else:
        f = path_or_buf
    try:
        if f.read(4) != SCHEMA_MAGIC:
            raise ValueError('not an avro object container file')
        meta = {}
        while True:
            n = _read_long(f)
            if n == 0:
                break
            if n < 0:
                _read_long(f)
                n = -n
            for _ in range(n):
                k = _read_bytes(f).decode('utf-8')
                meta[k] = _read_bytes(f)
        codec = meta.get('avro.codec', b'null')
        if codec not in (b'null', b''):
            raise ValueError(f'unsupported avro codec {codec!r}')
        schema = json.loads(meta['avro.schema'])
        sync = f.read(16)
        records = []
        while True:
            try:
                count = _read_long(f)
            except EOFError:
                break
            size = _read_long(f)
            block = io.BytesIO(f.read(size))
            named = {}
            for _ in range(count):
                records.append(decode(block, schema, named))
            if f.read(16) != sync:
                raise ValueError('avro sync marker mismatch')
        return schema, records
    finally:
        if close:
            f.close()


def write_avro(path_or_buf, schema, records, sync=b'zudstpu_syncmark'):
    """Write an Avro object container file (null codec)."""
    close = False
    if isinstance(path_or_buf, (str, os.PathLike)):
        f = open(path_or_buf, 'wb')
        close = True
    else:
        f = path_or_buf
    try:
        f.write(SCHEMA_MAGIC)
        meta = {'avro.schema': json.dumps(schema).encode(),
                'avro.codec': b'null'}
        buf = io.BytesIO()
        _write_long(buf, len(meta))
        for k, v in meta.items():
            _write_str(buf, k)
            _write_bytes(buf, v)
        _write_long(buf, 0)
        f.write(buf.getvalue())
        assert len(sync) == 16
        f.write(sync)

        block = io.BytesIO()
        named = {}
        for rec in records:
            encode(block, schema, rec, named)
        payload = block.getvalue()
        head = io.BytesIO()
        _write_long(head, len(records))
        _write_long(head, len(payload))
        f.write(head.getvalue())
        f.write(payload)
        f.write(sync)
    finally:
        if close:
            f.close()
