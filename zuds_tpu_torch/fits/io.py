"""FITS file reader/writer: images and binary tables (the port's own
copy of ``zuds_tpu/fits/io.py``; ``tests/test_torch_fits.py`` checks that
each codec reads the other's files).

Images round-trip through numpy arrays (big-endian on disk, native order in
memory); catalogs round-trip through numpy structured arrays serialized as
BINTABLE extensions. The port has no native reader: the night driver reads
with this codec in a thread pool (``zuds_tpu_torch/night.py``).
"""
from __future__ import annotations

import io as _io
import os

import numpy as np

from .header import Header, BLOCK_LEN

__all__ = ['HDU', 'read_fits', 'write_fits', 'fits_bytes', 'read_header',
           'table_to_hdu', 'hdu_to_table']


class HDU:
    """One header-data unit: a Header plus an optional numpy array.

    data is either a 2-D (or N-D) image array or a structured record array
    (binary table).
    """

    def __init__(self, header=None, data=None):
        self.header = header if header is not None else Header()
        self.data = data

    @property
    def is_table(self):
        return self.data is not None and self.data.dtype.names is not None

    def __repr__(self):
        shape = None if self.data is None else self.data.shape
        return f'<HDU data={shape}>'


# --- dtype maps --------------------------------------------------------------

_BITPIX_TO_DTYPE = {
    8: '>u1', 16: '>i2', 32: '>i4', 64: '>i8', -32: '>f4', -64: '>f8',
}
_DTYPE_TO_BITPIX = {
    'uint8': 8, 'int16': 16, 'int32': 32, 'int64': 64,
    'float32': -32, 'float64': -64,
}

# TFORM letter -> (numpy kind, itemsize)
_TFORM_TO_DTYPE = {
    'L': ('u1', 1), 'B': ('u1', 1), 'I': ('>i2', 2), 'J': ('>i4', 4),
    'K': ('>i8', 8), 'E': ('>f4', 4), 'D': ('>f8', 8), 'A': ('S', 1),
}
_KIND_TO_TFORM = {
    ('b', 1): 'L', ('u', 1): 'B', ('i', 2): 'I', ('i', 4): 'J',
    ('i', 8): 'K', ('f', 4): 'E', ('f', 8): 'D',
    ('u', 2): 'I', ('u', 4): 'J', ('u', 8): 'K',
}


def _pad_to_block(f, nbytes, fill=b'\x00'):
    pad = (-nbytes) % BLOCK_LEN
    if pad:
        f.write(fill * pad)


def _read_header_blocks(f):
    """Read header blocks until the END card; return Header or None at EOF."""
    raw = bytearray()
    while True:
        block = f.read(BLOCK_LEN)
        if len(block) == 0 and not raw:
            return None
        if len(block) < BLOCK_LEN:
            if not raw:
                return None
            raise IOError('truncated FITS header')
        raw.extend(block)
        # look for END card at an 80-byte boundary in this block
        for i in range(0, BLOCK_LEN, 80):
            card = block[i:i + 8]
            if card == b'END     ':
                return Header.from_bytes(bytes(raw))


def _data_nbytes(header):
    naxis = header.get('NAXIS', 0)
    if naxis == 0:
        return 0, 0
    bitpix = header['BITPIX']
    n = 1
    for i in range(1, naxis + 1):
        n *= header[f'NAXIS{i}']
    main = abs(bitpix) // 8 * n * max(1, header.get('GCOUNT', 1))
    heap = header.get('PCOUNT', 0)
    return main, heap


def _decode_image(header, buf):
    naxis = header.get('NAXIS', 0)
    if naxis == 0:
        return None
    bitpix = header['BITPIX']
    shape = tuple(header[f'NAXIS{i}'] for i in range(naxis, 0, -1))
    arr = np.frombuffer(buf, dtype=_BITPIX_TO_DTYPE[bitpix]).reshape(shape)
    bscale = header.get('BSCALE', 1)
    bzero = header.get('BZERO', 0)
    if bscale == 1 and bzero == 0:
        return arr.astype(arr.dtype.newbyteorder('='))
    # unsigned-integer conventions
    if bscale == 1 and bitpix == 16 and bzero == 32768:
        return (arr.astype(np.int32) + 32768).astype(np.uint16)
    if bscale == 1 and bitpix == 32 and bzero == 2147483648:
        return (arr.astype(np.int64) + 2147483648).astype(np.uint32)
    if bscale == 1 and bitpix == 8 and bzero == -128:
        return (arr.astype(np.int16) - 128).astype(np.int8)
    return arr.astype(np.float64) * bscale + bzero


def _parse_tform(tform):
    tform = tform.strip().upper()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i > 0 else 1
    letter = tform[i]
    if letter not in _TFORM_TO_DTYPE:
        raise ValueError(f'unsupported TFORM {tform!r}')
    return repeat, letter


def _decode_table(header, buf):
    tfields = header['TFIELDS']
    names, formats, logicals = [], [], []
    for i in range(1, tfields + 1):
        name = header.get(f'TTYPE{i}', f'col{i}').strip()
        repeat, letter = _parse_tform(header[f'TFORM{i}'])
        kind, size = _TFORM_TO_DTYPE[letter]
        if letter == 'A':
            fmt = f'S{repeat}'
        elif repeat == 1:
            fmt = kind
        else:
            fmt = (kind, (repeat,))
        names.append(name)
        formats.append(fmt)
        logicals.append(letter == 'L')
    dtype = np.dtype({'names': names, 'formats': formats})
    nrows = header['NAXIS2']
    rowlen = header['NAXIS1']
    if dtype.itemsize != rowlen:
        raise ValueError(
            f'row length mismatch: TFORMs give {dtype.itemsize}, '
            f'NAXIS1={rowlen}')
    arr = np.frombuffer(buf[:nrows * rowlen], dtype=dtype)
    out_formats = ['?' if lg else f for f, lg in zip(formats, logicals)]
    out = np.empty(nrows, dtype=np.dtype(
        {'names': names, 'formats': out_formats}).newbyteorder('='))
    for name, logical in zip(names, logicals):
        col = arr[name]
        if logical:
            # FITS logical columns store ASCII 'T'/'F' (astropy/fitsio
            # write 84/70); anything other than T/t reads as False
            out[name] = (col == 84) | (col == 116)
        else:
            out[name] = col.astype(col.dtype.newbyteorder('='))
    return out


def read_fits(path_or_buf):
    """Read a FITS file -> list of HDU."""
    if hasattr(path_or_buf, 'read'):
        f = path_or_buf
        close = False
    else:
        f = open(path_or_buf, 'rb')
        close = True
    try:
        hdus = []
        while True:
            header = _read_header_blocks(f)
            if header is None:
                break
            main, heap = _data_nbytes(header)
            buf = f.read(main) if main else b''
            if len(buf) < main:
                raise IOError('truncated FITS data')
            # skip heap + padding
            total = main + heap
            skip = heap + ((-total) % BLOCK_LEN)
            if skip:
                f.seek(skip, _io.SEEK_CUR)
            xt = header.get('XTENSION', '').strip()
            if xt == 'BINTABLE':
                data = _decode_table(header, buf)
            elif main:
                data = _decode_image(header, buf)
            else:
                data = None
            hdus.append(HDU(header, data))
        return hdus
    finally:
        if close:
            f.close()


def read_header(path, ext=0):
    """Read just the header of extension ``ext`` (cheap: no pixel decode)."""
    with open(path, 'rb') as f:
        i = 0
        while True:
            header = _read_header_blocks(f)
            if header is None:
                raise IndexError(f'no extension {ext} in {path}')
            if i == ext:
                return header
            main, heap = _data_nbytes(header)
            total = main + heap
            f.seek(total + ((-total) % BLOCK_LEN), _io.SEEK_CUR)
            i += 1


def _encode_image(header, data, primary):
    header = header.copy()
    arr = np.asarray(data)
    bzero = 0
    if arr.dtype == np.uint16:
        arr = (arr.astype(np.int32) - 32768).astype(np.int16)
        bzero = 32768
    elif arr.dtype == np.uint32:
        arr = (arr.astype(np.int64) - 2147483648).astype(np.int32)
        bzero = 2147483648
    elif arr.dtype == np.bool_:
        arr = arr.astype(np.uint8)
    elif arr.dtype == np.float16:
        arr = arr.astype(np.float32)
    elif arr.dtype.name not in _DTYPE_TO_BITPIX:
        arr = arr.astype(np.float32)
    bitpix = _DTYPE_TO_BITPIX[arr.dtype.name]

    cards = Header()
    if primary:
        cards.set('SIMPLE', True, 'conforms to FITS standard')
    else:
        cards.set('XTENSION', 'IMAGE', 'Image extension')
    cards.set('BITPIX', bitpix, 'array data type')
    cards.set('NAXIS', arr.ndim, 'number of array dimensions')
    for i, n in enumerate(reversed(arr.shape)):
        cards.set(f'NAXIS{i + 1}', int(n))
    if not primary:
        cards.set('PCOUNT', 0)
        cards.set('GCOUNT', 1)
    if bzero:
        cards.set('BSCALE', 1)
        cards.set('BZERO', bzero)
    # merge user header, minus structural keys
    for k in header.keys():
        if k in ('SIMPLE', 'XTENSION', 'BITPIX', 'NAXIS', 'PCOUNT', 'GCOUNT',
                 'BSCALE', 'BZERO', 'EXTEND') or k.startswith('NAXIS'):
            continue
        cards.set(k, header[k], header.comments.get(k, ''))
    cards._history = list(header._history)
    cards._commentary = list(header._commentary)
    payload = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder('>'))
    return cards.to_bytes(), payload.tobytes()


def table_to_hdu(table, header=None):
    """Structured numpy array -> BINTABLE HDU (header fully derived)."""
    table = np.asarray(table)
    if table.dtype.names is None:
        raise TypeError('table_to_hdu needs a structured array')
    h = Header()
    h.set('XTENSION', 'BINTABLE', 'binary table extension')
    h.set('BITPIX', 8)
    h.set('NAXIS', 2)
    h.set('NAXIS1', table.dtype.itemsize)
    h.set('NAXIS2', len(table))
    h.set('PCOUNT', 0)
    h.set('GCOUNT', 1)
    h.set('TFIELDS', len(table.dtype.names))
    for i, name in enumerate(table.dtype.names, start=1):
        dt, _ = table.dtype.fields[name][:2]
        sub = dt.subdtype
        if sub is not None:
            base, shape = sub
            repeat = int(np.prod(shape))
        else:
            base, repeat = dt, 1
        if base.kind == 'S':
            tform = f'{base.itemsize}A'
        else:
            key = (base.kind, base.itemsize)
            if base.kind == 'u' and base.itemsize > 1:
                key = ('i', base.itemsize)  # stored as signed on disk
            if key not in _KIND_TO_TFORM:
                raise ValueError(f'unsupported column dtype {base}')
            tform = f'{repeat}{_KIND_TO_TFORM[key]}'
        h.set(f'TTYPE{i}', name)
        h.set(f'TFORM{i}', tform)
    if header is not None:
        for k in header.keys():
            if (k in ('XTENSION', 'BITPIX', 'PCOUNT', 'GCOUNT', 'TFIELDS')
                    or k.startswith(('NAXIS', 'TTYPE', 'TFORM'))):
                continue
            h.set(k, header[k], header.comments.get(k, ''))
    return HDU(h, table)


def hdu_to_table(hdu):
    return hdu.data


def _encode_table(header, table):
    # normalize integer kinds to FITS-representable big-endian layout
    fields = []
    for name in table.dtype.names:
        dt = table.dtype.fields[name][0]
        sub = dt.subdtype
        base = sub[0] if sub else dt
        shape = sub[1] if sub else ()
        if base.kind == 'b':
            base = np.dtype('u1')
        elif base.kind == 'u' and base.itemsize > 1:
            base = np.dtype(f'i{base.itemsize}')
        be = base.newbyteorder('>') if base.kind != 'S' else base
        fields.append((name, be, shape))
    dtype = np.dtype([(n, b, s) if s else (n, b) for n, b, s in fields])
    out = np.empty(len(table), dtype=dtype)
    for name in table.dtype.names:
        src = table[name]
        if src.dtype.kind == 'b' or (src.dtype.subdtype is not None
                                     and src.dtype.subdtype[0].kind == 'b'):
            # logical ('L') columns are ASCII 'T'/'F' on disk, not 0/1
            out[name] = np.where(src, np.uint8(84), np.uint8(70))
        else:
            out[name] = src
    # derive TFORMs from the ORIGINAL dtype (bool columns must stay 'L';
    # the converted dtype has them as u1 which would mislabel them 'B')
    full = table_to_hdu(np.empty(0, dtype=table.dtype), header=header).header
    full.set('NAXIS1', dtype.itemsize)
    full.set('NAXIS2', len(table))
    if header is not None:
        for k in header.keys():
            if (k in ('XTENSION', 'BITPIX', 'PCOUNT', 'GCOUNT', 'TFIELDS')
                    or k.startswith(('NAXIS', 'TTYPE', 'TFORM'))):
                continue
            full.set(k, header[k], header.comments.get(k, ''))
    return full.to_bytes(), out.tobytes()


def _as_hdus(hdus):
    if isinstance(hdus, HDU):
        return [hdus]
    if isinstance(hdus, tuple) and len(hdus) == 2:
        return [HDU(hdus[0], hdus[1])]
    return hdus


def write_fits(path, hdus, overwrite=True):
    """Write HDUs (list of HDU, or a single HDU / (header, data) pair)."""
    hdus = _as_hdus(hdus)
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    tmp = f'{path}.tmp{os.getpid()}'
    with open(tmp, 'wb') as f:
        _write_hdus(f, hdus)
    os.replace(tmp, path)


def fits_bytes(hdus):
    """The bytes :func:`write_fits` would write for ``hdus``, in memory."""
    f = _io.BytesIO()
    _write_hdus(f, _as_hdus(hdus))
    return f.getvalue()


def _write_hdus(f, hdus):
    for i, hdu in enumerate(hdus):
        primary = i == 0
        if hdu.data is not None and hdu.data.dtype.names is not None:
            if primary:
                # tables can't be primary: write an empty primary first
                empty = Header()
                empty.set('SIMPLE', True)
                empty.set('BITPIX', 8)
                empty.set('NAXIS', 0)
                empty.set('EXTEND', True)
                f.write(empty.to_bytes())
            hb, db = _encode_table(hdu.header, hdu.data)
        else:
            hb, db = _encode_image(hdu.header, hdu.data, primary) \
                if hdu.data is not None else (None, b'')
            if hb is None:
                h = hdu.header.copy()
                hh = Header()
                if primary:
                    hh.set('SIMPLE', True)
                else:
                    hh.set('XTENSION', 'IMAGE')
                hh.set('BITPIX', 8)
                hh.set('NAXIS', 0)
                if not primary:
                    hh.set('PCOUNT', 0)
                    hh.set('GCOUNT', 1)
                for k in h.keys():
                    if k in ('SIMPLE', 'XTENSION', 'BITPIX', 'NAXIS',
                             'PCOUNT', 'GCOUNT'):
                        continue
                    hh.set(k, h[k], h.comments.get(k, ''))
                hb = hh.to_bytes()
        f.write(hb)
        if db:
            f.write(db)
            _pad_to_block(f, len(db))
