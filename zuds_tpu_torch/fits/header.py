"""FITS header parsing and formatting (the port's own copy of
``zuds_tpu/fits/header.py``, which imports no JAX but belongs to the JAX
package; ``tests/test_torch_fits.py`` holds the two codecs to each other).

The FITS 4.0 card grammar: an ordered keyword->value mapping with comments.
"""
from __future__ import annotations

import re

CARD_LEN = 80
BLOCK_LEN = 2880
CARDS_PER_BLOCK = BLOCK_LEN // CARD_LEN

_NUMERIC_RE = re.compile(r'^[+-]?(\d+\.?\d*|\.\d+)([EDed][+-]?\d+)?$')


class Undefined:
    """FITS undefined value (keyword present, no value)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return 'UNDEFINED'

    def __bool__(self):
        return False


UNDEFINED = Undefined()


def _parse_value(raw):
    """Parse the value field of a FITS card into a Python object."""
    raw = raw.strip()
    if raw == '':
        return UNDEFINED
    if raw.startswith("'"):
        # string: ends at first single quote not doubled
        out = []
        i = 1
        while i < len(raw):
            c = raw[i]
            if c == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(c)
            i += 1
        # trailing spaces in FITS strings are not significant
        return ''.join(out).rstrip()
    if raw == 'T':
        return True
    if raw == 'F':
        return False
    if _NUMERIC_RE.match(raw):
        low = raw.lower().replace('d', 'e')
        if '.' in low or 'e' in low:
            return float(low)
        return int(low)
    # fall back to raw string (non-standard card)
    return raw


def parse_card(card):
    """Parse one 80-char card -> (keyword, value, comment) or None for blank."""
    key = card[:8].strip()
    if key in ('', 'COMMENT', 'HISTORY'):
        if key == '':
            text = card[8:].rstrip()
            if not text:
                return None
            return ('', text, '')
        return (key, card[8:].rstrip(), '')
    if key == 'END':
        return ('END', None, '')
    if key == 'CONTINUE':
        # OGIP long-string continuation: quoted string after column 8
        body = card[8:]
    elif card[8:10] != '= ':
        # keyword with no value indicator
        return (key, UNDEFINED, card[10:].rstrip())
    else:
        body = card[10:]
    # find the comment separator: a '/' outside of a quoted string
    in_str = False
    comment = ''
    value_field = body
    i = 0
    while i < len(body):
        c = body[i]
        if c == "'":
            if in_str and i + 1 < len(body) and body[i + 1] == "'":
                i += 2
                continue
            in_str = not in_str
        elif c == '/' and not in_str:
            value_field = body[:i]
            comment = body[i + 1:].strip()
            break
        i += 1
    return (key, _parse_value(value_field), comment)


def _format_float(value):
    s = repr(float(value))
    if len(s) > 20:
        s = f'{value:.15G}'
    if 'e' in s:
        s = s.replace('e', 'E')
    if '.' not in s and 'E' not in s and 'N' not in s.upper():
        s += '.0'
    return s


def _string_chunks(value, limit=67):
    """Split a raw string so each chunk's quote-escaped form fits a card."""
    chunks, cur, curlen = [], [], 0
    for ch in value:
        el = 2 if ch == "'" else 1
        if curlen + el > limit:
            chunks.append(''.join(cur))
            cur, curlen = [], 0
        cur.append(ch)
        curlen += el
    chunks.append(''.join(cur))
    return chunks


def format_card(key, value, comment=''):
    """Format a (keyword, value, comment) triple into one or more 80-char
    cards (returned concatenated).

    Long string values use the OGIP 1.0 CONTINUE convention ('&'-terminated
    chunks); over-long comments are truncated (comments only — a non-string
    value that cannot fit its card raises instead of silently corrupting).
    """
    if key in ('COMMENT', 'HISTORY', ''):
        card = f'{key:<8}{value}'
        return card[:CARD_LEN].ljust(CARD_LEN)
    if key == 'END':
        return 'END'.ljust(CARD_LEN)

    if isinstance(value, str):
        esc = value.replace("'", "''")
        if len(esc) > 68:
            chunks = _string_chunks(value)
            cards = []
            for i, chunk in enumerate(chunks):
                last = i == len(chunks) - 1
                esc_c = chunk.replace("'", "''") + ('' if last else '&')
                body = f"'{esc_c}'"
                if last and comment:
                    body = f'{body} / {comment}'
                prefix = f'{key:<8}= ' if i == 0 else 'CONTINUE  '
                cards.append(f'{prefix}{body}'[:CARD_LEN].ljust(CARD_LEN))
            return ''.join(cards)
        vstr = f"'{esc:<8}'"
        # strings are left-justified starting at column 11
        body = f'{vstr:<20}'
    else:
        if value is True:
            vstr = 'T'
        elif value is False:
            vstr = 'F'
        elif value is UNDEFINED or value is None:
            vstr = ''
        elif isinstance(value, float):
            vstr = _format_float(value)
        elif isinstance(value, (int,)):
            vstr = str(value)
        else:
            vstr = str(value)
        if len(vstr) > CARD_LEN - 10:
            raise ValueError(
                f'value of {key!r} does not fit a FITS card: {vstr!r}')
        body = f'{vstr:>20}'
    if comment:
        body = f'{body} / {comment}'
    card = f'{key:<8}= {body}'
    return card[:CARD_LEN].ljust(CARD_LEN)


class Header:
    """Ordered FITS header: keyword -> value with per-keyword comments.

    Supports dict-style access, iteration over keywords, and serialization
    to/from raw 2880-byte FITS blocks.
    """

    def __init__(self, cards=None):
        self._keys = []              # keyword order (excluding COMMENT/HISTORY)
        self._values = {}
        self._comments = {}
        self._history = []
        self._commentary = []
        if cards:
            for item in cards:
                if isinstance(item, (tuple, list)):
                    key, value = item[0], item[1]
                    comment = item[2] if len(item) > 2 else ''
                    self.set(key, value, comment)
                else:
                    raise TypeError(f'bad card spec: {item!r}')

    # -- mapping protocol -----------------------------------------------------
    def __contains__(self, key):
        return key.upper() in self._values

    def __getitem__(self, key):
        return self._values[key.upper()]

    def __setitem__(self, key, value):
        self.set(key, value)

    def __delitem__(self, key):
        key = key.upper()
        del self._values[key]
        self._comments.pop(key, None)
        self._keys.remove(key)

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def __eq__(self, other):
        if not isinstance(other, Header):
            return NotImplemented
        return (self._keys == other._keys
                and self._values == other._values)

    def __repr__(self):
        lines = [format_card(k, self._values[k], self._comments.get(k, ''))
                 for k in self._keys]
        return '\n'.join(lines)

    def get(self, key, default=None):
        return self._values.get(key.upper(), default)

    def set(self, key, value, comment=None):
        key = key.upper()
        if key not in self._values:
            self._keys.append(key)
        self._values[key] = value
        if comment is not None:
            self._comments[key] = comment

    def keys(self):
        return list(self._keys)

    def items(self):
        return [(k, self._values[k]) for k in self._keys]

    def update(self, other):
        if isinstance(other, Header):
            for k in other._keys:
                self.set(k, other._values[k], other._comments.get(k))
        else:
            for k, v in dict(other).items():
                self.set(k, v)

    def pop(self, key, *default):
        key = key.upper()
        if key in self._values:
            val = self._values[key]
            del self[key]
            return val
        if default:
            return default[0]
        raise KeyError(key)

    @property
    def comments(self):
        return self._comments

    def add_comment(self, text):
        self._commentary.append(('COMMENT', str(text)))

    def add_history(self, text):
        self._history.append(('HISTORY', str(text)))

    def copy(self):
        h = Header()
        h._keys = list(self._keys)
        h._values = dict(self._values)
        h._comments = dict(self._comments)
        h._history = list(self._history)
        h._commentary = list(self._commentary)
        return h

    def to_dict(self):
        return {k: self._values[k] for k in self._keys}

    # -- serialization --------------------------------------------------------
    @classmethod
    def from_bytes(cls, raw):
        """Parse raw header blocks (must include the END card)."""
        h = cls()
        n = len(raw) // CARD_LEN
        last_key = None
        for i in range(n):
            card = raw[i * CARD_LEN:(i + 1) * CARD_LEN]
            if isinstance(card, bytes):
                card = card.decode('ascii', errors='replace')
            parsed = parse_card(card)
            if parsed is None:
                continue
            key, value, comment = parsed
            if key == 'END':
                break
            if key == 'COMMENT':
                h._commentary.append(('COMMENT', value))
            elif key == 'HISTORY':
                h._history.append(('HISTORY', value))
            elif key == '':
                h._commentary.append(('', value))
            elif key == 'CONTINUE':
                # OGIP long string: previous card's value ends with '&'
                prev = h._values.get(last_key)
                if (last_key is not None and isinstance(prev, str)
                        and prev.endswith('&') and isinstance(value, str)):
                    h._values[last_key] = prev[:-1] + value
                    if comment:
                        h._comments[last_key] = comment
            else:
                h.set(key, value, comment)
                last_key = key
        return h

    def to_bytes(self):
        cards = [format_card(k, self._values[k], self._comments.get(k, ''))
                 for k in self._keys]
        cards += [format_card(k, v) for k, v in self._commentary]
        cards += [format_card(k, v) for k, v in self._history]
        cards.append(format_card('END', None))
        text = ''.join(cards)
        pad = (-len(text)) % BLOCK_LEN
        text += ' ' * pad
        return text.encode('ascii')
