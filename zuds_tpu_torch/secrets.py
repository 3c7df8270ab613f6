"""Configuration with secret hygiene (twin of ``zuds_tpu/secrets.py``).

Config file resolution order:
  1. ``$ZUDS_CONFIG`` if set
  2. ``~/.zuds-tpu``
seeded from the port's own ``config/default.conf`` (the same keys and values
as the reference's ``default.conf.yaml``) on first use, with mode 0600.
Files the group or others may read or write are refused, since the config
holds database and service credentials.

Where ``yaml`` imports, the file is read with ``yaml.safe_load``, as the
reference reads it (secrets.py:52). Where it does not (the card machine
has no yaml), the port reads the flat ``key: value`` subset of YAML 1.1 a
config holds, with its own reader (:func:`parse_config`): the scalars
``yaml.safe_load`` resolves to null (``~``, ``null`` in its three cases,
empty), booleans (``true``/``false``/``yes``/``no``/``on``/``off`` in the
lower, capitalised and upper cases), decimal integers, floats (a dot, an
optional signed exponent, ``.inf`` and ``.nan``), quoted strings, bare
strings that start with a letter, ``/`` or ``~``, and ``#`` comments (also
after a value). On every form it takes it gives ``yaml.safe_load``'s
value; any other form (a nested or flow-style value, a hexadecimal,
octal or sexagesimal number, a bare string that starts otherwise) raises
``ValueError`` naming the form, rather than come back as something
``yaml.safe_load`` would not give.
"""
import os
import re
import shutil
import stat
from pathlib import Path

__all__ = ['get_secret', 'load_config', 'parse_config']


DEFAULT_CONFIG = Path(__file__).parent / 'config' / 'default.conf'

_INT = re.compile(r'^[-+]?(0|[1-9][0-9]*)$')
# YAML 1.1's floats without '_' or sexagesimal parts (PyYAML's resolver)
_FLOAT = re.compile(r'^(?:[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?'
                    r'|\.[0-9]+(?:[eE][-+][0-9]+)?'
                    r'|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$')
_NULL = ('', '~', 'null', 'Null', 'NULL')
# YAML 1.1's booleans, in the cases its resolver takes
_BOOL = {w: v for words, v in (('yes true on', True),
                               ('no false off', False))
         for word in words.split()
         for w in (word, word.capitalize(), word.upper())}


def _float(raw):
    text = raw.lower()
    if text.endswith('.inf'):
        return float('-inf') if text[0] == '-' else float('inf')
    if text == '.nan':
        return float('nan')
    return float(text)


def _scalar(raw, lineno):
    """One value of the subset, as ``yaml.safe_load`` reads it: null, a
    boolean, a decimal integer, a float, a quoted string, or a bare string
    that starts with a letter, ``/`` or ``~``. Any other form raises
    ``ValueError`` naming it."""
    if raw[:1] in ('"', "'"):
        q = raw[0]
        end = raw.find(q, 1)
        if end < 0:
            raise ValueError(f'config line {lineno}: unterminated string')
        rest = raw[end + 1:].strip()
        if rest and not rest.startswith('#'):
            raise ValueError(f'config line {lineno}: text after a string')
        body = raw[1:end]
        if '\\' in body and q == '"':
            raise ValueError(f'config line {lineno}: an escape sequence in '
                             f'a double-quoted string is not read')
        return body
    if raw[:1] in ('{', '['):
        raise ValueError(f'config line {lineno}: a flow-style collection is '
                         f'not read: {raw!r}')
    if '\t' in raw:
        raise ValueError(f'config line {lineno}: a tab in a value is not '
                         f'read: {raw!r}')
    # a comment starts at a '#' that follows a space
    m = re.search(r' #', raw)
    if m:
        raw = raw[:m.start()]
    raw = raw.strip()
    if raw in _NULL:
        return None
    if raw in _BOOL:
        return _BOOL[raw]
    if _INT.match(raw):
        return int(raw)
    if _FLOAT.match(raw):
        return _float(raw)
    if (raw[0].isalpha() or raw[0] in '/~') and ': ' not in raw \
            and not raw.endswith(':'):
        return raw
    raise ValueError(f'config line {lineno}: the form of {raw!r} is not '
                     f'read (null, booleans, decimal integers, floats and '
                     f'strings are); quote a string')


_KEY = re.compile(r'^[A-Za-z_][\w .\-/]*$')


def parse_config(text):
    """dict of a flat ``key: value`` YAML document, each value as
    ``yaml.safe_load`` reads it (see the module docstring); keys are
    plain words (a letter or ``_``, then letters, digits, ``_``, ``.``,
    ``-``, ``/`` and spaces), never a word YAML reads as null or a
    boolean."""
    out = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith('#'):
            continue
        if line[:1].isspace():
            raise ValueError(f'config line {lineno}: nested entries are not '
                             f'read: {line!r}')
        key, sep, value = line.partition(':')
        if not sep or not key.strip():
            raise ValueError(f'config line {lineno}: not key: value: '
                             f'{line!r}')
        key = key.strip()
        if not _KEY.match(key) or key in _BOOL or key in _NULL:
            raise ValueError(f'config line {lineno}: the key {key!r} is not '
                             f'a plain word')
        if value and not value[0].isspace():
            raise ValueError(f'config line {lineno}: no space after the '
                             f'colon: {line!r}')
        out[key] = _scalar(value.strip(), lineno)
    return out


class SecretManager:

    def __init__(self):
        self.cache = None
        self.path = None

    def config_path(self):
        env = os.getenv('ZUDS_CONFIG')
        if env:
            return Path(env)
        return Path.home() / '.zuds-tpu'

    def initialize_config(self, path):
        path.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(DEFAULT_CONFIG, path)
        os.chmod(path, stat.S_IRUSR | stat.S_IWUSR)

    def load_config(self, reload=False):
        if self.cache is not None and not reload:
            return self.cache
        path = self.config_path()
        if not path.exists():
            self.initialize_config(path)
        mode = os.stat(path).st_mode
        if mode & (stat.S_IRGRP | stat.S_IROTH | stat.S_IWGRP | stat.S_IWOTH):
            raise PermissionError(
                f'config file {path} must not be group/world accessible; '
                f'run: chmod 600 {path}')
        with open(path) as f:
            text = f.read()
        try:
            import yaml
        except ImportError:
            self.cache = parse_config(text)
        else:
            self.cache = yaml.safe_load(text) or {}
        self.path = path
        return self.cache

    def get(self, key, default=None):
        return self.load_config().get(key, default)


_manager = SecretManager()


def load_config(reload=False):
    return _manager.load_config(reload=reload)


def get_secret(key, default=None):
    return _manager.get(key, default)
