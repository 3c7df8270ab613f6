"""Configuration with secret hygiene (twin of ``zuds_tpu/secrets.py``).

Config file resolution order:
  1. ``$ZUDS_CONFIG`` if set
  2. ``~/.zuds-tpu``
seeded from the port's own ``config/default.conf`` (the same keys and values
as the reference's ``default.conf.yaml``) on first use, with mode 0600.
Files the group or others may read or write are refused, since the config
holds database and service credentials.

The reference parses the file with ``yaml.safe_load``. The port reads the
flat ``key: value`` subset that file uses, with its own reader
(:func:`parse_config`): ``null``/``~``/empty, decimal integers, quoted
strings, bare strings that start with a letter, ``/`` or ``~``, and ``#``
comments (also after a value). Any other value, and a nested or
flow-style one, raises ``ValueError`` rather than come back as something
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
_NULL = ('', '~', 'null', 'Null', 'NULL')
# the words YAML 1.1 reads as booleans
_BOOL = ('yes', 'no', 'true', 'false', 'on', 'off')


def _scalar(raw, lineno):
    """One value of the subset: null, a decimal integer, a quoted string,
    or a bare string that starts with a letter, ``/`` or ``~``. Anything
    else (booleans, floats, other numbers) raises ``ValueError``: quote
    it to have it read as a string."""
    if raw[:1] in ('"', "'"):
        q = raw[0]
        end = raw.find(q, 1)
        if end < 0:
            raise ValueError(f'config line {lineno}: unterminated string')
        rest = raw[end + 1:].strip()
        if rest and not rest.startswith('#'):
            raise ValueError(f'config line {lineno}: text after a string')
        return raw[1:end]
    # a comment starts at a '#' that follows whitespace
    m = re.search(r'\s#', raw)
    if m:
        raw = raw[:m.start()]
    raw = raw.strip()
    if raw in _NULL:
        return None
    if _INT.match(raw):
        return int(raw)
    if (raw[0].isalpha() or raw[0] in '/~') and raw.lower() not in _BOOL:
        return raw
    raise ValueError(f'config line {lineno}: only null, integers and '
                     f'strings are read, not {raw!r}; quote a string')


def parse_config(text):
    """dict of a flat ``key: value`` YAML document (the subset the
    default config uses)."""
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
        if value and not value[0].isspace():
            raise ValueError(f'config line {lineno}: no space after the '
                             f'colon: {line!r}')
        out[key.strip()] = _scalar(value.strip(), lineno)
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
            self.cache = parse_config(f.read())
        self.path = path
        return self.cache

    def get(self, key, default=None):
        return self.load_config().get(key, default)


_manager = SecretManager()


def load_config(reload=False):
    return _manager.load_config(reload=reload)


def get_secret(key, default=None):
    return _manager.get(key, default)
