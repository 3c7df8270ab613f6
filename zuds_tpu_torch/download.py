"""IPAC IRSA downloads (twin of ``zuds_tpu/download.py``). ``requests`` is
imported when a download is asked for; without it the call raises
``RuntimeError``."""
from __future__ import annotations

import os
import time

from .secrets import get_secret

__all__ = ['ipac_authenticate', 'safe_download']

IPAC_LOGIN = ('https://irsa.ipac.caltech.edu/account/signon/login.do'
              '?josso_cmd=login')


def _require_requests():
    try:
        import requests
        return requests
    except ImportError as e:
        raise RuntimeError(
            'downloads need the optional `requests` dependency') from e


def ipac_authenticate():
    """JOSSO login with the configured ``ipac_username`` and
    ``ipac_password``; returns the session's cookies (download.py:24-37)."""
    requests = _require_requests()
    username = get_secret('ipac_username')
    password = get_secret('ipac_password')
    if not username or not password:
        raise RuntimeError('ipac_username/ipac_password not configured')
    target = requests.post(IPAC_LOGIN, data={
        'josso_username': username, 'josso_password': password})
    if target.cookies.get('JOSSO_SESSIONID') is None:
        raise ValueError('IPAC authentication failed')
    return target.cookies


def safe_download(url, destination, cookie=None, raise_exc=True, retries=5):
    """GET ``url`` into ``destination`` (through ``<destination>.part``),
    up to ``retries`` attempts with a sleep of 2^attempt s between them;
    the last failure raises, or returns None without ``raise_exc``
    (download.py:40-62)."""
    requests = _require_requests()
    for attempt in range(retries):
        try:
            r = requests.get(url, cookies=cookie, timeout=60)
            r.raise_for_status()
            tmp = f'{destination}.part'
            with open(tmp, 'wb') as f:
                f.write(r.content)
            os.replace(tmp, destination)
            return destination
        except Exception:
            if attempt == retries - 1:
                if raise_exc:
                    raise
                return None
            time.sleep(2 ** attempt)
