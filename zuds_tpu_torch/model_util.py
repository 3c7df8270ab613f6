"""Database lifecycle (twin of ``zuds_tpu/model_util.py``).

``init_db()`` binds the port's scoped sessions to a database. Backend comes
from config: ``db_backend: sqlite`` (default, zero-dependency) or
``postgres`` (a psycopg2 driver, imported inside the postgres factory only).
As in the reference, everything else in the package works before this is
ever called. ``create_tables`` makes every table of the reference.
"""
from __future__ import annotations

import os
import sqlite3
from pathlib import Path

from .core import DBSession, RefDBSession
from .db.orm import MODELS
from .secrets import get_secret
from .spatial import register_sqlite_functions

__all__ = ['init_db', 'create_tables', 'drop_tables', 'create_database']

_state = {'path': None}


def _ensure_models_imported():
    """Import every module that declares Models so DDL sees all tables."""
    from . import bookkeeping, joins, detections, source, archive  # noqa
    from . import thumbnails, external, alert  # noqa


def _sqlite_path(database=None):
    if database is not None:
        return str(database)
    path = get_secret('sqlite_path', '~/.zuds-tpu.db')
    return str(Path(os.path.expanduser(str(path))))


def init_db(timeout=None, database=None):
    """Bind DBSession/RefDBSession to the configured database."""
    _ensure_models_imported()
    backend = get_secret('db_backend', 'sqlite')
    if backend == 'postgres':
        factory = _postgres_factory('', timeout)
        ref_factory = (_postgres_factory('ref_', timeout)
                       if get_secret('ref_db_host') else factory)
        DBSession.configure(factory)
        RefDBSession.configure(ref_factory)
        return DBSession
    if backend != 'sqlite':
        raise NotImplementedError(f'unknown db_backend {backend!r}')
    path = _sqlite_path(database)
    _state['path'] = path

    def factory():
        conn = sqlite3.connect(path, timeout=timeout or 30.0)
        conn.row_factory = sqlite3.Row
        conn.execute('PRAGMA journal_mode=WAL')
        conn.execute('PRAGMA foreign_keys=ON')
        register_sqlite_functions(conn)
        return conn

    DBSession.configure(factory)
    RefDBSession.configure(factory)
    return DBSession


def _postgres_factory(refkey, timeout=None):
    """Connection factory for the postgres dialect (secrets naming follows
    the reference: db_username/db_password/db_host/db_port/db_name, with a
    ref_ prefix for the reference database; zuds/model_util.py:132-160).
    Requires psycopg2 and a server with the q3c extension installed."""
    from .db.orm import PGConnection
    try:
        import psycopg2
        import psycopg2.extras
    except ImportError as e:
        raise RuntimeError(
            'db_backend postgres requires the psycopg2 driver') from e

    kwargs = dict(
        dbname=get_secret(f'{refkey}db_name'),
        user=get_secret(f'{refkey}db_username'),
        password=get_secret(f'{refkey}db_password'),
        host=get_secret(f'{refkey}db_host'),
        port=get_secret(f'{refkey}db_port') or 5432,
    )
    if timeout:
        kwargs['options'] = f'-c statement_timeout={int(timeout * 1000)}'

    def factory():
        conn = psycopg2.connect(
            cursor_factory=psycopg2.extras.RealDictCursor, **kwargs)
        return PGConnection(conn)

    return factory


def create_tables(retry=1):
    _ensure_models_imported()
    sess = DBSession()
    if sess.conn is None:
        raise RuntimeError('call init_db() first')
    for model in list(MODELS.values()):
        for sql in model.create_table_sql():
            sess.conn.execute(sql)
    sess.conn.commit()


def drop_tables():
    _ensure_models_imported()
    sess = DBSession()
    if sess.conn is None:
        raise RuntimeError('call init_db() first')
    for model in list(MODELS.values()):
        sess.conn.execute(f'DROP TABLE IF EXISTS {model.__tablename__}')
    sess.conn.commit()


def create_database(database=None):
    """Create a fresh database file (the sqlite analogue of the reference's
    createdb + q3c extension install, zuds/model_util.py:163-271)."""
    path = _sqlite_path(database)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    conn = sqlite3.connect(path)
    conn.close()
    return path
