"""Minimal ORM over sqlite3 (twin of ``zuds_tpu/db/orm.py``): the port's own
models registry, sessions and dialects, so a process that loads both
packages keeps two registries and two sets of sessions.

Declarative models, scoped sessions, identity-mapped commits and filtered
queries over the stdlib ``sqlite3`` driver, with a dialect seam where a
postgres driver (``psycopg2``, imported only by ``model_util``'s postgres
factory) slots in. Everything works with NO database bound: sessions accept
adds and answer queries with None/[] until ``model_util.init_db()``.
"""
from __future__ import annotations

import datetime
import sqlite3
import threading

__all__ = ['Column', 'Model', 'Session', 'ScopedSession', 'MODELS',
           'SqliteDialect', 'PostgresDialect', 'PGConnection']

MODELS = {}


class SqliteDialect:
    """Default dialect: SQL passes through untouched ('?' paramstyle)."""

    name = 'sqlite'

    def translate(self, sql):
        return sql

    def ddl(self, sql):
        return sql


class PostgresDialect:
    """Translation layer for postgres+q3c (the production coordination
    bus of the reference, zuds/core.py:23-24 + zuds/model_util.py:132-271).

    Query SQL is written against the sqlite conventions used throughout
    the package ('?' placeholders, sqlite type names); this dialect
    rewrites placeholders and DDL. The q3c_* spatial functions pass
    through untouched — on postgres they are the REAL q3c extension.
    """

    name = 'postgres'

    def translate(self, sql):
        return sql.replace('?', '%s')

    def ddl(self, sql):
        out = sql.replace('INTEGER PRIMARY KEY AUTOINCREMENT',
                          'BIGSERIAL PRIMARY KEY')
        out = out.replace(' BLOB', ' BYTEA')
        out = out.replace(' REAL', ' DOUBLE PRECISION')
        return out


class _PGCursorProxy:
    """Exposes the sqlite cursor surface (lastrowid, fetch*, rowcount)
    over a psycopg2 cursor."""

    def __init__(self, cur, lastrowid=None):
        self._cur = cur
        self.lastrowid = lastrowid

    @property
    def rowcount(self):
        return self._cur.rowcount

    def fetchone(self):
        return self._cur.fetchone()

    def fetchall(self):
        return self._cur.fetchall()

    def __iter__(self):
        return iter(self._cur)


class PGConnection:
    """Adapter giving a psycopg2 connection the sqlite3 connection
    surface the Session uses (``conn.execute`` shortcut, '?' placeholders,
    ``lastrowid`` on INSERT via RETURNING id, dict rows)."""

    dialect = PostgresDialect()

    def __init__(self, conn):
        self._conn = conn

    def execute(self, sql, params=()):
        head = sql.lstrip()[:12].upper()
        if head.startswith(('CREATE', 'DROP', 'ALTER')):
            sql = self.dialect.ddl(sql)
        sql = self.dialect.translate(sql)
        lastrowid = None
        cur = self._conn.cursor()
        if head.startswith('INSERT') and ' RETURNING ' not in sql.upper():
            cur.execute(sql + ' RETURNING id', tuple(params))
            row = cur.fetchone()
            lastrowid = (row['id'] if isinstance(row, dict)
                         else row[0]) if row else None
        else:
            cur.execute(sql, tuple(params))
        return _PGCursorProxy(cur, lastrowid)

    def commit(self):
        self._conn.commit()

    def rollback(self):
        self._conn.rollback()

    def close(self):
        self._conn.close()


class Column:
    """Declarative column: SQL type + default + index flag."""

    def __init__(self, ctype='TEXT', default=None, index=False,
                 primary=False, nullable=True):
        self.ctype = ctype
        self.default = default
        self.index = index
        self.primary = primary
        self.nullable = nullable
        self.name = None

    def ddl(self):
        parts = [self.name, self.ctype]
        if self.primary:
            parts.append('PRIMARY KEY')
            if self.ctype == 'INTEGER':
                parts.append('AUTOINCREMENT')
        return ' '.join(parts)


class ModelMeta(type):

    def __new__(mcs, name, bases, ns):
        cls = super().__new__(mcs, name, bases, ns)
        cols = {}
        for base in reversed(cls.__mro__):
            for k, v in vars(base).items():
                if isinstance(v, Column):
                    v.name = k
                    cols[k] = v
        cls.__columns__ = cols
        if cols and not ns.get('__abstract__', False):
            if '__tablename__' not in ns:
                cls.__tablename__ = name.lower() + 's'
            MODELS[cls.__tablename__] = cls
        return cls


class Model(metaclass=ModelMeta):
    """Base declarative model. Subclasses define Columns as class attrs."""

    __abstract__ = True

    id = Column('INTEGER', primary=True)
    created_at = Column('TIMESTAMP')
    modified = Column('TIMESTAMP', index=True)

    def __init__(self, **kwargs):
        for k, col in self.__columns__.items():
            setattr(self, k, kwargs.pop(k, col.default))
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._persisted = False

    # -- row <-> object -------------------------------------------------------
    def column_values(self):
        return {k: getattr(self, k, None) for k in self.__columns__}

    @classmethod
    def from_row(cls, row):
        obj = cls.__new__(cls)
        items = row.items() if isinstance(row, dict) \
            else zip(row.keys(), row)
        for k, v in items:
            setattr(obj, k, v)
        obj._persisted = True
        return obj

    def to_dict(self):
        return self.column_values()

    def items(self):
        return self.column_values().items()

    def __repr__(self):
        return f'<{type(self).__name__} id={getattr(self, "id", None)}>'

    # -- DDL ------------------------------------------------------------------
    @classmethod
    def create_table_sql(cls):
        cols = ', '.join(c.ddl() for c in cls.__columns__.values())
        yield f'CREATE TABLE IF NOT EXISTS {cls.__tablename__} ({cols})'
        for c in cls.__columns__.values():
            if c.index and not c.primary:
                yield (f'CREATE INDEX IF NOT EXISTS '
                       f'ix_{cls.__tablename__}_{c.name} '
                       f'ON {cls.__tablename__} ({c.name})')
        for extra in getattr(cls, '__extra_ddl__', ()):
            yield extra


def _adapt(value):
    if isinstance(value, (datetime.datetime, datetime.date)):
        return value.isoformat()
    if hasattr(value, 'item'):           # numpy scalar
        return value.item()
    if isinstance(value, dict):
        import json
        return json.dumps(value)
    if isinstance(value, bool):
        return int(value)
    return value


class Query:

    def __init__(self, session, model):
        self.session = session
        self.model = model
        self._where = []
        self._params = []
        self._order = None
        self._limit = None

    def filter_by(self, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                self._where.append(f'{k} IS NULL')
            else:
                self._where.append(f'{k} = ?')
                self._params.append(_adapt(v))
        return self

    def filter(self, clause, *params):
        """Raw SQL where-clause fragment with ? placeholders."""
        self._where.append(clause)
        self._params.extend(_adapt(p) for p in params)
        return self

    def order_by(self, clause):
        self._order = clause
        return self

    def limit(self, n):
        self._limit = n
        return self

    def _sql(self, what='*'):
        sql = f'SELECT {what} FROM {self.model.__tablename__}'
        if self._where:
            sql += ' WHERE ' + ' AND '.join(self._where)
        if self._order:
            sql += f' ORDER BY {self._order}'
        if self._limit is not None:
            sql += f' LIMIT {self._limit}'
        return sql

    def _hydrate(self, row):
        cls = self.model
        poly = getattr(cls, '__poly_on__', None)
        if poly is not None and poly in row.keys():
            cls = cls.__poly_map__.get(row[poly], cls)
        return cls.from_row(row)

    def all(self):
        if self.session.conn is None:
            return []
        cur = self.session.conn.execute(self._sql(), self._params)
        cur.row_factory = sqlite3.Row
        return [self._hydrate(r) for r in cur.fetchall()]

    def first(self):
        self._limit = 1
        rows = self.all()
        return rows[0] if rows else None

    def count(self):
        if self.session.conn is None:
            return 0
        cur = self.session.conn.execute(self._sql('COUNT(*)'), self._params)
        row = cur.fetchone()
        # postgres RealDictCursor yields dict rows ({'count': n})
        return next(iter(row.values())) if isinstance(row, dict) else row[0]

    def delete(self):
        if self.session.conn is None:
            return 0
        sql = f'DELETE FROM {self.model.__tablename__}'
        if self._where:
            sql += ' WHERE ' + ' AND '.join(self._where)
        cur = self.session.conn.execute(sql, self._params)
        return cur.rowcount

    def get(self, id_):
        return self.filter_by(id=id_).first()


class Session:
    """Unit of work over one sqlite connection (shared per ScopedSession)."""

    def __init__(self, conn=None):
        self.conn = conn
        self.pending = []

    # -- API ------------------------------------------------------------------
    def add(self, obj):
        if obj not in self.pending:
            self.pending.append(obj)

    def add_all(self, objs):
        for o in objs:
            self.add(o)

    def query(self, model):
        return Query(self, model)

    def get(self, model, id_):
        return self.query(model).get(id_)

    def execute(self, sql, params=()):
        if self.conn is None:
            raise RuntimeError('database not initialized; call init_db()')
        return self.conn.execute(sql, tuple(_adapt(p) for p in params))

    def flush(self):
        self.commit()

    def commit(self):
        if self.conn is None:
            if self.pending:
                raise RuntimeError(
                    'objects pending but no database bound; call init_db()')
            return
        now = datetime.datetime.now(datetime.timezone.utc).isoformat()
        for obj in self.pending:
            record = obj if isinstance(obj, Model) else _record_for(obj)
            if record is None:
                continue
            vals = {k: _adapt(v) for k, v in record.column_values().items()}
            vals['modified'] = now
            if getattr(record, '_persisted', False) and vals.get('id'):
                sets = ', '.join(f'{k} = ?' for k in vals if k != 'id')
                params = [v for k, v in vals.items() if k != 'id']
                self.conn.execute(
                    f'UPDATE {record.__tablename__} SET {sets} WHERE id = ?',
                    params + [vals['id']])
            else:
                vals.setdefault('created_at', now)
                vals['created_at'] = vals['created_at'] or now
                cols = [k for k, v in vals.items()
                        if not (k == 'id' and v is None)]
                sql = (f'INSERT INTO {record.__tablename__} '
                       f'({", ".join(cols)}) VALUES '
                       f'({", ".join("?" * len(cols))})')
                cur = self.conn.execute(sql, [vals[k] for k in cols])
                record.id = cur.lastrowid
                record._persisted = True
                if record is not obj:
                    obj.id = record.id
        self.conn.commit()
        self.pending = []

    def rollback(self):
        if self.conn is not None:
            self.conn.rollback()
        self.pending = []

    def close(self):
        self.pending = []


def _record_for(obj):
    """Build a Model record from a non-Model pipeline object (image, etc.)
    via its class's ``__db_model__``/``to_db_record`` hook."""
    hook = getattr(obj, 'to_db_record', None)
    if hook is not None:
        return hook()
    return None


class ScopedSession:
    """Thread-local session factory bound to one connection (the
    ``DBSession`` object of the public API: call it to get the session)."""

    def __init__(self):
        self._local = threading.local()
        self._conn_factory = None

    def configure(self, conn_factory):
        self._conn_factory = conn_factory
        # drop any existing thread sessions so they rebind
        self._local = threading.local()

    def __call__(self):
        sess = getattr(self._local, 'session', None)
        if sess is None:
            conn = self._conn_factory() if self._conn_factory else None
            sess = Session(conn)
            self._local.session = sess
        return sess

    def remove(self):
        sess = getattr(self._local, 'session', None)
        if sess is not None:
            if sess.conn is not None:
                sess.conn.close()
            self._local.session = None
