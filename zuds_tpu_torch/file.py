"""Memory-object <-> disk-file mapping protocol (the port's own copy of
``zuds_tpu/file.py``).

A ``File`` is an in-memory object optionally *mapped* to a path on disk.
Unmapped objects live purely in memory; ``map_to_local_file`` associates a
path, after which ``save()`` persists and ``load()`` refreshes. The pipeline
uses this to treat every product (science frame, mask, weight, rms, catalog)
uniformly whether it was just computed on device or read back from disk.
"""
from __future__ import annotations

import os

__all__ = ['File', 'UnmappedFileError']


class UnmappedFileError(FileNotFoundError):
    """Raised when disk access is attempted on an unmapped File."""


class File:

    def __init__(self, basename=None):
        if basename is not None:
            self.basename = basename

    @property
    def basename(self):
        return getattr(self, '_basename', None)

    @basename.setter
    def basename(self, value):
        self._basename = value

    def map_to_local_file(self, path, quiet=True):
        self._path = str(os.path.abspath(path))
        if self.basename is None:
            self.basename = os.path.basename(path)
        if not quiet:
            print(f'mapped {self.basename} to {self._path}')

    @property
    def local_path(self):
        try:
            return self._path
        except AttributeError:
            raise UnmappedFileError(
                f'{getattr(self, "basename", "<anonymous>")} is not mapped '
                f'to a local file')

    @property
    def ismapped(self):
        return hasattr(self, '_path')

    # subclasses define how bytes get to/from disk
    def save(self):
        raise NotImplementedError

    def load(self):
        raise NotImplementedError
