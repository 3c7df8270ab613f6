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

    #: attribute names cleared by ``clear()`` (cached heavyweight state)
    __diskmapped_cached_properties__ = ['_path']

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

    def unmap(self):
        """Forget the path (file.py:57-59)."""
        if hasattr(self, '_path'):
            del self._path

    def clear(self):
        """Drop cached in-memory state, reloadable from disk when mapped
        (file.py:61-65)."""
        for attr in self.__diskmapped_cached_properties__:
            if hasattr(self, attr):
                delattr(self, attr)

    # subclasses define how bytes get to/from disk
    def save(self):
        raise NotImplementedError

    def load(self):
        raise NotImplementedError
