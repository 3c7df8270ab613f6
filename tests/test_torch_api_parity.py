"""The port's flat namespace against the reference's: every public name of
``zuds_tpu/__init__.py`` (its eager imports, its lazy tables and the
constants it star-imports; not the ``np`` module the constants leak)
resolves in ``zuds_tpu_torch``, to an object of the same kind from the
port's twin module, and the constants are equal.

The names come from the reference's tables, not from ``dir(zuds_tpu)``:
importing a submodule also sets it on its package, so what ``dir`` lists
depends on the modules imported before (and a lazy name such as
``archive`` may read back as its module). The objects compared are the
tables' targets in each package for the same reason."""
import importlib
import inspect

import numpy as np
import pytest

import zuds_tpu
import zuds_tpu_torch
from zuds_tpu import constants as jconstants

EAGER = ('status', 'get_secret', 'load_config', 'fid_map', 'get_time',
         'quick_background_estimate', 'initialize_directory',
         'ensure_images_have_the_same_properties', 'Header', 'HDU',
         'read_fits', 'write_fits')
# the submodules the eager imports leave on the package
EAGER_MODULES = ('constants', 'fits', 'secrets', 'utils')
CONSTANTS = tuple(n for n in vars(jconstants) if n.isupper())
NAMES = sorted(set(zuds_tpu._LAZY_MODULES) | set(zuds_tpu._LAZY_SYMBOLS)
               | set(EAGER) | set(EAGER_MODULES) | set(CONSTANTS))


def _target(pkg, name, const):
    if name in pkg._LAZY_SYMBOLS:
        return getattr(importlib.import_module(pkg._LAZY_SYMBOLS[name]), name)
    if name in pkg._LAZY_MODULES or name in EAGER_MODULES:
        return importlib.import_module(f'{pkg.__name__}.{name}')
    if name in CONSTANTS:
        return getattr(const, name)
    return getattr(pkg, name)


def test_the_reference_table_is_whole():
    assert len(NAMES) == 150
    assert {'TPVWCS', 'timed', 'device_profile', 'PipelineRegionFile',
            'run_sextractor', 'show_images', 'safe_download', 'Header',
            'BKG_VAL', 'db', 'parallel'} <= set(NAMES)
    assert set(NAMES) | {'np'} >= {n for n in dir(zuds_tpu)
                                    if not n.startswith('_')
                                    and not inspect.ismodule(
                                        getattr(zuds_tpu, n))}


@pytest.mark.parametrize('name', NAMES)
def test_name_resolves_in_the_port(name):
    from zuds_tpu_torch import constants as tconstants
    assert getattr(zuds_tpu_torch, name, None) is not None, name
    want = _target(zuds_tpu, name, jconstants)
    got = _target(zuds_tpu_torch, name, tconstants)
    if inspect.ismodule(want):
        assert inspect.ismodule(got)
        assert got.__name__ == want.__name__.replace('zuds_tpu',
                                                     'zuds_tpu_torch', 1)
    elif inspect.isclass(want) or inspect.isfunction(want):
        assert got.__module__.startswith('zuds_tpu_torch'), got.__module__
        assert got.__name__ == want.__name__
        assert inspect.isclass(got) == inspect.isclass(want)
    elif name.isupper() or name == 'fid_map':
        if isinstance(want, dict):
            assert got == want
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    else:
        assert type(got).__name__ == type(want).__name__, name
