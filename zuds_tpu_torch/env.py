"""Runtime environment checks (twin of ``zuds_tpu/env.py``).

The port runs no external binaries either; the check inventories its own
stack instead: torch and numpy, the CUDA card torch sees, and ``nvcc``
(which builds the port's kernels at first use) when it is on the machine.
"""
from __future__ import annotations

__all__ = ['check_dependencies', 'DEPENDENCIES']

DEPENDENCIES = ('torch', 'numpy')


def _nvcc():
    """``nvcc``'s path where the kernels' builder finds it, or None."""
    from .kernels.build import _nvcc as find
    try:
        return find()
    except RuntimeError:
        return None


def check_dependencies(deps=DEPENDENCIES, verbose=False):
    """Verify importability of the python stack; returns an info dict
    (each module's version, and with ``verbose`` the card and nvcc)."""
    import importlib
    info = {}
    missing = []
    for name in deps:
        try:
            mod = importlib.import_module(name)
            info[name] = getattr(mod, '__version__', 'unknown')
        except ImportError:
            missing.append(name)
    if missing:
        raise ImportError(f'missing required dependencies: {missing}')
    if verbose:
        import torch
        info['cuda'] = torch.version.cuda
        info['devices'] = [torch.cuda.get_device_name(i)
                           for i in range(torch.cuda.device_count())]
        info['nvcc'] = _nvcc()
        print(info)
    return info
