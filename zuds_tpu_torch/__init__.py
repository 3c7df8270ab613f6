"""zuds_tpu_torch — the PyTorch + CUDA port of zuds-tpu's subtract/detect path.

A second package beside ``zuds_tpu`` (the JAX reference). It imports torch
and never jax. Every pixel path runs in full fp32: TF32 is switched off for
matmuls and cuDNN convolutions, as the reference pins Precision.HIGHEST
(zuds_tpu/ops/subtract.py:51-55). The one use of TF32 tensor cores is the
model convolution (``kernels/apply.cu``, at two or more spatial terms), in
the 3xTF32 hi/lo split, which keeps fp32 accuracy; a single TF32 pass (~3
digits) is not allowed.

The flat namespace holds, imported lazily as in ``zuds_tpu/__init__.py``,
the filter's and the forced photometry's entry points; the rest of the
reference's namespace is not there yet (ROADMAP queue 1, item 10).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')

__version__ = '0.1.0'

_LAZY_SYMBOLS = {
    'filter_sexcat': 'zuds_tpu_torch.filterobjects',
    'make_triplet_for_braai': 'zuds_tpu_torch.filterobjects',
    'load_model_helper': 'zuds_tpu_torch.filterobjects',
    'aperture_photometry': 'zuds_tpu_torch.photometry',
    'raw_aperture_photometry': 'zuds_tpu_torch.photometry',
    'ForcedPhotometry': 'zuds_tpu_torch.photometry',
}


def __getattr__(name):
    if name in _LAZY_SYMBOLS:
        import importlib
        val = getattr(importlib.import_module(_LAZY_SYMBOLS[name]), name)
        globals()[name] = val
        return val
    raise AttributeError(f'module zuds_tpu_torch has no attribute {name!r}')


def __dir__():
    return sorted(set(globals()) | set(_LAZY_SYMBOLS))
