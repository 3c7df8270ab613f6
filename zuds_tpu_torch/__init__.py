"""zuds_tpu_torch — the PyTorch + CUDA port of zuds-tpu's subtract/detect path.

A second package beside ``zuds_tpu`` (the JAX reference). It imports torch
and never jax. Every pixel path runs in full fp32: TF32 is switched off for
matmuls and cuDNN convolutions, as the reference pins Precision.HIGHEST
(zuds_tpu/ops/subtract.py:51-55). The one use of TF32 tensor cores is the
model convolution (``kernels/apply.cu``, at two or more spatial terms), in
the 3xTF32 hi/lo split, which keeps fp32 accuracy; a single TF32 pass (~3
digits) is not allowed.

The flat namespace holds, imported lazily as in ``zuds_tpu/__init__.py``,
the filter's and the forced photometry's entry points, the persistence
layer's names (sessions, models, ``init_db``), scamp's
``calibrate_astrometry`` and the alert chain's ``Alert``, ``xmatch``,
``send_alert`` and ``combine_schemas``; the rest of the reference's
namespace is not there yet (ROADMAP queue 1, item 10).
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
    'status': 'zuds_tpu_torch.status',
    'get_secret': 'zuds_tpu_torch.secrets',
    'load_config': 'zuds_tpu_torch.secrets',
    'Detection': 'zuds_tpu_torch.detections',
    'RealBogus': 'zuds_tpu_torch.detections',
    'Source': 'zuds_tpu_torch.source',
    'Thumbnail': 'zuds_tpu_torch.thumbnails',
    'DBSession': 'zuds_tpu_torch.core',
    'RefDBSession': 'zuds_tpu_torch.core',
    'Base': 'zuds_tpu_torch.core',
    'ZTFFile': 'zuds_tpu_torch.core',
    'join_model': 'zuds_tpu_torch.core',
    'init_db': 'zuds_tpu_torch.model_util',
    'create_tables': 'zuds_tpu_torch.model_util',
    'drop_tables': 'zuds_tpu_torch.model_util',
    'get_my_share_of_work': 'zuds_tpu_torch.mpi',
    'get_nthreads': 'zuds_tpu_torch.mpi',
    'check_dependencies': 'zuds_tpu_torch.env',
    'SpatiallyIndexed': 'zuds_tpu_torch.spatial',
    'HasPoly': 'zuds_tpu_torch.spatial',
    'DR8North': 'zuds_tpu_torch.external',
    'DR8South': 'zuds_tpu_torch.external',
    'CLU': 'zuds_tpu_torch.external',
    'ZTFFileCopy': 'zuds_tpu_torch.archive',
    'HTTPArchiveCopy': 'zuds_tpu_torch.archive',
    'TapeCopy': 'zuds_tpu_torch.archive',
    'TapeArchive': 'zuds_tpu_torch.archive',
    'archive': 'zuds_tpu_torch.archive',
    'JobImage': 'zuds_tpu_torch.joins',
    'CoaddImage': 'zuds_tpu_torch.joins',
    'StackedSubtractionFrame': 'zuds_tpu_torch.joins',
    'Job': 'zuds_tpu_torch.bookkeeping',
    'ForcePhotJob': 'zuds_tpu_torch.bookkeeping',
    'AlertJob': 'zuds_tpu_torch.bookkeeping',
    'FailedSubtraction': 'zuds_tpu_torch.bookkeeping',
    'to_json': 'zuds_tpu_torch.json_util',
    'calibrate_astrometry': 'zuds_tpu_torch.scamp',
    'Alert': 'zuds_tpu_torch.alert',
    'xmatch': 'zuds_tpu_torch.crossmatch',
    'send_alert': 'zuds_tpu_torch.send',
    'combine_schemas': 'zuds_tpu_torch.send',
}
_LAZY_MODULES = {'db': 'zuds_tpu_torch.db'}


def __getattr__(name):
    import importlib
    if name in _LAZY_MODULES:
        val = importlib.import_module(_LAZY_MODULES[name])
    elif name in _LAZY_SYMBOLS:
        val = getattr(importlib.import_module(_LAZY_SYMBOLS[name]), name)
    else:
        raise AttributeError(
            f'module zuds_tpu_torch has no attribute {name!r}')
    globals()[name] = val
    return val


def __dir__():
    return sorted(set(globals()) | set(_LAZY_MODULES) | set(_LAZY_SYMBOLS))
