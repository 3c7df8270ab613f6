"""zuds_tpu_torch — the PyTorch + CUDA port of zuds-tpu.

A second package beside ``zuds_tpu`` (the JAX reference). It imports torch
and never jax. Every pixel path runs in full fp32: TF32 is switched off for
matmuls and cuDNN convolutions, as the reference pins Precision.HIGHEST
(zuds_tpu/ops/subtract.py:51-55). The one use of TF32 tensor cores is the
model convolution (``kernels/apply.cu``, at two or more spatial terms), in
the 3xTF32 hi/lo split, which keeps fp32 accuracy; a single TF32 pass (~3
digits) is not allowed.

The flat namespace is the reference's (``zuds_tpu/__init__.py``): every
public name there is here, each from its twin module, imported lazily on
first use; the constants come from ``zuds_tpu_torch.constants``.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')

__version__ = '0.1.0'

_LAZY_SYMBOLS = {
    'TPVWCS': 'zuds_tpu_torch.wcs',
    'timed': 'zuds_tpu_torch.tracing',
    'device_profile': 'zuds_tpu_torch.tracing',
    'File': 'zuds_tpu_torch.file',
    'UnmappedFileError': 'zuds_tpu_torch.file',
    'FITSFile': 'zuds_tpu_torch.fitsfile',
    'HasWCS': 'zuds_tpu_torch.fitsfile',
    'FITSImage': 'zuds_tpu_torch.image',
    'CalibratableImageBase': 'zuds_tpu_torch.image',
    'CalibratableImage': 'zuds_tpu_torch.image',
    'CalibratedImage': 'zuds_tpu_torch.image',
    'ScienceImage': 'zuds_tpu_torch.image',
    'MaskImageBase': 'zuds_tpu_torch.mask',
    'MaskImage': 'zuds_tpu_torch.mask',
    'PipelineFITSCatalog': 'zuds_tpu_torch.catalog',
    'PipelineRegionFile': 'zuds_tpu_torch.catalog',
    'Coadd': 'zuds_tpu_torch.coadd',
    'ReferenceImage': 'zuds_tpu_torch.coadd',
    'ScienceCoadd': 'zuds_tpu_torch.coadd',
    'Subtraction': 'zuds_tpu_torch.subtraction',
    'SingleEpochSubtraction': 'zuds_tpu_torch.subtraction',
    'MultiEpochSubtraction': 'zuds_tpu_torch.subtraction',
    'sub_name': 'zuds_tpu_torch.subtraction',
    'aperture_photometry': 'zuds_tpu_torch.photometry',
    'raw_aperture_photometry': 'zuds_tpu_torch.photometry',
    'ForcedPhotometry': 'zuds_tpu_torch.photometry',
    'estimate_seeing': 'zuds_tpu_torch.seeing',
    'Detection': 'zuds_tpu_torch.detections',
    'RealBogus': 'zuds_tpu_torch.detections',
    'filter_sexcat': 'zuds_tpu_torch.filterobjects',
    'Source': 'zuds_tpu_torch.source',
    'Thumbnail': 'zuds_tpu_torch.thumbnails',
    'Alert': 'zuds_tpu_torch.alert',
    'xmatch': 'zuds_tpu_torch.crossmatch',
    'send_alert': 'zuds_tpu_torch.send',
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
    'run_align': 'zuds_tpu_torch.swarp',
    'prepare_swarp_sci': 'zuds_tpu_torch.swarp',
    'prepare_swarp_mask': 'zuds_tpu_torch.swarp',
    'prepare_swarp_align': 'zuds_tpu_torch.swarp',
    'run_sextractor': 'zuds_tpu_torch.sextractor',
    'prepare_sextractor': 'zuds_tpu_torch.sextractor',
    'prepare_hotpants': 'zuds_tpu_torch.hotpants',
    'calibrate_astrometry': 'zuds_tpu_torch.scamp',
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
    'combine_schemas': 'zuds_tpu_torch.send',
    'safe_download': 'zuds_tpu_torch.download',
    'ipac_authenticate': 'zuds_tpu_torch.download',
    'make_triplet_for_braai': 'zuds_tpu_torch.filterobjects',
    'load_model_helper': 'zuds_tpu_torch.filterobjects',
    'JobImage': 'zuds_tpu_torch.joins',
    'CoaddImage': 'zuds_tpu_torch.joins',
    'StackedSubtractionFrame': 'zuds_tpu_torch.joins',
    'Job': 'zuds_tpu_torch.bookkeeping',
    'ForcePhotJob': 'zuds_tpu_torch.bookkeeping',
    'AlertJob': 'zuds_tpu_torch.bookkeeping',
    'FailedSubtraction': 'zuds_tpu_torch.bookkeeping',
    'show_images': 'zuds_tpu_torch.plotting',
    'plot_triplet': 'zuds_tpu_torch.plotting',
    'discrete_cmap': 'zuds_tpu_torch.plotting',
    'to_json': 'zuds_tpu_torch.json_util',
    'status': 'zuds_tpu_torch.status',
    'get_secret': 'zuds_tpu_torch.secrets',
    'load_config': 'zuds_tpu_torch.secrets',
    'fid_map': 'zuds_tpu_torch.utils',
    'get_time': 'zuds_tpu_torch.utils',
    'quick_background_estimate': 'zuds_tpu_torch.utils',
    'initialize_directory': 'zuds_tpu_torch.utils',
    'ensure_images_have_the_same_properties': 'zuds_tpu_torch.utils',
    'Header': 'zuds_tpu_torch.fits',
    'HDU': 'zuds_tpu_torch.fits',
    'read_fits': 'zuds_tpu_torch.fits',
    'write_fits': 'zuds_tpu_torch.fits',
}
_LAZY_MODULES = {name: f'zuds_tpu_torch.{name}' for name in (
    'ops', 'models', 'parallel', 'wcs', 'db', 'fits', 'constants',
    'secrets', 'utils')}


def _constant(name):
    import importlib
    constants = importlib.import_module('zuds_tpu_torch.constants')
    if name.isupper() and hasattr(constants, name):
        return getattr(constants, name)
    raise AttributeError(f'module zuds_tpu_torch has no attribute {name!r}')


def __getattr__(name):
    import importlib
    if name in _LAZY_MODULES:
        val = importlib.import_module(_LAZY_MODULES[name])
    elif name in _LAZY_SYMBOLS:
        val = getattr(importlib.import_module(_LAZY_SYMBOLS[name]), name)
    else:
        val = _constant(name)
    globals()[name] = val
    return val


def __dir__():
    from . import constants
    return sorted(set(globals()) | set(_LAZY_MODULES) | set(_LAZY_SYMBOLS)
                  | {n for n in dir(constants) if n.isupper()})
