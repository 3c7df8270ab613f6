"""The pipeline's tunables, read from the JAX package's ``constants.py``.

The port shares one source of truth with the reference: the file is loaded
by path, so neither ``zuds_tpu/__init__.py`` (which imports ``yaml``) nor
JAX is executed. ``zuds_tpu/constants.py`` imports only numpy.
"""
import importlib.util
from pathlib import Path

_PATH = Path(__file__).resolve().parent.parent / 'zuds_tpu' / 'constants.py'


def _load():
    spec = importlib.util.spec_from_file_location(
        'zuds_tpu_torch._reference_constants', _PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_C = _load()

BAD_SUM = _C.BAD_SUM
BIG_RMS = _C.BIG_RMS
BKG_BOX_SIZE = _C.BKG_BOX_SIZE
BKG_VAL = _C.BKG_VAL
CLEAN_PARAM = _C.CLEAN_PARAM
DETECT_NPIX = _C.DETECT_NPIX
DETECT_NSIGMA = _C.DETECT_NSIGMA
KERNEL_GAUSS_DEGREES = _C.KERNEL_GAUSS_DEGREES
KERNEL_GAUSS_SIGMAS = _C.KERNEL_GAUSS_SIGMAS
KERNEL_SPATIAL_ORDER = _C.KERNEL_SPATIAL_ORDER
APERTURE_RADIUS_PX = _C.APERTURE_RADIUS_PX
MASK_BIT_NODATA_ALIGN = _C.MASK_BIT_NODATA_ALIGN
MASK_BIT_NODATA_SUB = _C.MASK_BIT_NODATA_SUB
MAX_DETECTIONS = _C.MAX_DETECTIONS
NREG_SIDE = _C.NREG_SIDE
SUB_NODATA_SENTINEL = _C.SUB_NODATA_SENTINEL
