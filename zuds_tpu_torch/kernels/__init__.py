"""Hand-written Hopper kernels of the port and their build.

H1, H10 and H28 ``warp.cu``, H2 ``background.cu``, H3 ``apply.cu``, H4 and
H4g ``detect_filter.cu``, H5 ``deblend.cu``, H6 ``compact.cu``, H7
``stamps.cu``, H8 ``median.cu``, H9 ``coadd.cu``, H11 ``subtract.cu``, H12
and H14 ``cutouts.cu``, H13, H13t, H19 and H20 ``braai.cu``, H15-H18
``zogy.cu``, H21 ``adam.cu``, H22 ``photometry.cu``, H23 ``measure.cu``,
H24 and H25 ``ccl.cu``, H26 and H27 ``objects.cu``: all CUDA C++ for
``sm_90a``, built by :mod:`.build` and wrapped by :mod:`.launch`. Nothing
here builds at import time: the kernels are built on their first CUDA
launch.
"""
from . import launch

__all__ = ['launch', 'all_wrappers']


def all_wrappers():
    """name -> wrapper function of every kernel (each has ``launches``)."""
    return dict(launch.WRAPPERS)
