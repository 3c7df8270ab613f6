"""Device op layer of the PyTorch port (twin of ``zuds_tpu/ops``)."""
from .zogy import zogy_subtract, estimate_psf_from_stars

__all__ = ['zogy_subtract', 'estimate_psf_from_stars']
