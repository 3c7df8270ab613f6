"""Device op layer of the PyTorch port (twin of ``zuds_tpu/ops``)."""
from .detect import label_components
from .zogy import zogy_subtract, estimate_psf_from_stars

__all__ = ['label_components', 'zogy_subtract', 'estimate_psf_from_stars']
