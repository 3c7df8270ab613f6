"""Device op layer of the PyTorch port (twin of ``zuds_tpu/ops``): the
reference's flat re-exports. Importing it needs no card and builds no
kernel: the hand kernels are built at their first launch."""
from .resample import (upsample_mapping, warp_image, warp_mask,
                       warp_image_mask, lanczos3)
from .background import background_mesh, interpolate_mesh
from .convolve import conv2_same, fft_convolve_same, DEFAULT_FILTER
from .detect import detect_sources, label_components
from .photometry import aperture_photometry_batched, circle_pixel_overlap
from .coadd import clipped_coadd, combine_masks, fluxscale, clipped_coadd_scan
from .subtract import KernelBasis, fit_kernel, apply_kernel, subtract_frames
from .zogy import zogy_subtract, estimate_psf_from_stars

__all__ = [
    'upsample_mapping', 'warp_image', 'warp_mask', 'warp_image_mask',
    'lanczos3', 'background_mesh', 'interpolate_mesh', 'conv2_same',
    'fft_convolve_same', 'DEFAULT_FILTER', 'detect_sources',
    'label_components', 'aperture_photometry_batched', 'circle_pixel_overlap',
    'clipped_coadd', 'combine_masks', 'fluxscale', 'clipped_coadd_scan',
    'KernelBasis', 'fit_kernel', 'apply_kernel', 'subtract_frames',
    'zogy_subtract', 'estimate_psf_from_stars',
]
