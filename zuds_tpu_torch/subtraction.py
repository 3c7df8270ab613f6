"""Subtraction products (twin of ``zuds_tpu/subtraction.py:26-54,
281-413``): the product naming, the catalog stamp choice, and the
subtraction a fused pipeline batch produced, with its pixel frames left on
the card behind a thunk until something touches pixels.

The per-pair ``Subtraction.from_images`` (align, fit, subtract one pair)
comes with the per-pair path (ROADMAP queue 1, K17).
"""
from __future__ import annotations

import os

import numpy as np

from .constants import HOTPANTS_SATLEV
from .image import CalibratedImage, FITSImage
from .mask import MaskImage

__all__ = ['sub_name', 'Subtraction', 'SingleEpochSubtraction']

# science-frame keywords a subtraction inherits (subtraction.py:208-215)
_INHERIT = ('SEEING', 'MAGZP', 'APCOR1', 'APCOR2', 'APCOR3', 'APCOR4',
            'APCOR5', 'APCOR6', 'APCORUN1', 'APCORUN2', 'APCORUN3',
            'APCORUN4', 'APCORUN5', 'APCORUN6')


def sub_name(frame, template):
    """sub.<frame>_<template>.fits naming (subtraction.py:26-32)."""
    refp = os.path.basename(f'{template}')[:-5]
    newp = os.path.basename(f'{frame}')[:-5]
    outdir = os.path.dirname(f'{frame}')
    return os.path.join(outdir, f'sub.{newp}_{refp}.fits')


def _select_stamps(sci, smax=128):
    """Star stamp centers for the kernel fit, from the science catalog
    (subtraction.py:35-54)."""
    from .seeing import select_stars
    cat = sci.catalog
    stars = select_stars(cat, min_snr=10.0)
    data = stars if len(stars) else (cat.data if hasattr(cat, 'data')
                                     else cat)
    ok = data['FLUX_MAX'] < HOTPANTS_SATLEV
    data = data[ok]
    order = np.argsort(data['FLUX_APER'])[::-1]
    data = data[order[:smax]]
    xs = np.zeros(smax, dtype='f4')
    ys = np.zeros(smax, dtype='f4')
    valid = np.zeros(smax, dtype=bool)
    nsel = len(data)
    xs[:nsel] = data['X_IMAGE'] - 1.0
    ys[:nsel] = data['Y_IMAGE'] - 1.0
    valid[:nsel] = True
    return xs, ys, valid


class Subtraction:
    """Mixin: the subtraction product of the fused pipeline."""

    reference_image = None
    target_image = None

    @classmethod
    def assemble_deferred(cls, sci, ref, frames_thunk,
                          method='hotpants-fused', spatial_order=None,
                          nreg_side=3, outfile_name=None):
        """The subtraction product with its pixel frames left on the card
        (subtraction.py:280-332). ``frames_thunk``: zero-arg callable
        returning ``(diff, rms, submask)`` as host arrays, called at most
        once, on first pixel access. The pipeline already set the no-data
        bit 17 on the card."""
        if outfile_name is None:
            outfile_name = sub_name(
                sci.local_path if sci.ismapped else sci.basename,
                ref.local_path if ref.ismapped else ref.basename)
        sub = cls()
        header = sci.header.copy()
        for kw in _INHERIT:
            if kw in sci.header:
                header.set(kw, sci.header[kw])
        header.set('SUBMETH', method, 'subtraction engine')
        header.set('SUBKO', spatial_order if spatial_order is not None
                   else -1, 'kernel spatial order used')
        header.set('SUBNRX', nreg_side, 'kernel region grid used')
        sub.header = header
        sub.basename = os.path.basename(outfile_name)
        sub.reference_image = ref
        sub.target_image = sci
        for prop in ('field', 'ccdid', 'qid', 'fid'):
            setattr(sub, prop, getattr(sci, prop, None))
        sub._wcs = sci.wcs
        if hasattr(sci, 'ra'):
            for attr in ('ra', 'dec', 'ra1', 'dec1', 'ra2', 'dec2', 'ra3',
                         'dec3', 'ra4', 'dec4'):
                if hasattr(sci, attr):
                    setattr(sub, attr, getattr(sci, attr))

        mask = MaskImage.from_parent(sub)
        mask.basename = sub.basename.replace('.fits', '.mask.fits')
        sub.mask_image = mask
        sub._frames_thunk = frames_thunk
        # the product paths are reserved now (the catalog saves beside the
        # sub); the pixel files are written at materialization
        if sci.ismapped:
            sub.map_to_local_file(outfile_name)
            mask.map_to_local_file(os.path.join(
                os.path.dirname(outfile_name), mask.basename))
        mask.load = sub._materialize_frames
        return sub

    def _materialize_frames(self):
        """Fetch diff/rms/submask from the card (once) and finish the
        product assembly (subtraction.py:334-369)."""
        thunk = getattr(self, '_frames_thunk', None)
        if thunk is None:
            return
        self._frames_thunk = None
        diff, rms_out, submask = thunk()
        diff = np.asarray(diff).astype('f4')
        rms_out = np.asarray(rms_out).astype('f4')
        submask = np.asarray(submask).astype(np.int32)
        self._data = diff
        mask = self.mask_image
        mask._data = submask
        mask.refresh_bit_mask_entries_in_header()
        # a subtraction's background is identically zero by construction
        for attr, arr in (('_rmsimg', rms_out),
                          ('_bkgimg', np.zeros_like(diff)),
                          ('_bkgsubimg', diff)):
            prod = FITSImage()
            prod.data = arr
            prod.header = self.header.copy()
            prod.parent_image = self
            if self.basename:
                prod.basename = self.basename.replace(
                    '.fits', self._product_suffixes.get(attr,
                                                        f'{attr}.fits'))
            setattr(self, attr, prod)
        if self.ismapped:
            self.save()
            mask.save()
            rms_prod = self._rmsimg
            rms_prod.map_to_local_file(os.path.join(
                os.path.dirname(self.local_path), rms_prod.basename))
            rms_prod.save()

    def load(self):
        if getattr(self, '_frames_thunk', None) is not None:
            self._materialize_frames()
            return
        super().load()

    @property
    def data(self):
        if getattr(self, '_frames_thunk', None) is not None:
            self._materialize_frames()
        try:
            return self._data
        except AttributeError:
            self.load()
        return self._data

    @data.setter
    def data(self, value):
        self._data = value

    def _frame_product(self, attr):
        if getattr(self, '_frames_thunk', None) is not None:
            self._materialize_frames()
        try:
            return getattr(self, attr)
        except AttributeError:
            self._run_background()
        return getattr(self, attr)

    @property
    def rms_image(self):
        return self._frame_product('_rmsimg')

    @property
    def background_image(self):
        return self._frame_product('_bkgimg')

    @property
    def background_subtracted_image(self):
        return self._frame_product('_bkgsubimg')


class SingleEpochSubtraction(Subtraction, CalibratedImage):
    """sci - ref for one epoch."""

    __ztf_type__ = 'sesub'
