"""Subtraction products (twin of ``zuds_tpu/subtraction.py``): the product
naming, the catalog stamp choice, the per-pair ``Subtraction.from_images``
(align the reference, union the masks, fit the A&L kernel, subtract, flag
no-data, inherit headers, save) and the subtraction a fused pipeline batch
produced, with its pixel frames left on the card behind a thunk until
something touches pixels.

On the card the per-pair path runs the planned warp (H1) or the gather warp
(H10) for each aligned frame, the background cells (H2) and the detection
kernels for the science catalog; at ``method='hotpants'`` the model and the
variance convolution (H3, twice) and the difference and noise epilogue
(H11); at ``method='zogy'`` the two PSFs from star stamps (H17, H18, twice)
and the Fourier proper subtraction (cuFFT, H15, H16), which also gives the
``scorr_image`` score.

Not ported yet, each raising ``NotImplementedError``: ``data_product=True``
(the archive, ROADMAP queue 1 item 5) and ``overlapping_subtractions`` (the
database, item 5).
"""
from __future__ import annotations

import os
import time

import numpy as np

from .constants import (BAD_SUM, BIG_RMS, BKG_VAL, HOTPANTS_SATLEV,
                        KERNEL_GAUSS_DEGREES, KERNEL_RADIUS_SEEING,
                        KERNEL_SPATIAL_ORDER, MASK_BIT_NODATA_SUB,
                        SUB_NODATA_SENTINEL)
from .image import CalibratableImage, CalibratedImage, FITSImage
from .mask import MaskImage

__all__ = ['sub_name', 'Subtraction', 'SingleEpochSubtraction',
           'MultiEpochSubtraction', 'overlapping_subtractions']

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


def _not_ported(what, item):
    return NotImplementedError(
        f'{what} is not ported yet (ROADMAP queue 1: {item})')


def _inherit_header(sci, method, spatial_order, nreg_side):
    """The science header with the inherited calibration and the
    subtraction's own cards (subtraction.py:220-231)."""
    header = sci.header.copy()
    for kw in _INHERIT:
        if kw in sci.header:
            header.set(kw, sci.header[kw])
    header.set('SUBMETH', method, 'subtraction engine')
    header.set('SUBKO', spatial_order if spatial_order is not None
               else -1, 'kernel spatial order used')
    header.set('SUBNRX', nreg_side, 'kernel region grid used')
    return header


def _inherit_identity(sub, sci, ref):
    """Target, reference, group properties, WCS and sky corners of the
    science frame (subtraction.py:235-244)."""
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


class Subtraction:
    """Mixin: shared subtraction construction logic."""

    reference_image = None
    target_image = None

    @property
    def mjd(self):
        return self.target_image.mjd

    @classmethod
    def from_images(cls, sci, ref, data_product=False, tmpdir='/tmp',
                    method='hotpants', nreg_side=3, spatial_order=None,
                    smax=128, device=None, stats=None, **kwargs):
        """Subtract ``ref`` from ``sci`` (subtraction.py:68-196).

        ``method='hotpants'``: the A&L spatially varying PSF-matching
        kernel (3x3 regions, order-4 spatial variation by default, both
        lowered by the conditioning guard when the stamps are few).
        ``method='zogy'``: proper subtraction in Fourier space with PSFs
        from the 64 brightest stamps of the science catalog (the same
        positions on the aligned reference); the product also carries the
        S_corr score image as ``scorr_image``.

        ``device``: where the warps, the fit and the subtraction run, the
        card unless ``'cpu'``; ``sci`` and ``ref`` take it for their own
        products where they name no device. The aligned frames and the
        products come back to the host between the steps, as in the
        reference. ``stats`` (dict, optional) gains the host seconds of
        ``align_s``, ``products_s`` (the science frame's background, rms
        and catalog), ``fit_s`` and ``subtract_s`` (hotpants), ``psf_s``
        and ``zogy_s`` (zogy), and ``assemble_s``."""
        import torch
        from .inputs import resolve_device, upload
        from .ops.subtract import (KernelBasis, fit_kernel, spatial_terms,
                                   subtract_frames)
        from .ops.zogy import estimate_psf_from_stars, zogy_subtract
        from .seeing import estimate_seeing

        if method not in ('hotpants', 'zogy'):
            raise ValueError(f"method must be 'hotpants' or 'zogy', got "
                             f'{method!r}')
        if data_product:
            raise _not_ported('data_product=True (the archive)',
                              'item 5, persistence')
        if spatial_order is None:
            spatial_order = KERNEL_SPATIAL_ORDER
        if device is not None:
            for im in (sci, ref):
                if getattr(im, 'device', None) is None:
                    im.device = device
        device = resolve_device(device if device is not None
                                else sci.device)
        st = stats if stats is not None else {}
        clock = [time.perf_counter()]

        def lap(key):
            if device.type == 'cuda':
                torch.cuda.synchronize()
            now = time.perf_counter()
            st[key] = st.get(key, 0.0) + now - clock[0]
            clock[0] = now

        # --- geometry: bring the reference onto the science grid ------------
        remapped_ref = ref.aligned_to(sci, device=device)
        remapped_refmask = ref.mask_image.aligned_to(sci, device=device) \
            if ref.mask_image is not None else None

        # --- mask union (subtraction.py:93-100) ------------------------------
        H, W = sci.shape
        submask_data = np.zeros((H, W), dtype=np.uint32)
        if sci.mask_image is not None:
            submask_data |= np.asarray(sci.mask_image.data).astype(np.uint32)
        if remapped_refmask is not None:
            submask_data |= np.asarray(remapped_refmask.data) \
                .astype(np.uint32)
        bad = (submask_data & BAD_SUM) > 0
        lap('align_s')

        # --- science background handling -------------------------------------
        if 'SEEING' not in sci.header:
            estimate_seeing(sci)
        seeing = float(sci.header['SEEING'])
        scimbkg = np.ascontiguousarray(
            sci.background_subtracted_image.data).astype(np.float32) + BKG_VAL
        refdata = np.ascontiguousarray(
            remapped_ref.data).astype(np.float32)
        sci_rms = np.ascontiguousarray(sci.rms_image.data).astype(np.float32)
        lap('products_s')

        ref_rms_obj = getattr(ref, 'rms_image', None)
        if ref_rms_obj is not None:
            ref_rms_aligned = ref_rms_obj.aligned_to(sci, device=device)
            ref_rms = np.ascontiguousarray(ref_rms_aligned.data) \
                .astype(np.float32)
        else:
            ref_rms = np.zeros_like(sci_rms)
        lap('align_s')

        outfile_name = sub_name(
            sci.local_path if sci.ismapped else sci.basename,
            ref.local_path if ref.ismapped else ref.basename)

        # conditioning guard: the per-region fit has Nb*Nm+1 unknowns; with
        # too few star stamps per region the ridge solve degrades silently.
        # Reduce the spatial order, then the region grid, until determined
        # (subtraction.py:124-140).
        xs, ys, valid = _select_stamps(sci, smax=smax)
        nstamps = max(int(valid.sum()), 1)
        nbasis = sum((d + 1) * (d + 2) // 2 for d in KERNEL_GAUSS_DEGREES)
        while nreg_side > 1 or spatial_order > 0:
            unknowns = nbasis * len(spatial_terms(spatial_order)) + 1
            if nstamps / (nreg_side ** 2) >= 0.1 * unknowns:
                break
            if spatial_order > 0:
                spatial_order -= 1
            else:
                nreg_side -= 1
        lap('products_s')

        if method == 'zogy':
            # --- Fourier proper subtraction (subtraction.py:142-164) ------
            xs, ys, valid = _select_stamps(sci, smax=64)
            t_new = upload(scimbkg - BKG_VAL, device)
            t_ref = upload(refdata, device)
            pos = [upload(a, device) for a in (xs, ys, valid)]
            psf_new = estimate_psf_from_stars(t_new, *pos)
            # the science frame's star positions on the aligned reference:
            # refdata is already on the science grid
            psf_ref = estimate_psf_from_stars(t_ref, *pos)
            lap('psf_s')
            sn = float(np.median(sci_rms[~bad])) if (~bad).any() else 1.0
            sr = float(np.median(ref_rms[~bad])) if (~bad).any() else 1.0
            zout = zogy_subtract(t_new, t_ref, psf_new, psf_ref, sn,
                                 max(sr, 1e-3))
            diff = zout['d'].cpu().numpy()
            diff[bad] = SUB_NODATA_SENTINEL
            rms_out = np.sqrt(sci_rms ** 2 + ref_rms ** 2)
            rms_out[bad] = BIG_RMS
            scorr = zout['s_corr'].cpu().numpy()
            lap('zogy_s')
        else:
            # --- A&L kernel fit over star stamps -----------------------------
            ksize = int(2 * round(KERNEL_RADIUS_SEEING * seeing / 2) + 1)
            ksize = max(9, min(ksize, 31))
            stamp = int(2 * round(6 * seeing / 2) + 1 + ksize)
            stamp = max(stamp, ksize + 10)
            stamp = stamp + (1 - stamp % 2)
            basis = KernelBasis(ksize, seeing_sigma=seeing / 2.355)
            ivar = 1.0 / np.maximum(sci_rms ** 2 + ref_rms ** 2, 1e-6)
            ivar[bad] = 0.0
            t_ref, t_sci, t_scirms, t_refrms, t_bad = (
                upload(a, device) for a in (refdata, scimbkg, sci_rms,
                                            ref_rms, bad))
            fit = fit_kernel(t_ref, t_sci, upload(ivar, device),
                             upload(xs, device), upload(ys, device),
                             upload(valid, device), upload(basis.gx, device),
                             upload(basis.gy, device),
                             upload(basis.sums, device),
                             upload(basis.b0_2d, device), stamp=stamp,
                             order=spatial_order, nreg=nreg_side)
            lap('fit_s')
            diff_t, rms_t = subtract_frames(t_sci, t_ref, t_scirms,
                                            t_refrms, t_bad, fit, basis,
                                            order=spatial_order,
                                            nreg=nreg_side)
            diff = diff_t.cpu().numpy()
            rms_out = rms_t.cpu().numpy()
            scorr = None
            lap('subtract_s')

        sub = cls.assemble(sci, ref, diff, rms_out, submask_data,
                           method=method, spatial_order=spatial_order,
                           nreg_side=nreg_side, scorr=scorr,
                           outfile_name=outfile_name, device=device)
        lap('assemble_s')
        return sub

    @classmethod
    def assemble(cls, sci, ref, diff, rms_out, submask_data,
                 method='hotpants', spatial_order=None, nreg_side=3,
                 scorr=None, data_product=False, outfile_name=None,
                 device=None):
        """Build the subtraction product object from computed host arrays
        (subtraction.py:199-269): the no-data bit 17 where ``diff`` is the
        sentinel, the inherited header, the saved sub and mask when the
        science frame is mapped, the rms product, and with ``scorr`` the
        score image ``scorr_image`` (``*.scorr.fits``, in memory).
        ``device``: where the product computes its own products (its
        catalog), the card unless ``'cpu'``."""
        if data_product:
            raise _not_ported('data_product=True (the archive)',
                              'item 5, persistence')
        if outfile_name is None:
            outfile_name = sub_name(
                sci.local_path if sci.ismapped else sci.basename,
                ref.local_path if ref.ismapped else ref.basename)
        submask_data = np.asarray(submask_data).astype(np.uint32).copy()
        submask_data[diff == SUB_NODATA_SENTINEL] |= np.uint32(
            1 << MASK_BIT_NODATA_SUB)

        sub = cls()
        sub.device = device
        sub.header = _inherit_header(sci, method, spatial_order, nreg_side)
        sub.data = diff.astype('f4')
        sub.basename = os.path.basename(outfile_name)
        _inherit_identity(sub, sci, ref)

        mask = MaskImage.from_parent(sub, data=submask_data.astype(np.int32))
        mask.basename = sub.basename.replace('.fits', '.mask.fits')
        mask.refresh_bit_mask_entries_in_header()
        sub.mask_image = mask

        if sci.ismapped:
            sub.map_to_local_file(outfile_name)
            mask.map_to_local_file(os.path.join(
                os.path.dirname(outfile_name), mask.basename))
            sub.save()
            mask.save()
        sub._set_product('_rmsimg', rms_out)
        if scorr is not None:
            s = FITSImage()
            s.data = np.asarray(scorr).astype('f4')
            s.header = sub.header.copy()
            s.basename = sub.basename.replace('.fits', '.scorr.fits')
            sub.scorr_image = s
        return sub

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
        sub.header = _inherit_header(sci, method, spatial_order, nreg_side)
        sub.basename = os.path.basename(outfile_name)
        _inherit_identity(sub, sci, ref)

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


def overlapping_subtractions(sci, ref):
    """Single-epoch subtractions whose targets feed coadd ``sci``
    (subtraction.py:419-434): a database query."""
    raise _not_ported('overlapping_subtractions (a database query)',
                      'item 5, persistence')


class MultiEpochSubtraction(Subtraction, CalibratableImage):
    """Coadd of overlapping single-epoch subtractions
    (subtraction.py:437-474)."""

    __ztf_type__ = 'mesub'

    input_images = None

    @classmethod
    def from_images(cls, sci, ref, data_product=False, tmpdir='/tmp',
                    force_map_subs=True, input_subtractions=None,
                    device=None, **kwargs):
        """The stack of the single-epoch subtractions of ``sci``'s epochs,
        through the per-epoch coadd loop without a background. Without
        ``input_subtractions`` the reference asks the database, which
        waits. ``device``: the card unless ``'cpu'``."""
        from .coadd import ScienceCoadd, _coadd_from_images

        if not isinstance(sci, ScienceCoadd):
            raise TypeError(f'Input science image "{sci.basename}" must be '
                            f'an instance of ScienceCoadd, got {type(sci)}.')

        if input_subtractions is not None:
            images = list(input_subtractions)
        else:
            images = overlapping_subtractions(sci, ref)

        if len(images) != len(sci.input_images):
            raise ValueError(
                'Number of single-epoch subtractions != number of stack '
                f'inputs ({len(images)} vs {len(sci.input_images)})')

        outfile_name = sub_name(
            sci.local_path if sci.ismapped else sci.basename,
            ref.local_path if ref.ismapped else ref.basename)

        coadd = _coadd_from_images(cls, images, outfile_name,
                                   addbkg=False, calculate_seeing=False,
                                   device=device)
        coadd.reference_image = ref
        coadd.target_image = sci
        coadd.header.set('SEEING', sci.header['SEEING'])
        coadd.save()
        return coadd
