"""Pipeline catalogs (twin of ``zuds_tpu/catalog.py:23-347``): detection
rows as a structured numpy array with SExtractor-named columns, the
reference's ``kill_flagged`` row filter, and the FITS bintable on disk.

``from_pipeline`` takes the fused pipeline's fixed-size rows (host numpy
only; no frame is touched). ``from_image`` detects on one image outside
the pipeline (a coadd, for its seeing): ``detect_sources``, the r = 3 px
apertures and the windowed/Kron refinement run on the image's device.
"""
from __future__ import annotations

import os

import numpy as np

from .constants import BAD_SUM, DETECT_NSIGMA, MAX_DETECTIONS
from .file import File
from .fits import Header, read_fits, table_to_hdu, write_fits
from .ops.detect import DETECTION_FIELDS
from .parallel.pipeline import REFINE_KEYS

__all__ = ['CATALOG_DTYPE', 'PipelineFITSCatalog']

# SExtractor-compatible output columns (catalog.py:23-48)
CATALOG_DTYPE = [
    ('NUMBER', 'i4'),
    ('X_IMAGE', 'f4'), ('Y_IMAGE', 'f4'),
    ('XWIN_IMAGE', 'f4'), ('YWIN_IMAGE', 'f4'),
    ('X_WORLD', 'f8'), ('Y_WORLD', 'f8'),
    ('XWIN_WORLD', 'f8'), ('YWIN_WORLD', 'f8'),
    ('A_IMAGE', 'f4'), ('B_IMAGE', 'f4'), ('THETA_IMAGE', 'f4'),
    ('AWIN_IMAGE', 'f4'), ('BWIN_IMAGE', 'f4'),
    ('ERRAWIN_IMAGE', 'f4'), ('ERRBWIN_IMAGE', 'f4'),
    ('ERRTHETAWIN_IMAGE', 'f4'),
    ('ERRA_WORLD', 'f8'), ('ERRB_WORLD', 'f8'), ('ERRTHETA_WORLD', 'f8'),
    ('ELONGATION', 'f4'), ('FWHM_IMAGE', 'f4'),
    ('FLUX_ISO', 'f4'), ('FLUX_AUTO', 'f4'), ('FLUXERR_AUTO', 'f4'),
    ('FLUX_APER', 'f4'), ('FLUXERR_APER', 'f4'),
    ('MAG_AUTO', 'f4'), ('MAGERR_AUTO', 'f4'),
    ('FLUX_MAX', 'f4'), ('ISOAREA_IMAGE', 'f4'),
    ('MU_MAX', 'f4'), ('BACKGROUND', 'f4'), ('CLASS_STAR', 'f4'),
    ('FLAGS', 'i2'), ('FLAGS_WEIGHT', 'i2'), ('IMAFLAGS_ISO', 'i4'),
    ('GOODCUT', 'i2'), ('RB', 'f4'),
    # the pipeline's filter diagnostics: r=6 aperture sums over the rms
    # and bad-pixel maps and the negative-pixel veto (NEGPIX = -1: not
    # precomputed, filter_sexcat derives all three from the frames)
    ('BPMCUT', 'f4'), ('RMSCUT', 'f4'), ('NEGPIX', 'i2'),
]


class PipelineFITSCatalog(File):
    """Catalog of detections on one image, disk-mapped as a FITS bintable."""

    image = None

    @property
    def data(self):
        try:
            return self._data
        except AttributeError:
            self.load()
        return self._data

    @data.setter
    def data(self, value):
        self._data = value

    def __len__(self):
        return len(self.data)

    def load(self):
        hdus = read_fits(self.local_path)
        tables = [h for h in hdus if h.is_table]
        self._data = tables[-1].data
        self.header = tables[-1].header

    def save(self, path=None):
        if path is not None:
            self.map_to_local_file(path)
        header = getattr(self, 'header', None)
        write_fits(self.local_path, [table_to_hdu(self.data, header)])

    @classmethod
    def from_file(cls, fname):
        obj = cls()
        obj.map_to_local_file(fname)
        obj.basename = os.path.basename(fname)
        obj.load()
        return obj

    @classmethod
    def from_image(cls, image, kill_flagged=True, tmpdir=None,
                   nsigma=DETECT_NSIGMA, max_det=MAX_DETECTIONS, device=None):
        """Detect sources on ``image`` and build its catalog
        (catalog.py:94-143): the detection op on the background-subtracted
        frame, r = 3 px apertures and the refinement at the valid rows, the
        segmentation map attached as ``image.segm_image``, the reference's
        ``kill_flagged`` row filter. ``tmpdir`` is the reference's third
        parameter, unused there and here. ``device``: where the ops run;
        ``image.device`` when None (the card unless ``'cpu'``)."""
        import torch
        from .inputs import resolve_device
        from .ops.detect import detect_sources
        from .ops.measure import refine_detections
        from .ops.photometry import aperture_photometry_batched

        device = resolve_device(device if device is not None
                                else image.device)

        def dev(a, dtype):
            return torch.from_numpy(
                np.ascontiguousarray(a).astype(dtype)).to(device)

        bkgsub = dev(image.background_subtracted_image.data, np.float32)
        rms = dev(image.rms_image.data, np.float32)
        if image.mask_image is not None:
            mask = dev(image.mask_image.data, np.int32)
        else:
            mask = torch.zeros(bkgsub.shape, dtype=torch.int32,
                               device=device)
        weight_ok = dev(np.asarray(image.weight_image.data) > 0, bool)

        det = detect_sources(bkgsub, rms, mask, weight_ok, nsigma=nsigma,
                             max_det=max_det)
        idx_d = torch.nonzero(det['valid']).reshape(-1)
        rows = {k: det[k][idx_d] for k in ('x', 'y', 'a', 'b', 'theta',
                                           'fwhm')}
        phot = aperture_photometry_batched(bkgsub, rms, mask, rows['x'],
                                           rows['y'])
        ref_meas = refine_detections(bkgsub, rms, *rows.values())
        out = {k: v.cpu().numpy() for k, v in det.items() if k != 'labels'}
        bkg = np.ascontiguousarray(image.background_image.data)
        obj = cls._build(
            image, out, idx_d.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in phot.items()},
            {k: v.cpu().numpy() for k, v in ref_meas.items()},
            filter_cols=None, background=bkg, kill_flagged=kill_flagged,
            nsigma=nsigma)

        # attach the segmentation check-image
        image._set_product('_segmimg', det['labels'].cpu().numpy(),
                           dtype='i4')

        if image.ismapped:
            obj.map_to_local_file(os.path.join(
                os.path.dirname(image.local_path), obj.basename))
            obj.save()
        image.catalog = obj
        return obj

    @classmethod
    def from_pipeline(cls, image, pout, frame=None, kill_flagged=True,
                      nsigma=DETECT_NSIGMA, save=True):
        """Catalog from the pipeline's host outputs (catalog.py:145-196):
        ``pout`` maps the output names of ``SubtractDetectPipeline`` to
        numpy arrays; ``frame`` selects the batch index (None when already
        unbatched). Only the fixed-size rows are read."""

        def sel(a):
            a = np.asarray(a)
            return a[frame] if frame is not None else a

        out = {f: sel(pout[f'det_{f}']) for f in DETECTION_FIELDS}
        out['valid'] = sel(pout['det_valid'])
        idx = np.nonzero(out['valid'])[0]
        phot = {k: sel(pout[f'ap_{k}'])[idx]
                for k in ('flux', 'fluxerr', 'flags')}
        ref_meas = {k: sel(pout[f'det_{k}'])[idx] for k in REFINE_KEYS}
        filter_cols = {
            'BPMCUT': sel(pout['det_bpm_ap'])[idx],
            # RMSCUT is the r=6 aperture MEAN of the rms map
            'RMSCUT': sel(pout['det_rms_ap'])[idx] / (np.pi * 36.0),
            'NEGPIX': sel(pout['det_negpix'])[idx].astype('i2'),
        }
        obj = cls._build(image, out, idx, phot, ref_meas,
                         filter_cols=filter_cols,
                         kill_flagged=kill_flagged, nsigma=nsigma)
        obj.header.set('RMSMED', float(sel(pout['rms_med'])),
                       'median unmasked rms (device)')
        for k in ('pix', 'deblend', 'obj'):
            obj.header.set(f'OVF{k.upper()[:5]}',
                           int(sel(pout[f'det_{k}_overflow'])),
                           f'detect {k} capacity overflow (frame total)')
        if save and image.ismapped:
            obj.map_to_local_file(os.path.join(
                os.path.dirname(image.local_path), obj.basename))
            obj.save()
        image.catalog = obj
        return obj

    @classmethod
    def _build(cls, image, out, idx, phot, ref_meas, filter_cols,
               background=None, kill_flagged=True, nsigma=DETECT_NSIGMA):
        """The structured catalog from the detection rows ``out``, the
        indices ``idx`` of the valid rows, and the r=3 px aperture
        photometry ``phot`` and windowed/Kron measures ``ref_meas`` at
        those rows (catalog.py:198-347). ``filter_cols``: the pipeline's
        BPMCUT, RMSCUT, NEGPIX columns, or None (not precomputed).
        ``background``: the image's background map for the BACKGROUND
        column, or None for a subtraction (identically zero)."""
        n = idx.size
        xs = np.array(out['x'])[idx]
        ys = np.array(out['y'])[idx]
        xwin = np.array(ref_meas['xwin'])
        ywin = np.array(ref_meas['ywin'])

        cat = np.zeros(n, dtype=CATALOG_DTYPE)
        cat['NUMBER'] = np.arange(1, n + 1)
        # SExtractor pixel coordinates are FITS 1-based
        cat['X_IMAGE'] = xs + 1.0
        cat['Y_IMAGE'] = ys + 1.0
        cat['XWIN_IMAGE'] = xwin + 1.0
        cat['YWIN_IMAGE'] = ywin + 1.0
        if 'CRVAL1' in image.header:
            ra, dec = image.wcs.pix2sky_0(xs, ys)
            cat['X_WORLD'] = ra
            cat['Y_WORLD'] = dec
            raw, decw = image.wcs.pix2sky_0(xwin, ywin)
            cat['XWIN_WORLD'] = raw
            cat['YWIN_WORLD'] = decw
        for src, dst in [('a', 'A_IMAGE'), ('b', 'B_IMAGE'),
                         ('elongation', 'ELONGATION'),
                         ('fwhm', 'FWHM_IMAGE'), ('flux', 'FLUX_ISO'),
                         ('peak', 'FLUX_MAX'), ('npix', 'ISOAREA_IMAGE')]:
            cat[dst] = np.array(out[src])[idx]
        cat['THETA_IMAGE'] = np.degrees(np.array(out['theta'])[idx])
        cat['AWIN_IMAGE'] = np.array(ref_meas['awin'])
        cat['BWIN_IMAGE'] = np.array(ref_meas['bwin'])
        cat['ERRAWIN_IMAGE'] = np.array(ref_meas['errawin'])
        cat['ERRBWIN_IMAGE'] = np.array(ref_meas['errbwin'])
        cat['ERRTHETAWIN_IMAGE'] = np.degrees(
            np.array(ref_meas['errthetawin']))
        # the WORLD error ellipse through the local pixel scale
        try:
            pixscale_deg = image.wcs.pixel_scale_arcsec() / 3600.0
        except Exception:
            pixscale_deg = 1.0 / 3600.0
        cat['ERRA_WORLD'] = cat['ERRAWIN_IMAGE'] * pixscale_deg
        cat['ERRB_WORLD'] = cat['ERRBWIN_IMAGE'] * pixscale_deg
        cat['ERRTHETA_WORLD'] = cat['ERRTHETAWIN_IMAGE']
        cat['FLAGS'] = np.array(out['flags'])[idx] & ~np.int32(1)
        cat['FLAGS_WEIGHT'] = (np.array(out['flags'])[idx] & 1)
        cat['IMAFLAGS_ISO'] = np.array(out['imaflags'])[idx]
        cat['FLUX_APER'] = np.array(phot['flux'])
        cat['FLUXERR_APER'] = np.array(phot['fluxerr'])
        cat['FLUX_AUTO'] = np.array(ref_meas['flux_auto'])
        cat['FLUXERR_AUTO'] = np.array(ref_meas['fluxerr_auto'])
        zp = image.header.get('MAGZP', 0.0) or 0.0
        with np.errstate(divide='ignore', invalid='ignore'):
            cat['MAG_AUTO'] = zp - 2.5 * np.log10(
                np.where(cat['FLUX_AUTO'] > 0, cat['FLUX_AUTO'], np.nan))
            cat['MAGERR_AUTO'] = 1.0857 * cat['FLUXERR_AUTO'] \
                / np.where(cat['FLUX_AUTO'] > 0, cat['FLUX_AUTO'], np.nan)
        try:
            pixscale = image.wcs.pixel_scale_arcsec()
        except Exception:
            pixscale = 1.0
        with np.errstate(divide='ignore', invalid='ignore'):
            cat['MU_MAX'] = zp - 2.5 * np.log10(
                np.where(cat['FLUX_MAX'] > 0,
                         cat['FLUX_MAX'] / pixscale ** 2, np.nan))
        # the local mesh background at the centroid; a subtraction's is
        # identically zero by construction
        if background is not None:
            yi = np.clip(np.round(ys).astype(int), 0,
                         background.shape[0] - 1)
            xi = np.clip(np.round(xs).astype(int), 0,
                         background.shape[1] - 1)
            cat['BACKGROUND'] = background[yi, xi]
        else:
            cat['BACKGROUND'] = 0.0
        # CLASS_STAR: logistic on concentration (FWHM vs seeing) and
        # elongation (catalog.py:308-319)
        seeing = image.header.get('SEEING')
        if not seeing or not np.isfinite(seeing):
            seeing = (float(np.nanmedian(cat['FWHM_IMAGE'])) if len(cat)
                      else 2.0)
        conc = cat['FWHM_IMAGE'] / max(float(seeing), 1e-3)
        z1 = np.clip(-8.0 * (1.25 - conc), -60.0, 60.0)
        z2 = np.clip(-4.0 * (1.6 - cat['ELONGATION']), -60.0, 60.0)
        cat['CLASS_STAR'] = 1.0 / (1 + np.exp(z1)) / (1 + np.exp(z2))
        cat['GOODCUT'] = 0
        cat['RB'] = np.nan
        if filter_cols is not None:
            for k, v in filter_cols.items():
                cat[k] = v
        else:
            cat['BPMCUT'] = np.nan
            cat['RMSCUT'] = np.nan
            cat['NEGPIX'] = -1

        if kill_flagged:
            # drop rows whose isophotal area touches a fatal mask bit or a
            # zero-weight pixel (catalog.py:330-336)
            good = ((cat['IMAFLAGS_ISO'] & BAD_SUM) == 0) \
                & (cat['FLAGS_WEIGHT'] == 0)
            cat = cat[good]
            cat['NUMBER'] = np.arange(1, len(cat) + 1)

        obj = cls()
        obj.image = image
        obj.header = Header()
        obj.header.set('SEXNNW', False, 'device detection op, not SE')
        obj.header.set('NDETECT', len(cat))
        obj.header.set('NSIGMA', float(nsigma))
        obj.data = cat
        if image.basename:
            obj.basename = image.basename.replace('.fits', '.cat')
        return obj
