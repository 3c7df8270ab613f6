"""Demo: the whole chain on synthetic ZTF-like data, through the port (twin
of the repo's ``demo.py``).

    python -m zuds_tpu_torch.demo [workdir] [--device cpu] [--size N]

Builds a reference coadd from dithered epochs, subtracts a science epoch
holding a planted transient, detects and filters the candidates, runs
forced photometry at the transient, records the subtraction and its first
candidate in a sqlite file and spools an Avro alert. It runs on the card
unless ``--device cpu`` is given; ``--size`` sets the frames' side (512,
the reference demo's, by default). Without ``$ZUDS_CONFIG`` the config is
``<workdir>/config.yaml``, seeded with the alerts spooled under
``<workdir>/data``.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

__all__ = ['make_night', 'main', 'TRANSIENT']

# the planted transient: (x, y, flux) on the science frame
TRANSIENT = (130.3, 141.7, 25000.0)


def make_night(workdir, H=512, W=512, nepochs=5):
    """Write ``nepochs`` dithered epochs (seeing 1.8 px) and one science
    frame (seeing 2.4 px) holding :data:`TRANSIENT`, each with its mask
    sibling, as demo.py:17-79 writes them. Returns (epoch paths, science
    path)."""
    from .fits import HDU, Header, write_fits
    from .wcs import TPVWCS
    rng = np.random.default_rng(7)
    scale = 1.01 / 3600.0
    xs = rng.uniform(30, W - 30, 50)
    ys = rng.uniform(30, H - 30, 50)
    fl = rng.uniform(8000, 60000, 50)
    base = TPVWCS.simple(crval=(150.1, 35.2), crpix=(W / 2, H / 2),
                         scale_deg=scale)
    ra, dec = base.pix2sky_0(xs, ys)

    def render(exs, eys, seeing, transient=None):
        yy, xx = np.mgrid[0:H, 0:W]
        sig = seeing / 2.355
        img = np.full((H, W), 150.0)
        for x, y, f in zip(exs, eys, fl):
            img += f / (2 * np.pi * sig ** 2) * np.exp(
                -((xx - x) ** 2 + (yy - y) ** 2) / (2 * sig ** 2))
        if transient:
            tx, ty, tf = transient
            img += tf / (2 * np.pi * sig ** 2) * np.exp(
                -((xx - tx) ** 2 + (yy - ty) ** 2) / (2 * sig ** 2))
        return (img + rng.normal(0, 5.0, (H, W))).astype('f4')

    def write(path, data, wcs, mjd, seeing):
        h = Header()
        wcs.to_header(h)
        for k, v in [('MAGZP', 26.0), ('OBSMJD', mjd),
                     ('OBSJD', mjd + 2400000.5), ('FIELDID', 679),
                     ('CCDID', 1), ('QID', 2), ('FILTERID', 2),
                     ('SATURATE', 60000.0), ('SEEING', seeing),
                     ('FILENAME',
                      'ztf_20180815000000_000679_zr_c01_o_q2_sciimg.fits')]:
            h.set(k, v)
        write_fits(path, [HDU(h, data)])
        write_fits(path.replace('sciimg', 'mskimg'),
                   [HDU(h.copy(), np.zeros(data.shape, np.int16))])

    epochs = []
    for i in range(nepochs):
        w = TPVWCS.simple(crval=(150.1, 35.2),
                          crpix=(W / 2 + rng.uniform(-4, 4),
                                 H / 2 + rng.uniform(-4, 4)),
                          scale_deg=scale)
        ex, ey = w.sky2pix_0(ra, dec)
        p = os.path.join(workdir, f'ztf_e{i}_679_sciimg.fits')
        write(p, render(ex, ey, 1.8), w, 58300.0 + i, 1.8)
        epochs.append(p)
    wsci = TPVWCS.simple(crval=(150.1, 35.2), crpix=(W / 2, H / 2),
                         scale_deg=scale)
    sx, sy = wsci.sky2pix_0(ra, dec)
    sci_path = os.path.join(workdir, 'ztf_sci_679_sciimg.fits')
    write(sci_path, render(sx, sy, 2.4, transient=TRANSIENT), wsci,
          58345.25, 2.4)
    return epochs, sci_path


def _seed_config(workdir):
    """``<workdir>/config.yaml`` (mode 0600), the port's default config
    with the data directory under ``workdir``, unless it exists."""
    from .secrets import DEFAULT_CONFIG
    path = os.path.join(workdir, 'config.yaml')
    if not os.path.exists(path):
        with open(DEFAULT_CONFIG) as f:
            text = f.read()
        text = text.replace('base_data_directory: /tmp/zuds-tpu-data',
                            'base_data_directory: '
                            + os.path.join(workdir, 'data'))
        with open(os.open(path, os.O_WRONLY | os.O_CREAT, 0o600), 'w') as f:
            f.write(text)
    return path


def main(workdir='/tmp/zuds-tpu-demo', device=None, size=512):
    """The demo (demo.py:82-144) on ``device`` (the card unless
    ``'cpu'``). Returns a summary: the reference's SEEING and MAGZP, the
    candidates, the transient's forced flux and error, the records' ids
    and the spooled alert's topic."""
    os.makedirs(workdir, exist_ok=True)
    if 'ZUDS_CONFIG' not in os.environ:
        os.environ['ZUDS_CONFIG'] = _seed_config(workdir)

    import zuds_tpu_torch as zuds
    from .core import record_from_image
    from .inputs import resolve_device
    from .status import status

    device = resolve_device(device)
    with status('synthesizing a night of ZTF-like quadrant frames'):
        epoch_paths, sci_path = make_night(workdir, size, size)

    with status('loading epochs'):
        epochs = [zuds.ScienceImage.from_file(p) for p in epoch_paths]
        sci = zuds.ScienceImage.from_file(sci_path)

    with status('building the reference coadd (Lanczos warp + CLIPPED)'):
        ref = zuds.ReferenceImage.from_images(
            epochs, os.path.join(workdir, 'ref.fits'), device=device)
    print(f'  reference: {ref.basename}, seeing '
          f'{ref.header["SEEING"]:.2f} px, ZP {ref.header["MAGZP"]}')

    with status('PSF-matching subtraction (A&L kernel)'):
        sub = zuds.SingleEpochSubtraction.from_images(
            sci, ref, nreg_side=1, spatial_order=1, device=device)

    with status('detect + quality filter'):
        cat = sub.catalog
        zuds.filter_sexcat(cat, ml=False)
        dets = zuds.Detection.from_catalog(cat, filter=True)
    print(f'  {len(dets)} candidates survive the funnel')

    with status('forced photometry at the transient'):
        ra_t, dec_t = sub.wcs.pix2sky_0(TRANSIENT[0], TRANSIENT[1])
        res = zuds.aperture_photometry(sub, [float(ra_t)], [float(dec_t)],
                                       assume_background_subtracted=True,
                                       device=device)
    print(f'  flux {res["flux"][0]:.0f} +- {res["fluxerr"][0]:.0f} '
          f'(injected {TRANSIENT[2]:.0f} x aperture fraction)')

    topic = None
    with status('persisting to the DB + spooling an Avro alert'):
        zuds.init_db(database=os.path.join(workdir, 'demo.db'))
        zuds.create_tables()
        sess = zuds.DBSession()
        rec = record_from_image(sub, 'sesub')
        sess.add(rec)
        sess.commit()
        if dets:
            det = dets[0]
            det.image_id = rec.id
            sess.add(det)
            sess.commit()
            alert = zuds.Alert.from_detection(det)
            topic = zuds.send_alert(alert)
            print(f'  alert spooled to topic {topic}')

    print('\ndemo complete; products in', workdir)
    return {'ref_seeing': float(ref.header['SEEING']),
            'ref_magzp': float(ref.header['MAGZP']),
            'candidates': dets, 'catalog': cat,
            'flux': float(res['flux'][0]),
            'fluxerr': float(res['fluxerr'][0]),
            'record_id': rec.id, 'topic': topic, 'subtraction': sub}


def cli(argv=None):
    ap = argparse.ArgumentParser(prog='python -m zuds_tpu_torch.demo',
                                 description=__doc__.split('\n\n')[0])
    ap.add_argument('workdir', nargs='?', default='/tmp/zuds-tpu-demo')
    ap.add_argument('--device', default=None,
                    help="'cpu', or a CUDA device (the card by default)")
    ap.add_argument('--size', type=int, default=512)
    args = ap.parse_args(argv)
    main(args.workdir, args.device, args.size)
    return 0


if __name__ == '__main__':
    sys.exit(cli())
