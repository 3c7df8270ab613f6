"""The pipelines' per-frame state: kernel-basis tables and input tuples,
and the synthetic scenes and weights the tests and ``chip_smoke.py`` use.

Neither image path has learned weights. What the subtract/detect path
carries is the 14-array input tuple of
``zuds_tpu/parallel/pipeline.py:133-140`` and the A&L kernel-basis tables
(``ops.subtract.KernelBasis``, re-exported here); the coadd path carries
the 8-array tuple of ``make_coadd_pipeline`` (pipeline.py:441-447). All
are built in host numpy, byte-for-byte as the JAX package builds them,
and moved onto a device by :func:`to_torch`.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .ops.subtract import KernelBasis

__all__ = ['KernelBasis', 'synth_inputs', 'to_torch', 'INPUT_NAMES',
           'COADD_INPUT_NAMES', 'resolve_device', 'upload', 'upload_mask',
           'write_night_pairs', 'night_stars', 'forced_positions',
           'write_coadd_epochs', 'coadd_stars', 'write_gaia_cache',
           'spread_braai', 'labelled_triplets', 'coadd_inputs']

# order of the batched pipeline inputs (zuds_tpu/parallel/pipeline.py:133-140)
INPUT_NAMES = ('sci', 'sci_mask', 'ref', 'ref_mask', 'grid_u', 'grid_v',
               'stamp_x', 'stamp_y', 'stamp_valid', 'basis_gx', 'basis_gy',
               'basis_sums', 'b0', 'cov_bounds')
_MASK_SLOTS = (1, 3)
_BOOL_SLOTS = (8,)
# order of the coadd pipeline's inputs (pipeline.py:441-447), each with a
# leading epoch dimension
COADD_INPUT_NAMES = ('imgs', 'sats', 'masks', 'grid_u', 'grid_v',
                     'cov_bounds', 'scales', 'valid')
_COADD_MASK_SLOTS = (2,)

# Lanczos-3 support (zuds_tpu/ops/resample.py:29)
SUPPORT = 3


def synth_inputs(B, H, W, cfg, seed=0):
    """Synthetic batched pipeline inputs (stars pasted as stamps), the
    numpy-only twin of ``__graft_entry__._synth_inputs``: the same seed
    gives byte-identical arrays. Returns the 14-tuple in INPUT_NAMES order.
    """
    rng = np.random.default_rng(seed)
    k = 25
    r = k // 2
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]

    def frame(sigma, nstars, star_xy=None, fluxes=None):
        img = np.full((H, W), 150.0, dtype='f4')
        psf = np.exp(-(xx ** 2 + yy ** 2) / (2 * sigma ** 2)) \
            / (2 * np.pi * sigma ** 2)
        if star_xy is None:
            star_xy = np.stack([rng.integers(r + 5, W - r - 5, nstars),
                                rng.integers(r + 5, H - r - 5, nstars)], 1)
            fluxes = rng.uniform(5000, 50000, nstars)
        for (x, y), f in zip(star_xy, fluxes):
            img[y - r:y + r + 1, x - r:x + r + 1] += (f * psf).astype('f4')
        img += rng.normal(0, 5.0, (H, W)).astype('f4')
        return img, star_xy, fluxes

    scis, refs, sxs, sys_, svs = [], [], [], [], []
    nstars = max(cfg.smax + 64, (H * W) // 20000)
    for _ in range(B):
        ref, xy, fl = frame(1.4, nstars)
        sci, _, _ = frame(2.0, nstars, xy, fl)
        scis.append(sci)
        refs.append(ref)
        order = np.argsort(fl)[::-1][:cfg.smax]
        sx = np.zeros(cfg.smax, 'f4')
        sy = np.zeros(cfg.smax, 'f4')
        sv = np.zeros(cfg.smax, bool)
        sx[:len(order)] = xy[order, 0]
        sy[:len(order)] = xy[order, 1]
        sv[:len(order)] = True
        sxs.append(sx)
        sys_.append(sy)
        svs.append(sv)

    step = cfg.map_step
    ny = (H - 1) // step + 2
    nx = (W - 1) // step + 2
    gu = np.broadcast_to((np.arange(nx, dtype='f4') * step)[None, :],
                         (ny, nx))
    gv = np.broadcast_to((np.arange(ny, dtype='f4') * step)[:, None],
                         (ny, nx))
    basis = KernelBasis(cfg.ksize, seeing_sigma=2.0 / 2.355)

    def rep(a):
        return np.broadcast_to(a, (B,) + a.shape).copy()

    covb = np.asarray([SUPPORT - 1, W - SUPPORT,
                       SUPPORT - 1, H - SUPPORT], 'f4')
    return (
        np.stack(scis), np.zeros((B, H, W), 'i4'), np.stack(refs),
        np.zeros((B, H, W), 'i4'), rep(np.asarray(gu)), rep(np.asarray(gv)),
        np.stack(sxs), np.stack(sys_), np.stack(svs),
        rep(basis.gx), rep(basis.gy), rep(basis.sums), rep(basis.b0_2d),
        rep(covb),
    )


def coadd_inputs(N, H, W, map_step=32, seed=0, nstars=None):
    """Synthetic :class:`CoaddPipeline` inputs, the 8-tuple of
    COADD_INPUT_NAMES in numpy: N epochs of one star field (Gaussian stars
    pasted as 25x25 stamps, sigma 0.85 px, sky 150 + 20 e, noise 5), each
    dithered by up to 1.5 px (its grids the identity plus the dither, in
    the ``max_shift`` bucket), a bad column (bit 2) moving with the epoch,
    a 4x4 block of bit 1 in every epoch, a saturated pixel in epoch 0,
    flux scales 0.28-0.33, and one more epoch padded out (``valid`` 0)."""
    rng = np.random.default_rng(seed)
    nstars = nstars or max(40, (H * W) // 20000)
    r = 12
    sx = rng.uniform(r + 4, W - r - 4, nstars)
    sy = rng.uniform(r + 4, H - r - 4, nstars)
    fl = rng.uniform(3000, 40000, nstars)
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    ny, nx = (H - 1) // map_step + 2, (W - 1) // map_step + 2
    gx = (np.arange(nx, dtype='f4') * map_step)[None, :]
    gy = (np.arange(ny, dtype='f4') * map_step)[:, None]
    imgs = np.zeros((N + 1, H, W), 'f4')
    masks = np.zeros((N + 1, H, W), np.int32)
    gus = np.zeros((N + 1, ny, nx), 'f4')
    gvs = np.zeros((N + 1, ny, nx), 'f4')
    for e in range(N):
        dx, dy = rng.uniform(-1.5, 1.5, 2)
        img = np.full((H, W), 150.0 + 20 * e)
        for x, y, f in zip(sx + dx, sy + dy, fl):
            ix, iy = int(x), int(y)
            img[iy - r:iy + r + 1, ix - r:ix + r + 1] += f / (
                2 * np.pi * 0.85 ** 2) * np.exp(
                -((xx + ix - x) ** 2 + (yy + iy - y) ** 2) / (2 * 0.85 ** 2))
        imgs[e] = img + rng.normal(0, 5.0, (H, W))
        masks[e, :, (100 + e) % W] = 1 << 2
        masks[e, 40:44, 40:44] = 1 << 1
        gus[e] = gx + np.float32(dx)
        gvs[e] = gy + np.float32(dy)
    imgs[0, H // 2, W // 4] = 7e4
    covb = np.asarray([[2, W - 3, 2, H - 3]] * (N + 1), 'f4')
    covb[-1] = 0
    scales = (0.28 + 0.05 * rng.uniform(size=N + 1)).astype('f4')
    scales[-1] = 1.0
    return (imgs, np.asarray([6e4] * N + [3e38], 'f4'), masks, gus, gvs,
            covb, scales, np.asarray([1.0] * N + [0.0], 'f4'))


def _tensor(a, dtype, device):
    if isinstance(a, torch.Tensor):     # already a tensor: move and cast
        return a.to(device=device,
                    dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
    return torch.tensor(np.asarray(a, dtype=dtype), device=device)


def resolve_device(device):
    """``device``, or the CUDA card for None (raising where there is
    none): the port runs on the card unless the caller asks for the
    CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA card; pass device="cpu" to run on '
                               'the CPU')
        return torch.device('cuda')
    return torch.device(device)


def upload(a, device, stats=None):
    """numpy ``a`` as a tensor on ``device``. To a card it goes through
    pinned memory (PyTorch's caching host allocator, which reuses a block
    once the copy recorded on it has passed) with a ``non_blocking`` copy,
    so the host does not wait for the link; on the CPU it is a copy.
    ``stats`` (dict, optional) gains the host seconds (``upload_s``) and
    bytes (``upload_bytes``) sent."""
    t0 = time.perf_counter()
    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    out = (t.pin_memory().to(device, non_blocking=True)
           if device.type == 'cuda' else t.clone())
    if stats is not None:
        stats['upload_s'] = stats.get('upload_s', 0.0) \
            + time.perf_counter() - t0
        stats['upload_bytes'] = stats.get('upload_bytes', 0) + t.nbytes
    return out


def upload_mask(m, shape, device, stats=None):
    """A bitmask as int32 on ``device``: zeros for None; a raw 16-bit IPAC
    mask (uint16) is sent as its int16 bits, half the bytes, and widened
    on the device with ``& 0xFFFF``."""
    if m is None:
        return torch.zeros(shape, dtype=torch.int32, device=device)
    m = np.asarray(m)
    if m.dtype == np.uint16:
        return upload(m.view(np.int16), device, stats).to(torch.int32) \
            & 0xFFFF
    return upload(m.astype(np.int32), device, stats)


def to_torch(args, device=None):
    """Move pipeline state onto ``device`` as the port's tensors.

    ``args`` is the 14-tuple of INPUT_NAMES (numpy or JAX arrays): masks
    become int32, ``stamp_valid`` bool, everything else float32; or the
    8-tuple of COADD_INPUT_NAMES (numpy or JAX arrays, or tensors already
    on a device): ``masks`` int32, everything else float32; or one float
    array (e.g. fitted ``coeffs`` from a JAX ``fit_kernel`` run), which
    becomes float32.

    ``device=None`` means the CUDA card and raises where there is none; a
    caller that wants the CPU says ``'cpu'``.
    """
    device = resolve_device(device)
    if isinstance(args, (tuple, list)):
        if len(args) == len(COADD_INPUT_NAMES):
            return tuple(_tensor(a, np.int32 if i in _COADD_MASK_SLOTS
                                 else np.float32, device)
                         for i, a in enumerate(args))
        if len(args) != len(INPUT_NAMES):
            raise ValueError(f'expected the {len(INPUT_NAMES)} inputs '
                             f'{INPUT_NAMES} or the '
                             f'{len(COADD_INPUT_NAMES)} inputs '
                             f'{COADD_INPUT_NAMES}, got {len(args)}')
        out = []
        for i, a in enumerate(args):
            dtype = (np.int32 if i in _MASK_SLOTS
                     else bool if i in _BOOL_SLOTS else np.float32)
            out.append(_tensor(a, dtype, device))
        return tuple(out)
    return _tensor(args, np.float32, device)


def plant_sources(args, n=3, flux=2e4, sigma=2.0, margin=40, seed=0):
    """Add ``n`` Gaussian point sources of total ``flux`` to the science
    frames of ``args`` (the synth_inputs tuple) at sub-pixel positions
    where the reference frame holds no star: the transients a
    subtraction must find. Returns (new args, positions (B, n, 2) as x, y).
    """
    rng = np.random.default_rng(seed)
    sci, ref = args[0].copy(), args[2]
    B, H, W = sci.shape
    r = 12
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    pos = np.zeros((B, n, 2))
    for b in range(B):
        placed = 0
        while placed < n:
            x = rng.uniform(margin, W - margin)
            y = rng.uniform(margin, H - margin)
            ix, iy = int(round(x)), int(round(y))
            box = ref[b, iy - 15:iy + 16, ix - 15:ix + 16]
            near = np.hypot(*(pos[b, :placed] - (x, y)).T)
            if np.abs(box - 150.0).max() > 30.0 or (near < 30).any():
                continue
            psf = np.exp(-((xx + ix - x) ** 2 + (yy + iy - y) ** 2)
                         / (2 * sigma ** 2)) / (2 * np.pi * sigma ** 2)
            sci[b, iy - r:iy + r + 1, ix - r:ix + r + 1] += \
                (flux * psf).astype('f4')
            pos[b, placed] = x, y
            placed += 1
    return (sci,) + tuple(args[1:]), pos


# write_night_pairs' scene (bench.py:_write_bench_frames): ZTF sampling,
# reference and science seeing in px
NIGHT_STARS = 700
NIGHT_SEEING = (2.0, 2.8)
NIGHT_TRANSIENT_FLUX = 3e4


def write_night_pairs(d, npairs, H, W, header_json, no_seeing=(), seed=7,
                      ref_rot_deg=(), nstars=NIGHT_STARS):
    """FITS pairs of a synthetic night in directory ``d``, the recipe of
    ``bench.py:_write_bench_frames`` (700 stars of flux 5e3-5e4, seeing
    2.0 px on the reference and 2.8 px on the science frames, noise 5,
    uint16 ``mskimg`` siblings, one transient of flux 3e4 per science
    frame), written with the port's FITS writer. The science frames carry
    the real ZTF TPV distortion of ``header_json`` (a JSON of ``wcs`` and
    ``meta`` cards, as ``tests/data/ztf_real_header.json``) with CRPIX
    (W/2 + 0.5, H/2 + 0.5); the reference a linear WCS with CRPIX
    (W/2 + 2.1, H/2 - 1.7), a dither of (+1.6, -2.2) px that the
    pipeline's pre-roll takes out. The frames whose index is in
    ``no_seeing`` have no SEEING card. ``ref_rot_deg[i]``, where given and
    not 0, gives pair ``i`` a reference of its own whose WCS is rotated by
    that angle about the frame's centre (the same sky, rendered on the
    rotated grid): a pair the batched pipeline's ``max_shift`` bucket
    refuses. ``nstars``: the number of stars. Returns (work lines
    "sci ref", transient (x, y) per pair)."""
    from .fits import HDU, Header, write_fits
    from .wcs import TPVWCS
    rng = np.random.default_rng(seed)
    xs, ys, fluxes = _night_star_draws(rng, H, W, nstars)
    k = 12
    yy, xx = np.mgrid[-k:k + 1, -k:k + 1]

    def render(px, py, seeing, extra=None):
        img = np.full((H, W), 150.0, dtype='f4')
        sig = seeing / 2.355
        for x, y, f in list(zip(px, py, fluxes)) + ([extra] if extra
                                                   else []):
            xi, yi = int(round(x)), int(round(y))
            if not (k < xi < W - k - 1 and k < yi < H - k - 1):
                continue
            psf = np.exp(-((xx + xi - x) ** 2 + (yy + yi - y) ** 2)
                         / (2 * sig * sig)) / (2 * np.pi * sig * sig)
            img[yi - k:yi + k + 1, xi - k:xi + k + 1] += (f * psf
                                                          ).astype('f4')
        img += rng.normal(0, 5.0, (H, W)).astype('f4')
        return img

    def write(path, data, wcs, mjd, seeing):
        h = Header()
        wcs.to_header(h)
        for key, v in (('MAGZP', 26.3), ('OBSMJD', mjd), ('FIELDID', 679),
                       ('CCDID', 1), ('QID', 2), ('FILTERID', 2),
                       ('SATURATE', 60000.0)):
            h.set(key, v)
        if seeing is not None:
            h.set('SEEING', seeing)
        h.set('FILENAME', os.path.basename(path))
        write_fits(path, [HDU(h, data)])
        write_fits(path.replace('sciimg', 'mskimg'),
                   [HDU(h.copy(), np.zeros(data.shape, np.uint16))])

    with open(header_json) as f:
        real = json.load(f)
    hh = Header()
    for key, v in {**real['wcs'], **real['meta']}.items():
        hh.set(key, v)
    wcs_sci = TPVWCS.from_header(hh)
    wcs_sci.crval[:] = (150.1, 35.2)
    wcs_sci.crpix[:] = (W / 2 + 0.5, H / 2 + 0.5)
    lin = np.zeros_like(wcs_sci.pv1)
    lin[1] = 1.0
    see_ref, see_sci = NIGHT_SEEING
    ra, dec = wcs_sci.pix2sky_0(xs, ys)

    def write_ref(name, rot_deg):
        c, s_ = np.cos(np.deg2rad(rot_deg)), np.sin(np.deg2rad(rot_deg))
        wcs_ref = TPVWCS(np.asarray([W / 2 + 2.1, H / 2 - 1.7]),
                         wcs_sci.crval.copy(),
                         wcs_sci.cd @ np.array([[c, -s_], [s_, c]]), lin,
                         lin.copy())
        rx, ry = wcs_ref.sky2pix_0(ra, dec)
        path = os.path.join(d, name)
        write(path, render(rx, ry, see_ref), wcs_ref, 58300.0, see_ref)
        return path

    rots = dict(enumerate(ref_rot_deg))
    # the shared reference first, as bench.py draws its noise first
    ref_path = (write_ref('night_ref_sciimg.fits', 0.0)
                if any(not rots.get(i) for i in range(npairs)) else None)
    work, truths = [], []
    for i in range(npairs):
        t = (500.0 + 257 * i, 600.0 + 193 * i, NIGHT_TRANSIENT_FLUX)
        p = os.path.join(d, f'night_n{i}_sciimg.fits')
        write(p, render(xs, ys, see_sci, extra=t), wcs_sci,
              58345.0 + 0.01 * i, None if i in no_seeing else see_sci)
        pair_ref = (write_ref(f'night_ref_rot{i}_sciimg.fits', rots[i])
                    if rots.get(i) else ref_path)
        work.append(f'{p} {pair_ref}')
        truths.append(t[:2])
    return work, truths


def _night_star_draws(rng, H, W, nstars):
    """The stars' x, y (science-frame pixels, 0-based) and fluxes: the
    first draws of :func:`write_night_pairs`' generator."""
    xs = rng.uniform(40, W - 40, nstars)
    ys = rng.uniform(40, H - 40, nstars)
    return xs, ys, rng.uniform(5000, 50000, nstars)


def night_stars(H, W, seed=7, nstars=NIGHT_STARS):
    """(x, y) of the stars :func:`write_night_pairs` renders with the same
    arguments, in the science frames' pixels (0-based)."""
    return _night_star_draws(np.random.default_rng(seed), H, W, nstars)[:2]


# the rows of a forced-photometry run (forced_positions), and how near an
# edge an 'edge' row lies (px)
FORCED_KINDS = ('transient', 'star', 'sky', 'edge', 'off', 'masked')
FORCED_EDGE = 4.0


def forced_positions(wcs, H, W, n, transient, stars, mask=None, seed=0):
    """Sky positions for forced photometry on an (H, W) frame whose TPV
    WCS is ``wcs``: row 0 the transient at pixel ``transient``; up to n / 4
    of the catalogue stars ``stars`` ((x, y) arrays); n / 16 within
    FORCED_EDGE px of an edge and n / 32 5-50 px off the frame (together
    over 9% of the rows); where ``mask`` (H, W) has set pixels at least
    FORCED_EDGE px inside the frame, n / 32 on such pixels; the rest blank
    sky, at least 12 px from every star and the transient. Returns (ra,
    dec, kind): float64 degrees and each row's name in FORCED_KINDS."""
    rng = np.random.default_rng(seed)
    sx, sy = (np.asarray(a, float) for a in stars)
    xs, ys, kind = [float(transient[0])], [float(transient[1])], ['transient']

    def add(x, y, name):
        xs.extend(np.asarray(x, float))
        ys.extend(np.asarray(y, float))
        kind.extend([name] * len(x))

    pick = rng.choice(len(sx), min(n // 4, len(sx)), replace=False)
    add(sx[pick], sy[pick], 'star')
    for name, m, lo, hi in (('edge', n // 16, -0.49, FORCED_EDGE),
                            ('off', n // 32, -50.0, -5.0)):
        # distance inside the nearest edge (negative: outside), a side,
        # and a place along it
        depth = rng.uniform(lo, hi, m)
        side = rng.integers(0, 4, m)
        along = rng.uniform(0, 1, m)
        x = np.where(side == 0, depth, np.where(side == 1, W - 1 - depth,
                                                along * (W - 1)))
        y = np.where(side == 2, depth, np.where(side == 3, H - 1 - depth,
                                                along * (H - 1)))
        add(x, y, name)
    if mask is not None:
        e = int(FORCED_EDGE)
        my, mx = np.nonzero(np.asarray(mask)[e:H - e, e:W - e])
        if len(mx):
            at = rng.choice(len(mx), min(n // 32, len(mx)), replace=False)
            add(mx[at] + e, my[at] + e, 'masked')
    px = np.append(sx, transient[0])
    py = np.append(sy, transient[1])
    while len(xs) < n:
        x = rng.uniform(8, W - 9, 4 * (n - len(xs)))
        y = rng.uniform(8, H - 9, len(x))
        near = np.zeros(len(x), bool)
        for i in range(0, len(px), 256):
            near |= ((np.hypot(x[:, None] - px[None, i:i + 256],
                               y[:, None] - py[None, i:i + 256]) < 12.0)
                     .any(1))
        keep = ~near
        add(x[keep][:n - len(xs)], y[keep][:n - len(xs)], 'sky')
    ra, dec = wcs.pix2sky_0(np.asarray(xs[:n]), np.asarray(ys[:n]))
    return np.asarray(ra, float), np.asarray(dec, float), np.asarray(kind[:n])


# write_coadd_epochs' scene (bench.py:main_coadd)
COADD_STARS = 400
COADD_SEEING = 2.0
COADD_MAGZP = 26.3
COADD_DITHER = 1.5
COADD_CENTER = (150.1, 35.2)
COADD_SCALE = 1.01 / 3600.0


# write_coadd_epochs' header WCS errors (wcs_errors=True): a CRPIX offset
# of up to WCS_ERR_CRPIX_PX (uniform over the disc; the matcher's radius is
# 2 arcsec, ~2 px), a rotation about CRPIX of up to WCS_ERR_ROT_DEG either
# way and, in every second epoch from epoch 1, a degree-3 TPV distortion
# whose largest displacement at the frame's corners is WCS_ERR_DISTORT_PX
WCS_ERR_CRPIX_PX = 1.2
WCS_ERR_ROT_DEG = 0.01
WCS_ERR_DISTORT_PX = 0.3


def _coadd_scene(H, W, seed, nstars):
    """The scene's generator after its star draws, and the stars' (ra,
    dec) and fluxes."""
    from .wcs import TPVWCS
    rng = np.random.default_rng(seed)
    wcs0 = TPVWCS.simple(crval=COADD_CENTER, crpix=(W / 2 + .5, H / 2 + .5),
                         scale_deg=COADD_SCALE)
    xs = rng.uniform(30, W - 30, nstars)
    ys = rng.uniform(30, H - 30, nstars)
    fl = rng.uniform(8000, 60000, nstars)
    ra, dec = wcs0.pix2sky_0(xs, ys)
    return rng, ra, dec, fl


def coadd_stars(H, W, seed=21, nstars=COADD_STARS):
    """The true (ra, dec) of ``write_coadd_epochs``' stars."""
    _, ra, dec, _ = _coadd_scene(H, W, seed, nstars)
    return ra, dec


def write_gaia_cache(d, H, W, seed=21, nstars=COADD_STARS):
    """A Gaia-like astrometric cache of ``write_coadd_epochs``' scene: the
    stars' true (ra, dec) in ``gaia_{int(ra)}_{int(dec)}.npz`` under
    directory ``d``, named by the field's centre as ``scamp._gaia_cache``
    looks it up. Returns its path."""
    ra, dec = coadd_stars(H, W, seed, nstars)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f'gaia_{int(COADD_CENTER[0])}_'
                           f'{int(COADD_CENTER[1])}.npz')
    np.savez(path, ra=ra, dec=dec)
    return path


def _header_wcs(true, i, H, W, rng):
    """Epoch ``i``'s header WCS: ``true`` with the errors of
    ``wcs_errors=True`` drawn from ``rng``."""
    import copy
    from .wcs.tpv import tpv_terms
    r = WCS_ERR_CRPIX_PX * np.sqrt(rng.uniform())
    phi = rng.uniform(0.0, 2.0 * np.pi)
    rot = np.radians(rng.uniform(-WCS_ERR_ROT_DEG, WCS_ERR_ROT_DEG))
    cubic = rng.uniform(-1.0, 1.0, (2, 4))
    w = copy.deepcopy(true)
    w.crpix = true.crpix + r * np.array([np.cos(phi), np.sin(phi)])
    c, s = np.cos(rot), np.sin(rot)
    w.cd = np.array([[c, -s], [s, c]]) @ true.cd
    if i % 2 == 1:
        # the cubic terms (TPV 7-10) scaled to WCS_ERR_DISTORT_PX at the
        # worst of the frame's corners on the tangent plane
        cx = np.array([-1.0, 1.0, 1.0, -1.0]) * W / 2.0 * COADD_SCALE
        cy = np.array([-1.0, -1.0, 1.0, 1.0]) * H / 2.0 * COADD_SCALE
        d1 = tpv_terms(cx, cy)[:, 7:11] @ cubic[0]
        d2 = tpv_terms(cy, cx)[:, 7:11] @ cubic[1]
        gain = WCS_ERR_DISTORT_PX / (np.hypot(d1, d2).max() / COADD_SCALE)
        w.pv1 = w.pv1.copy()
        w.pv2 = w.pv2.copy()
        w.pv1[7:11] = cubic[0] * gain
        w.pv2[7:11] = cubic[1] * gain
    return w


def write_coadd_epochs(d, nepochs, H, W, seed=21, nstars=COADD_STARS,
                       cosmic=None, seeing=None, maglim=None, infobits=None,
                       wcs_errors=False):
    """FITS epochs of one synthetic quadrant in directory ``d``, the recipe
    of ``bench.py:main_coadd`` (206-258): ``nstars`` stars of flux
    8e3-6e4 at seeing 2.0 px on sky 150 with noise 5, ``MAGZP`` 26.3, one
    linear WCS per epoch whose CRPIX is dithered by up to 1.5 px on each
    axis, uint16 ``mskimg`` siblings, written with the port's FITS writer.
    ``cosmic`` = (epoch, x, y, counts) adds ``counts`` to that pixel of
    that epoch. Optional per-epoch sequences: ``seeing`` (FWHM in px: the
    epoch's stars are drawn at it and its SEEING card says it),
    ``maglim`` and ``infobits`` (MAGLIM and INFOBITS cards).
    ``wcs_errors``: each header carries its WCS off by errors drawn from
    the seed (the ``WCS_ERR_*`` bounds) by a generator of their own; the
    pixels are drawn with the true WCS all the same. Without these options
    the files are the recipe's, byte for byte. Returns (paths, the
    epochs' true WCS objects)."""
    from .fits import HDU, Header, write_fits
    from .wcs import TPVWCS
    rng, ra, dec, fl = _coadd_scene(H, W, seed, nstars)
    rng_err = np.random.default_rng([seed, 1])
    k = 10
    yy, xx = np.mgrid[-k:k + 1, -k:k + 1]
    paths, wcss = [], []
    for i in range(nepochs):
        p = os.path.join(d, f'ep{i}_sciimg.fits')
        wcs_e = TPVWCS.simple(
            crval=COADD_CENTER,
            crpix=(W / 2 + .5 + rng.uniform(-COADD_DITHER, COADD_DITHER),
                   H / 2 + .5 + rng.uniform(-COADD_DITHER, COADD_DITHER)),
            scale_deg=COADD_SCALE)
        see = COADD_SEEING if seeing is None else seeing[i]
        sig = see / 2.355
        ex, ey = wcs_e.sky2pix_0(ra, dec)
        img = np.full((H, W), 150.0, 'f4')
        for x, y, f in zip(ex, ey, fl):
            xi, yi = int(round(x)), int(round(y))
            if not (k < xi < W - k - 1 and k < yi < H - k - 1):
                continue
            psf = np.exp(-((xx + xi - x) ** 2 + (yy + yi - y) ** 2)
                         / (2 * sig * sig)) / (2 * np.pi * sig * sig)
            img[yi - k:yi + k + 1, xi - k:xi + k + 1] += \
                (f * psf).astype('f4')
        img += rng.normal(0, 5.0, (H, W)).astype('f4')
        if cosmic is not None and cosmic[0] == i:
            img[cosmic[2], cosmic[1]] += np.float32(cosmic[3])
        h = Header()
        (_header_wcs(wcs_e, i, H, W, rng_err) if wcs_errors
         else wcs_e).to_header(h)
        for key, v in (('MAGZP', COADD_MAGZP), ('OBSMJD', 58300.0 + i),
                       ('FIELDID', 679), ('CCDID', 1), ('QID', 2),
                       ('FILTERID', 2), ('SATURATE', 60000.0),
                       ('SEEING', see)):
            h.set(key, v)
        if maglim is not None:
            h.set('MAGLIM', float(maglim[i]))
        if infobits is not None:
            h.set('INFOBITS', int(infobits[i]))
        h.set('FILENAME', os.path.basename(p))
        write_fits(p, [HDU(h, img)])
        write_fits(p.replace('sciimg', 'mskimg'),
                   [HDU(h.copy(), np.zeros(img.shape, np.uint16))])
        paths.append(p)
        wcss.append(wcs_e)
    return paths, wcss


# braai weights whose scores spread: the fresh init scores every unit
# triplet within ~0.005 of 0.498, where a wrong flatten order or layer
# cannot show. Every kernel but Dense_1's times SPREAD_GAIN, Dense_1's
# times SPREAD_LOGIT_GAIN and its bias SPREAD_LOGIT_BIAS spread the seed-0
# init's scores of unit Gaussian triplets over ~0.25-0.7 and of star-like
# ones over ~0.02-0.8; larger gains push the CPU parity of the scores
# (sums in another order than XLA:CPU's) past 1e-6.
SPREAD_GAIN = 2.0
SPREAD_LOGIT_GAIN = 6.0
SPREAD_LOGIT_BIAS = 0.76


def spread_braai(params):
    """A copy of the braai parameter tree ``params`` (the port's or flax's
    form) with the gains above applied."""
    from .models.braai import params_from_flax
    out = params_from_flax(params)
    for name, layer in out['params'].items():
        last = name == 'Dense_1'
        layer['kernel'] = layer['kernel'] * (SPREAD_LOGIT_GAIN if last
                                             else SPREAD_GAIN)
        if last:
            layer['bias'] = torch.full_like(layer['bias'], SPREAD_LOGIT_BIAS)
    return out


def labelled_triplets(n, seed=0):
    """A learnable braai training set from ``seed``: (triplets (n, 63, 63,
    3) f32 NHWC new/ref/sub, labels (n,) f32). Even rows are real (1): a
    Gaussian source (sigma 1.2-2.5 px, peak 15-60 times the unit noise,
    within 2 px of the centre) in new and sub, none in ref. Odd rows are
    bogus (0), in turn: noise alone; a one-pixel hot spot (15-60) in new
    and sub; a dipole, a source in new and ref 1-3 px apart and their
    difference in sub. Each window is divided by its L2 norm (at least
    1e-10), as ``filterobjects.make_triplets_batch`` does."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:63, :63] - 31.0
    t = rng.normal(size=(n, 63, 63, 3))
    labels = np.zeros(n, np.float32)

    def source(dx, dy, sigma, amp):
        return amp * np.exp(-((xx - dx) ** 2 + (yy - dy) ** 2)
                            / (2 * sigma ** 2))

    for i in range(n):
        sigma, amp = rng.uniform(1.2, 2.5), rng.uniform(15.0, 60.0)
        dx, dy = rng.uniform(-2.0, 2.0, 2)
        if i % 2 == 0:
            s = source(dx, dy, sigma, amp)
            t[i, :, :, 0] += s
            t[i, :, :, 2] += s
            labels[i] = 1.0
        elif i // 2 % 3 == 1:
            y, x = 31 + int(round(dy)), 31 + int(round(dx))
            t[i, y, x, 0] += amp
            t[i, y, x, 2] += amp
        elif i // 2 % 3 == 2:
            ang = rng.uniform(0.0, 2 * np.pi)
            sep = rng.uniform(1.0, 3.0)
            ox, oy = 0.5 * sep * np.cos(ang), 0.5 * sep * np.sin(ang)
            new = source(dx + ox, dy + oy, sigma, amp)
            ref = source(dx - ox, dy - oy, sigma, amp)
            t[i, :, :, 0] += new
            t[i, :, :, 1] += ref
            t[i, :, :, 2] += new - ref
    norm = np.sqrt((t * t).sum((1, 2), keepdims=True))
    return (t / np.maximum(norm, 1e-10)).astype(np.float32), labels
