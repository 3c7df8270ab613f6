"""PyTorch port vs the JAX reference: detection with the deblend modes
``True`` (the exact 32-level tree) and ``'watershed'``, with the
segmentation map, on the CPU; the tree's level labels (H5's plain
version), the compaction (H6's plain version), the port's constants and
its independence from the JAX package.

Scenes: the pair, the faint bump, the triple and the wing spike of
``tests/test_detect.py``, a plateau scene full of ties, a 256^2 busy blend
field and an overflow field of blended pairs with a small ``deb_cap``.

Tolerances: n, valid, npix, the bounding boxes, flags (bit 64 included),
imaflags, the three overflow counters and the segmentation map bit-equal;
x, y atol 1e-4 px; flux, peak, a, b and thresh rtol 1e-5. The level
thresholds' power is the one place the port's arithmetic differs from
XLA:CPU's (float64 rounded once against XLA's f32 power, one ulp apart in
~0.06% of cases): ``test_level_thresholds`` shows that a pixel's levels
can differ only where its filtered value lies within one ulp of a level.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu import constants as jconst
from zuds_tpu.ops import detect as jd
from zuds_tpu_torch import constants as tconst
from zuds_tpu_torch.ops import deblend as tdb
from zuds_tpu_torch.ops import detect as td
from zuds_tpu_torch.ops.ordered import cumsum_last

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(max_det=64)                       # the 128^2 scenes
BUSY = dict(nsigma=5.0, max_det=256)
OVERFLOW = dict(max_det=512, deb_cap=2048, clean=False)


def _gauss(img, x0, y0, flux, var):
    H, W = img.shape
    yy, xx = np.mgrid[0:H, 0:W]
    img += (flux / (2 * np.pi * var) * np.exp(
        -((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * var))).astype('f4')


def _plain(img, rms=1.0):
    H, W = img.shape
    return (img, np.full((H, W), rms, 'f4'), np.zeros((H, W), 'i4'),
            np.ones((H, W), bool))


def scene_pair():
    img = np.random.default_rng(1).normal(0, 1.0, (128, 128)).astype('f4')
    for x0, y0, f in [(60.0, 64.0, 30000.0), (66.0, 64.0, 22000.0)]:
        _gauss(img, x0, y0, f, 4.0)
    return _plain(img)


def scene_faint_bump():
    img = np.random.default_rng(2).normal(0, 1.0, (128, 128)).astype('f4')
    _gauss(img, 64, 64, 50000.0, 4.0)
    _gauss(img, 70, 64, 50.0, 2.0)
    return _plain(img)


def scene_triple():
    img = np.random.default_rng(3).normal(0, 1.0, (128, 128)).astype('f4')
    for x0, y0, f in [(50.0, 64.0, 40000.0), (58.0, 60.0, 25000.0),
                      (64.0, 68.0, 15000.0)]:
        _gauss(img, x0, y0, f, 4.0)
    return _plain(img)


def scene_wing_spike():
    img = np.random.default_rng(4).normal(0, 0.3, (128, 128)).astype('f4')
    _gauss(img, 64, 64, 400000.0, 36.0)
    bump = 3.0 * 2 * np.pi * 2.25
    _gauss(img, 94, 64, bump, 2.25)
    _gauss(img, 20, 110, bump, 2.25)
    return _plain(img)


def scene_ties():
    """Flat plateaus, a symmetric pair on the pixel grid and masked strips
    through sources: many pixels with equal brightest neighbours, so the
    ascent's tie rule (first maximum in adjacency order) decides cells."""
    img = np.zeros((128, 128), 'f4')
    img[20:40, 20:40] = 30.0
    img[20:40, 44:64] = 30.0
    img[28:32, 40:44] = 10.0
    img[70:100, 60:90] = 20.0
    img[80:90, 70:80] = 25.0
    img[40:60, 90:120] = 12.0
    img[45:55, 95:105] = 12.0 + 6.0 * (np.arange(10) % 2)[None, :]
    _gauss(img, 60, 110, 20000.0, 4.0)
    _gauss(img, 68, 110, 20000.0, 4.0)
    img = np.round(img)                          # integer plateaus
    diff, rms, mask, wok = _plain(img.astype('f4'))
    wok[84:86, 55:95] = False
    wok[25:35, 30] = False
    mask[20:40, 20:30] = 1 << 8
    return diff, rms, mask, wok


def scene_busy(H=256, nstar=120):
    """The recipe of tests/test_detect.py's busy blend field at 256^2."""
    rng = np.random.default_rng(5)
    img = np.zeros((H, H), 'f4')
    yy, xx = np.mgrid[-8:9, -8:9]
    for _ in range(nstar):
        x, y = rng.uniform(20, H - 20, 2)
        f = rng.uniform(2000, 30000)
        sig = rng.uniform(1.5, 2.5)
        stars = [(x, y, f)]
        if rng.random() < 0.5:
            stars.append((x + rng.uniform(-6, 6), y + rng.uniform(-6, 6),
                          f * rng.uniform(0.3, 1.0)))
        for sx, sy, sf in stars:
            xi, yi = int(round(sx)), int(round(sy))
            if not (8 < xi < H - 9 and 8 < yi < H - 9):
                continue
            psf = np.exp(-((xx + xi - sx) ** 2 + (yy + yi - sy) ** 2)
                         / (2 * sig * sig)) / (2 * np.pi * sig * sig)
            img[yi - 8:yi + 9, xi - 8:xi + 9] += (sf * psf).astype('f4')
    img += rng.normal(0, 5.0, (H, H)).astype('f4')
    return _plain(img, 5.0)


def scene_overflow(H=256):
    """Blended pairs on a grid (tests/test_detect.py's overflow scene at
    256^2) below a noisy plateau of many small cells: with a small deb_cap
    the tree's pixels and its cross-cell edges both overflow."""
    img = np.zeros((H, H), 'f4')
    yy, xx = np.mgrid[-3:4, -3:4]
    bump = 50.0 * np.exp(-(xx ** 2 + yy ** 2) / 4.0).astype('f4')
    for y in range(56, H - 8, 12):
        for x in range(8, H - 16, 16):
            img[y - 3:y + 4, x - 3:x + 4] += bump
            img[y - 3:y + 4, x + 2:x + 9] += bump
    img[8:30, 20:80] += (40.0 + np.random.default_rng(6).normal(
        0, 8.0, (22, 60))).astype('f4')
    return _plain(img)


SCENES = {'pair': (scene_pair, SMALL), 'faint_bump': (scene_faint_bump, SMALL),
          'triple': (scene_triple, SMALL),
          'wing_spike': (scene_wing_spike, SMALL),
          'ties': (scene_ties, SMALL), 'busy': (scene_busy, BUSY),
          'overflow': (scene_overflow, OVERFLOW)}
CASES = [(s, m) for s in SCENES if s != 'overflow'
         for m in (True, 'watershed')] + [('overflow', True)]


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope='module')
def runs():
    """Both versions of every case, computed once per module."""
    cache = {}

    def get(name, mode):
        if (name, mode) not in cache:
            make, kw = SCENES[name]
            diff, rms, mask, wok = make()
            j = jd.detect_sources(jnp.asarray(diff), jnp.asarray(rms),
                                  jnp.asarray(mask).astype(jnp.uint32),
                                  jnp.asarray(wok), deblend=mode, **kw)
            t = td.detect_sources(T(diff), T(rms), T(mask), T(wok),
                                  deblend=mode, **kw)
            cache[name, mode] = ({k: np.asarray(v) for k, v in j.items()},
                                 {k: v.numpy() for k, v in t.items()})
        return cache[name, mode]
    return get


EXACT = ('n', 'valid', 'npix', 'xmin', 'xmax', 'ymin', 'ymax', 'imaflags',
         'flags', 'pix_overflow', 'deblend_overflow', 'obj_overflow',
         'labels')
RELATIVE = ('flux', 'peak', 'a', 'b', 'thresh')


@pytest.mark.parametrize('name,mode', CASES)
def test_detect_sources_matches(runs, name, mode):
    j, t = runs(name, mode)
    assert int(j['n']) >= 1
    for k in EXACT:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    v = j['valid']
    for k in ('x', 'y'):
        np.testing.assert_allclose(t[k][v], j[k][v], rtol=0, atol=1e-4,
                                   err_msg=k)
    for k in RELATIVE:
        np.testing.assert_allclose(t[k][v], j[k][v], rtol=1e-5, err_msg=k)


def test_scenes_exercise_the_tree(runs):
    """The scenes do what they are for: the tree splits the pair and the
    triple and not the faint bump; the busy field loads it without
    overflow; the overflow field trips the tree's pixel cap, its edge cap
    and bit 64 on some objects but not all."""
    def n_near(name, pts):
        j, _ = runs(name, True)
        x, y = j['x'][j['valid']], j['y'][j['valid']]
        return [int((np.hypot(x - px, y - py) < 2.0).sum())
                for px, py in pts]
    assert n_near('pair', [(60, 64), (66, 64)]) == [1, 1]
    assert n_near('triple', [(50, 64), (58, 60), (64, 68)]) == [1, 1, 1]
    j, _ = runs('faint_bump', True)
    x = j['x'][j['valid']]
    assert ((x > 55) & (x < 80)).sum() == 1
    busy = T(scene_busy()[0])
    load = td.deblend_load(busy, torch.full_like(busy, 5.0), **BUSY)
    assert int(load['cells']) > 50 and int(load['edges']) > 1000
    assert int(load['deblend_overflow']) == 0
    ovf = T(scene_overflow()[0])
    load = td.deblend_load(ovf, torch.ones_like(ovf), max_det=512,
                           deb_cap=OVERFLOW['deb_cap'])
    cap2 = OVERFLOW['deb_cap']
    assert int(load['multi_pixels']) > cap2 and int(load['edges']) > cap2
    j, _ = runs('overflow', True)
    assert int(j['deblend_overflow']) == int(load['deblend_overflow'])
    bit64 = j['flags'][j['valid']] & 64
    assert bit64.any() and not bit64.all()


def _tree_inputs(name):
    make, kw = SCENES[name]
    diff, rms, mask, wok = (T(a) for a in make())
    nsigma = kw.get('nsigma', 1.5)
    st = td._extract(diff, rms, wok, nsigma, 5, kw['max_det'], None)
    cells = td.ascent_cells(st['filt'], st['img'], st['pidx'], st['pok'],
                            st['okb'], st['nbr_pos'])
    return td._tree_input(st, nsigma * rms, *cells, kw.get('deb_cap'))


def test_level_thresholds():
    """The port's levels (power in float64, rounded once) against XLA:CPU's
    f32 power on the busy field's tree pixels: the thresholds may differ
    by one ulp, and a pixel's activity differs only where its filtered
    value lies within one ulp of the level; there are no such pixels."""
    args = _tree_inputs('busy')['args']
    g = tdb.cell_graph(*args[:5], args[6], *args[7:])
    fracs = np.arange(1, 32, dtype='f4') / 32
    tl_j = np.asarray(jax.jit(lambda t0, r: t0[None] * r[None]
                              ** jnp.asarray(fracs)[:, None])(
        g['t0_c'].numpy(), g['ratio'].numpy()))
    tl_t = g['t_l'].numpy()
    assert (np.abs(tl_t.astype('f8') - tl_j) <= np.spacing(tl_j)).all()
    pok, filt = args[1].numpy(), args[4].numpy()
    act_j = pok[None] & (filt[None] >= tl_j)
    near = pok[None] & (np.abs(filt[None] - tl_j) <= np.spacing(tl_j))
    assert not (act_j != g['active'].numpy())[~near].any()
    assert near.sum() == 0
    assert pok.sum() > 5000 and g['active'].numpy().any(axis=1).all()


def test_round_cap_doubled_changes_nothing(monkeypatch):
    """The reference's round cap (6, ZUDS_DEB_ROUNDS) is already the
    fixpoint on the busy field: twice the rounds give the same objects
    and segmentation."""
    diff, rms, mask, wok = (T(a) for a in scene_busy())
    a = td.detect_sources(diff, rms, mask, wok, **BUSY)
    monkeypatch.setattr(tdb, '_DEB_ROUNDS', 2 * tdb._DEB_ROUNDS)
    b = td.detect_sources(diff, rms, mask, wok, **BUSY)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert int(a['n']) > 100


def _labels_reference(e_src, e_dst, e_w, ccap, L, rounds):
    """detect.py:469-517 in numpy: edges sorted by source, a segmented min
    per source, three synchronous jumps, and rounds while any level
    changed, at most ``rounds`` counting the first."""
    order = np.argsort(e_src, kind='stable')
    src, dst, w = e_src[order], e_dst[order], e_w[order]
    starts = np.flatnonzero(np.r_[True, src[1:] != src[:-1]])
    lev = np.arange(L)[:, None]

    def one(lab):
        val = np.where(lev < w[None], lab[:, dst], ccap)
        m = np.full((L, ccap), ccap)
        m[:, src[starts]] = np.minimum.reduceat(val, starts, axis=1)
        lab = np.minimum(lab, m)
        for _ in range(3):
            lab = np.minimum(lab, np.take_along_axis(lab, lab, 1))
        return lab

    lab = one(np.tile(np.arange(ccap), (L, 1)))
    changed, i = True, 1
    while changed and i < rounds:
        new = one(lab)
        changed, lab, i = (new != lab).any(), new, i + 1
    return lab


def _graph(seed, ccap, ecap, L, nchain, chain_len):
    """Random edges, and chains whose cells run down from near ccap with
    the smallest cell at one end: label 0 crawls one cell per round, so
    the round cap decides the result."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, ccap, ecap)
    dst = rng.integers(0, ccap, ecap)
    w = rng.integers(0, L + 1, ecap)
    k = 0
    for c in range(nchain):
        cells = np.r_[c, ccap - 1 - c * chain_len - np.arange(chain_len)]
        for a, b in zip(cells[:-1], cells[1:]):
            src[k:k + 2], dst[k:k + 2], w[k:k + 2] = (a, b), (b, a), L
            k += 2
    return src.astype('i4'), dst.astype('i4'), w.astype('i4')


@pytest.mark.parametrize('rounds', [1, 2, 6, 12])
def test_level_labels_plain_matches_the_reference(rounds):
    ccap, L = 400, 31
    src, dst, w = _graph(0, ccap, 600, L, 3, 40)
    got = tdb.level_labels_plain(T(src), T(dst), T(w), ccap, L, rounds)
    assert got.dtype == torch.int32
    want = _labels_reference(src, dst, w, ccap, L, rounds)
    np.testing.assert_array_equal(got.numpy(), want)
    if rounds == 12:     # the chains are not done: the cap decides
        assert not np.array_equal(
            want, _labels_reference(src, dst, w, ccap, L, 60))


@pytest.mark.parametrize('n,size,p', [(7, 4, 0.5), (5000, 100, 0.1),
                                      (5000, 2000, 0.1), (3000, 64, 0.0),
                                      (3000, 64, 1.0)])
def test_compact_indices_with_count(n, size, p):
    m = np.random.default_rng(n).random(n) < p
    idx, cnt = td.compact_indices(T(m), size, n - 1)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jd.compact_indices(jnp.asarray(m), size,
                                                   n - 1)))
    assert int(cnt) == m.sum()


def test_cumsum_last_is_xla_order():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((500, 33))
         * np.exp(rng.uniform(-10, 10, (500, 33)))).astype('f4')
    want = np.asarray(jax.jit(
        lambda a: jnp.cumsum(a[:, ::-1], axis=1)[:, ::-1])(x))
    got = cumsum_last(T(x).flip(1)).flip(1).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(torch.cumsum(T(x).flip(1), 1).flip(1).numpy(),
                              want)


def test_constants_equal_the_reference():
    names = [n for n in dir(tconst) if n.isupper()]
    assert {'DEBLEND_NTHRESH', 'DEBLEND_MINCONT', 'BAD_SUM', 'MJD_TO_JD',
            'MATCH_RADIUS_DEG', 'RB_ASSOC_MIN'} <= set(names)
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(tconst, n)),
                                      np.asarray(getattr(jconst, n)),
                                      err_msg=n)


def test_port_runs_from_a_copy_alone(tmp_path):
    """A copy of zuds_tpu_torch/ with nothing of the repo beside it, JAX
    and yaml blocked: every module imports, it detects with the exact tree,
    runs the slice, writes, reads and maps a FITS pair, stacks two small
    epochs and subtracts one from the other by the per-pair path, seeds
    its config from its own copy and records the subtraction in a sqlite
    file, from which ``from_file`` takes its id; ``queryref`` lists the
    two epochs recorded there."""
    shutil.copytree(ROOT / 'zuds_tpu_torch', tmp_path / 'zuds_tpu_torch',
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    modules = sorted(
        '.'.join(p.relative_to(ROOT).with_suffix('').parts)
        for p in (ROOT / 'zuds_tpu_torch').rglob('*.py')
        if p.name != '__init__.py' and p.name != '__main__.py')
    assert {'zuds_tpu_torch.night', 'zuds_tpu_torch.catalog',
            'zuds_tpu_torch.fits.io', 'zuds_tpu_torch.wcs.tpv',
            'zuds_tpu_torch.coadd', 'zuds_tpu_torch.stack',
            'zuds_tpu_torch.utils', 'zuds_tpu_torch.ops.coadd',
            'zuds_tpu_torch.profile', 'zuds_tpu_torch.align',
            'zuds_tpu_torch.swarp', 'zuds_tpu_torch.hotpants',
            'zuds_tpu_torch.sub', 'zuds_tpu_torch.subtraction',
            'zuds_tpu_torch.ops.resample',
            'zuds_tpu_torch.ops.subtract', 'zuds_tpu_torch.secrets',
            'zuds_tpu_torch.db.orm', 'zuds_tpu_torch.core',
            'zuds_tpu_torch.model_util', 'zuds_tpu_torch.spatial',
            'zuds_tpu_torch.detections', 'zuds_tpu_torch.thumbnails',
            'zuds_tpu_torch.source', 'zuds_tpu_torch.archive',
            'zuds_tpu_torch.external', 'zuds_tpu_torch.bookkeeping',
            'zuds_tpu_torch.joins', 'zuds_tpu_torch.json_util',
            'zuds_tpu_torch.status', 'zuds_tpu_torch.env',
            'zuds_tpu_torch.phot', 'zuds_tpu_torch.commit',
            'zuds_tpu_torch.scamp', 'zuds_tpu_torch.makeref',
            'zuds_tpu_torch.parallel.mesh', 'zuds_tpu_torch.parallel.legs',
            'zuds_tpu_torch.tracing', 'zuds_tpu_torch.sextractor',
            'zuds_tpu_torch.plotting', 'zuds_tpu_torch.download',
            'zuds_tpu_torch.thumb', 'zuds_tpu_torch.demo',
            'zuds_tpu_torch.control.archive_daemon',
            'zuds_tpu_torch.queryref', 'zuds_tpu_torch.querystack',
            'zuds_tpu_torch.nightly', 'zuds_tpu_torch.stamp',
            'zuds_tpu_torch.loadphot', 'zuds_tpu_torch.load_catalogs',
            'zuds_tpu_torch.update', 'zuds_tpu_torch.alert',
            'zuds_tpu_torch.alert_fields', 'zuds_tpu_torch.avro',
            'zuds_tpu_torch.send', 'zuds_tpu_torch.crossmatch',
            'zuds_tpu_torch.makealert', 'zuds_tpu_torch.doalert',
            'zuds_tpu_torch.worker', 'zuds_tpu_torch.control.controller',
            'zuds_tpu_torch.control.makesources',
            'zuds_tpu_torch.control.phot_controller'} <= set(modules)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['yaml'] = None\n"
        "import numpy as np\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from zuds_tpu_torch import inputs\n"
        "from zuds_tpu_torch.fits import HDU, Header, write_fits\n"
        "from zuds_tpu_torch.night import _read_image\n"
        "from zuds_tpu_torch.parallel import PipelineConfig, "
        "SubtractDetectPipeline\n"
        "from zuds_tpu_torch.wcs import TPVWCS, pixel_mapping\n"
        "cfg = PipelineConfig(height=128, width=128, ksize=9, stamp=25, "
        "smax=16, order=1, nreg=1, max_det=32, box=64)\n"
        "out = SubtractDetectPipeline(cfg)(*inputs.to_torch("
        "inputs.synth_inputs(1, 128, 128, cfg), 'cpu'))\n"
        "assert out['diff'].shape == (1, 128, 128)\n"
        "w = TPVWCS.simple((150.0, 35.0), (64.0, 64.0), 1e-4)\n"
        "h = w.to_header(Header())\n"
        "write_fits('f.fits', [HDU(h, np.ones((8, 8), np.uint16))])\n"
        "hdu = _read_image('f.fits')\n"
        "assert hdu.data.dtype == np.uint16 and hdu.data.sum() == 64\n"
        "g = pixel_mapping(TPVWCS.from_header(hdu.header), w, (64, 64))\n"
        "assert abs(float(g.u[0, 0])) < 1e-3\n"
        "from zuds_tpu_torch.coadd import ScienceCoadd\n"
        "from zuds_tpu_torch.image import ScienceImage\n"
        "paths, _ = inputs.write_coadd_epochs('.', 2, 128, 128, nstars=5)\n"
        "c = ScienceCoadd.from_images([ScienceImage.from_file(p) for p in "
        "paths], 'stack.fits', calculate_seeing=False, device='cpu')\n"
        "assert c.header['NCOADD'] == 2 and c.data.shape[0] >= 128\n"
        "from zuds_tpu_torch.coadd import ReferenceImage\n"
        "from zuds_tpu_torch.subtraction import SingleEpochSubtraction\n"
        "sci = ScienceImage.from_file(paths[0])\n"
        "ref = ReferenceImage.from_file(paths[1])\n"
        "sub = SingleEpochSubtraction.from_images(sci, ref, device='cpu')\n"
        "assert sub.data.shape == (128, 128)\n"
        "assert sub.header['SUBMETH'] == 'hotpants'\n"
        "import os\n"
        "os.environ['ZUDS_CONFIG'] = os.path.abspath('config')\n"
        "from zuds_tpu_torch import core, model_util, secrets\n"
        "assert secrets.get_secret('db_backend') == 'sqlite'\n"
        "assert oct(os.stat('config').st_mode & 0o777) == '0o600'\n"
        "model_util.init_db(database='z.db')\n"
        "model_util.create_tables()\n"
        "s = core.DBSession()\n"
        "s.add(core.record_from_image(sub, 'sesub'))\n"
        "s.commit()\n"
        "assert ScienceImage.from_file(sub.local_path).id == 1\n"
        "from zuds_tpu_torch import queryref\n"
        "s.add_all([core.record_from_image(ScienceImage.from_file(p), "
        "'sci') for p in paths])\n"
        "s.commit()\n"
        "import contextlib, io\n"
        "with contextlib.redirect_stdout(io.StringIO()) as said:\n"
        "    lines = queryref.main(2)\n"
        "assert said.getvalue() == lines[0] + '\\n'\n"
        "assert [x.split()[1:] for x in lines] == [[os.path.basename(p) "
        "for p in paths]]\n"
        "assert not [m for m in sys.modules if m.startswith('zuds_tpu.')"
        " or m == 'zuds_tpu']\n"
        "print('ok', int(out['det_n'][0]))\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    res = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().startswith('ok')


def test_kernel_wrappers_refuse_cpu_tensors():
    """H5-H11 and the two-plane H1 launch or raise: a CPU tensor is refused,
    never run through the plain version (the dispatchers pick by device)."""
    from zuds_tpu_torch.kernels import launch
    e = torch.zeros(16, dtype=torch.int32)
    img, s = torch.zeros((16, 16)), torch.zeros(())
    with pytest.raises(ValueError, match='CUDA'):
        launch.deblend_labels(e, e, e, 8, 31, 6,
                              torch.zeros((), dtype=torch.int64))
    with pytest.raises(ValueError, match='CUDA'):
        launch.compact(torch.zeros(16, dtype=torch.bool), 4, 0)
    with pytest.raises(ValueError, match='CUDA'):
        launch.stamp_candidates(img, s, s, 1.0, 2)
    with pytest.raises(ValueError, match='CUDA'):
        launch.frame_median(img)
    stack = torch.zeros((2, 16, 16))
    imask = torch.zeros((2, 16, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match='CUDA'):
        launch.clipped_combine(stack, stack, imask, imask > 0, None, 4.0,
                               0.3, 16)
    with pytest.raises(ValueError, match='CUDA'):
        launch.warp(img, imask[0], img, img, torch.zeros(4), 2, ref2=img)
    with pytest.raises(ValueError, match='CUDA'):
        launch.warp_gather(img, imask[0], img, img)
    with pytest.raises(ValueError, match='CUDA'):
        launch.subtract_epilogue(img, img, img, img, img > 0, 1e-30, 1.0)
    with pytest.raises(ValueError, match='CUDA'):
        launch.apply_model_variance(img, torch.zeros((1, 9, 9)), [8.0], [8.0],
                                    8.0, 8.0)
    assert launch.clipped_combine.launches == 0
    assert launch.warp_gather.launches == 0
    assert launch.subtract_epilogue.launches == 0
    assert launch.apply_model_variance.launches == 0
    assert {'clipped_combine', 'warp_gather', 'subtract_epilogue',
            'apply_model_variance'} <= set(launch.WRAPPERS)
