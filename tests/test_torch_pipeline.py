"""The port's slice against the JAX pipeline on the CPU: the reference's
``make_subtract_detect_pipeline`` and ``SubtractDetectPipeline`` run the
same ``synth_inputs`` (B=2, 3 planted point sources) at 256^2 with
``deblend=False`` and, for the detections and counters, with the
reference's default ``deblend=True``; plus the port's inputs, its
configuration and its independence from JAX.

The difference image: the reference fits its kernel from f32 normal
equations whose condition number the ridge caps near 1e5, so its own
``diff`` moves by more than 0.01 rms in places when its input moves by one
ulp. The port is held to that: its distance from the reference at the
median, 90th and 99th percentiles and the maximum of |diff|/rms over
unmasked pixels at most twice the reference's own distance under a 1e-7
relative perturbation of ``sci``, with the median below 0.01. Detections:
``det_n`` within 1 per frame; every row the two runs share (matched
within 1 px) at SNR > 20 and away from reference stars, which includes the
planted sources, agrees in x, y to 0.01 px and in ap_flux to rtol 1e-3
(star residuals move with the fit, as ``diff`` does); ``det_negpix``
equal on all shared rows; ``rms_med`` rtol 1e-4; ``submask`` equal.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__
from zuds_tpu.ops import subtract as js
from zuds_tpu.parallel import pipeline as jp
from zuds_tpu_torch import inputs
from zuds_tpu_torch.parallel import pipeline as tp

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
KW = dict(height=256, width=256, ksize=9, stamp=25, smax=32, order=2,
          nreg=2, max_det=128, box=64, deblend=False)


@pytest.fixture(scope='module')
def runs():
    args, planted = inputs.plant_sources(
        inputs.synth_inputs(2, 256, 256, tp.PipelineConfig(**KW), seed=0),
        n=3, flux=2e4, seed=1)
    jfn = jp.make_subtract_detect_pipeline(jp.PipelineConfig(**KW))
    j = {k: np.asarray(v) for k, v in
         jfn(*(jnp.asarray(a) for a in args)).items()}
    sci_p = (args[0] * np.float32(1 + 1e-7)).astype('f4')
    jpert = {k: np.asarray(v) for k, v in
             jfn(jnp.asarray(sci_p), *(jnp.asarray(a)
                                       for a in args[1:])).items()}
    t = tp.SubtractDetectPipeline(tp.PipelineConfig(**KW))(
        *inputs.to_torch(args, 'cpu'))
    t = {k: v.numpy() for k, v in t.items()}
    return args, planted, j, jpert, t


@pytest.fixture(scope='module')
def runs_deblend(runs):
    """The same inputs through both pipelines with ``deblend=True``, and
    the reference's own ``det_n`` spread under relative perturbations of
    ``sci`` by -1e-7, 1e-7 and 2e-7: the tree splits noise components
    wherever ``diff``'s ulp-level spread (see the module docstring) moves
    a level, so the reference's own count moves by up to 24 objects per
    frame here, where deblend=False moves by at most 1."""
    args, planted = runs[:2]
    kw = {**KW, 'deblend': True}
    jfn = jp.make_subtract_detect_pipeline(jp.PipelineConfig(**kw))
    j = {k: np.asarray(v) for k, v in
         jfn(*(jnp.asarray(a) for a in args)).items()}
    own = [np.asarray(jfn(jnp.asarray((args[0] * np.float32(1 + e))
                                      .astype('f4')),
                          *(jnp.asarray(a) for a in args[1:]))['det_n'])
           for e in (1e-7, -1e-7, 2e-7)]
    t = tp.SubtractDetectPipeline(tp.PipelineConfig(**kw))(
        *inputs.to_torch(args, 'cpu'))
    return (args, planted, j, np.abs(np.stack(own) - j['det_n']).max(0),
            {k: v.numpy() for k, v in t.items()})


BOTH = pytest.mark.parametrize('which', ['runs', 'runs_deblend'])


@BOTH
def test_output_keys_and_shapes(which, request):
    _, _, j, _, t = request.getfixturevalue(which)
    assert set(t) == set(j)
    for k in j:
        assert t[k].shape == j[k].shape, k


def test_submask_equal(runs):
    _, _, j, _, t = runs
    assert (j['submask'] != 0).any()
    np.testing.assert_array_equal(t['submask'], j['submask'])


def test_diff_within_reference_spread(runs):
    _, _, j, jpert, t = runs
    ok = j['submask'] == 0
    q = [50, 90, 99, 100]
    own = np.percentile((np.abs(jpert['diff'] - j['diff']) / j['rms'])[ok],
                        q)
    port = np.percentile((np.abs(t['diff'] - j['diff']) / j['rms'])[ok], q)
    assert port[0] < 0.01
    assert (port <= 2.0 * own).all(), (port, own)
    assert np.isfinite(t['diff'][ok]).all() and np.isfinite(t['rms'][ok]).all()


def _shared_rows(j, t, b):
    vj, vt = j['det_valid'][b], t['det_valid'][b]
    ij, it = np.flatnonzero(vj), np.flatnonzero(vt)
    pairs = []
    for i in ij:
        d = np.hypot(t['det_x'][b][it] - j['det_x'][b][i],
                     t['det_y'][b][it] - j['det_y'][b][i])
        if len(d) and d.min() <= 1.0:
            pairs.append((i, it[d.argmin()]))
    return pairs


def _near_star(ref, x, y):
    """A reference star within the 31x31 box: residuals there carry the
    fit's conditioning (see the module docstring)."""
    ix, iy = int(round(x)), int(round(y))
    box = ref[max(iy - 15, 0):iy + 16, max(ix - 15, 0):ix + 16]
    return np.abs(box - 150.0).max() > 30.0


@BOTH
def test_detections_match(which, request):
    """det_n within 1 with deblend=False; with deblend=True within 1 plus
    twice the reference's own spread (the rule the diff is held to); the
    shared bright rows and the planted sources agree."""
    args, planted, j, spread, t = request.getfixturevalue(which)
    for b in range(2):
        own = 0 if which == 'runs' else 2 * int(spread[b])
        assert abs(int(t['det_n'][b]) - int(j['det_n'][b])) <= 1 + own
        pairs = _shared_rows(j, t, b)
        found = 0
        for i, k in pairs:
            assert t['det_negpix'][b][k] == j['det_negpix'][b][i]
            snr = j['ap_flux'][b][i] / j['ap_fluxerr'][b][i]
            if snr <= 20 or _near_star(args[2][b], j['det_x'][b][i],
                                       j['det_y'][b][i]):
                continue
            assert abs(t['det_x'][b][k] - j['det_x'][b][i]) <= 0.01
            assert abs(t['det_y'][b][k] - j['det_y'][b][i]) <= 0.01
            np.testing.assert_allclose(t['ap_flux'][b][k],
                                       j['ap_flux'][b][i], rtol=1e-3)
            found += any(np.hypot(*(planted[b] - (j['det_x'][b][i],
                                                   j['det_y'][b][i])).T)
                         <= 1.0)
        assert found == 3, f'frame {b}: {found} planted sources shared'


@BOTH
def test_rms_med_and_fit_health(which, request):
    _, _, j, _, t = request.getfixturevalue(which)
    np.testing.assert_allclose(t['rms_med'], j['rms_med'], rtol=1e-4)
    np.testing.assert_array_equal(t['fit_stamps_ok'], j['fit_stamps_ok'])
    for k in ('det_pix_overflow', 'det_deblend_overflow',
              'det_obj_overflow'):
        np.testing.assert_array_equal(t[k], j[k])


def test_detect_stage_on_the_references_diff(runs_deblend):
    """The deblend=True detect stage alone, on the reference pipeline's own
    diff, rms and submask: the port's detections equal the reference's."""
    from zuds_tpu_torch.constants import BAD_SUM
    from zuds_tpu_torch.ops.detect import detect_sources
    _, _, j, _, _ = runs_deblend
    for b in range(2):
        sm = j['submask'][b].astype('i4')
        det = detect_sources(torch.as_tensor(j['diff'][b].copy()),
                             torch.as_tensor(j['rms'][b].copy()),
                             torch.as_tensor(sm),
                             torch.as_tensor((sm & BAD_SUM) == 0),
                             max_det=KW['max_det'], return_labels=False)
        for k in ('n', 'valid', 'npix', 'flags', 'imaflags'):
            np.testing.assert_array_equal(det[k].numpy(), j[f'det_{k}'][b],
                                          err_msg=k)
        v = j['det_valid'][b]
        for k in ('x', 'y'):
            np.testing.assert_allclose(det[k].numpy()[v],
                                       j[f'det_{k}'][b][v], atol=1e-4)


@pytest.mark.parametrize('ksize,seeing', [(9, 2.0 / 2.355), (15, 1.3),
                                          (15, 0.2)])
def test_kernel_basis_bit_equal(ksize, seeing):
    j = js.KernelBasis(ksize, seeing_sigma=seeing)
    t = inputs.KernelBasis(ksize, seeing_sigma=seeing)
    for k in ('gx', 'gy', 'sums', 'b0_2d'):
        a, b = np.asarray(getattr(j, k)), getattr(t, k)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert t.nbasis == j.nbasis and t.meta == j.meta


def test_synth_inputs_byte_identical():
    cfg = jp.PipelineConfig(height=192, width=160, ksize=9, smax=40)
    ref = __graft_entry__._synth_inputs(2, 192, 160, cfg, seed=4)
    got = inputs.synth_inputs(2, 192, 160, cfg, seed=4)
    assert len(got) == len(ref) == len(inputs.INPUT_NAMES)
    for name, a, b in zip(inputs.INPUT_NAMES, ref, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_to_torch_dtypes():
    cfg = tp.PipelineConfig(height=64, width=64, ksize=9, smax=8)
    args = inputs.to_torch(inputs.synth_inputs(1, 64, 64, cfg), 'cpu')
    want = {'sci_mask': torch.int32, 'ref_mask': torch.int32,
            'stamp_valid': torch.bool}
    for name, a in zip(inputs.INPUT_NAMES, args):
        assert a.dtype == want.get(name, torch.float32), name
    coeffs = inputs.to_torch(np.ones((4, 7), np.float64), 'cpu')
    assert coeffs.dtype == torch.float32 and coeffs.shape == (4, 7)
    with pytest.raises(ValueError):
        inputs.to_torch(args[:3], 'cpu')


def test_config_mirrors_the_reference():
    jf = {f.name: f.default for f in dataclasses.fields(jp.PipelineConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tp.PipelineConfig)}
    assert tf == jf


@pytest.mark.parametrize('change', [
    dict(sep_warp=True),
    dict(dbg_stop_after='fit'), dict(dbg_stop_after='warp'),
    dict(det_dbg_stop_after='ccl')])
def test_unsupported_config_raises(change):
    cfg = tp.PipelineConfig(**{**KW, **change})
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tp.SubtractDetectPipeline(cfg)


def test_interleave_is_accepted():
    tp.SubtractDetectPipeline(tp.PipelineConfig(**{**KW, 'interleave': 2}))


def test_port_never_imports_jax():
    for path in (ROOT / 'zuds_tpu_torch').rglob('*.py'):
        text = path.read_text()
        assert 'import jax' not in text and 'from jax' not in text, path


def test_imports_and_runs_without_jax_and_yaml():
    """The card machine has neither JAX nor pyyaml: the port must import
    and run a frame with both blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['yaml'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from zuds_tpu_torch import inputs\n"
        "from zuds_tpu_torch.parallel import PipelineConfig, "
        "SubtractDetectPipeline\n"
        "cfg = PipelineConfig(height=128, width=128, ksize=9, stamp=25, "
        "smax=16, order=1, nreg=1, max_det=32, box=64, deblend=False)\n"
        "out = SubtractDetectPipeline(cfg)(*inputs.to_torch("
        "inputs.synth_inputs(1, 128, 128, cfg), 'cpu'))\n"
        "assert out['diff'].shape == (1, 128, 128)\n"
        "assert 'zuds_tpu' not in sys.modules\n"
        "print('ok')\n")
    env = {**os.environ, 'PYTHONPATH': str(ROOT)}
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith('ok')
