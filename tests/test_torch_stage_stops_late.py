"""The pipeline's late stage stops, ``dbg_stop_after`` at 'detect', 'phot',
'refine' and 'aps', against the JAX package on the CPU, at the 256^2
``deblend=True`` configuration of tests/test_torch_stage_stops.py.

Each returns {'diff': diff + s} with s a scalar of the frame's detections:
its count, the sum of the r = 3 px aperture fluxes, of the AUTO fluxes,
of the r = 6 px rms and bad-pixel sums plus the rms median. With the
exact tree the detection list itself is chaotic under ulp-level changes:
the reference's own ``det_n`` moves by up to 24 a frame under 1e-7
perturbations of ``sci`` (tests/test_torch_pipeline.py), and a sum over
the rows moves with it by whole sources. So the port is held to the
reference through the definition of s and the default path's gates:

* keys, shapes and dtypes equal the reference's;
* the port's output is bit-equal to diff + s formed from its own full
  run (a stop truncates, never reroutes);
* the reference's output lies within rounding of diff + s formed from
  its own full run: 4 ulps of the value plus the order of s's sum
  (n eps sum |v| for n rows);
* 'detect''s count within 1 plus twice the reference's own spread of
  ``det_n`` over three perturbations, the default path's gate (the diff
  itself is held by tests/test_torch_pipeline.py's spread rule).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu.parallel import pipeline as jp
from zuds_tpu_torch import inputs
from zuds_tpu_torch.parallel import pipeline as tp

torch.set_num_threads(2)

KW = dict(height=256, width=256, ksize=9, stamp=25, smax=32, order=2,
          nreg=2, max_det=128, box=64, deblend=True)
LATE = ('detect', 'phot', 'refine', 'aps')
EPS = float(np.finfo(np.float32).eps)


def _jfn(**change):
    return jp.make_subtract_detect_pipeline(jp.PipelineConfig(**{**KW,
                                                                 **change}))


def _np(out):
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope='module')
def runs():
    args, _ = inputs.plant_sources(
        inputs.synth_inputs(2, 256, 256, tp.PipelineConfig(**KW), seed=0),
        n=3, flux=2e4, seed=1)
    targs = inputs.to_torch(args, 'cpu')
    ja = [jnp.asarray(a) for a in args]
    full_fn = _jfn()
    jfull = _np(full_fn(*ja))
    pert = [_np(full_fn(jnp.asarray((args[0] * np.float32(1 + e))
                                    .astype('f4')), *ja[1:]))
            for e in (1e-7, -1e-7, 2e-7)]
    tfull = {k: v.numpy() for k, v in
             tp.SubtractDetectPipeline(tp.PipelineConfig(**KW))(*targs)
             .items()}
    stops = {}
    for stop in LATE:
        t = tp.SubtractDetectPipeline(tp.PipelineConfig(
            **{**KW, 'dbg_stop_after': stop}))(*targs)
        stops[stop] = ({k: v.numpy() for k, v in t.items()},
                       _np(_jfn(dbg_stop_after=stop)(*ja)))
    return jfull, pert, tfull, stops


def _terms(stop):
    """The summed fields of s, in the reference's order of addition."""
    return {'detect': [], 'phot': ['ap_flux'], 'refine': ['det_flux_auto'],
            'aps': ['det_rms_ap', 'det_bpm_ap']}[stop]


def _port_value(full, stop):
    """diff + s from the port's full run, as the port's stop forms it."""
    d = torch.as_tensor(full['diff'])
    out = []
    for b in range(d.shape[0]):
        v = d[b]
        if stop == 'detect':
            v = v + torch.as_tensor(full['det_n'][b]).to(torch.float32)
        for k in _terms(stop):
            v = v + torch.as_tensor(full[k][b]).sum()
        if stop == 'aps':
            v = v + torch.as_tensor(full['rms_med'][b])
        out.append(v)
    return torch.stack(out).numpy()


@pytest.mark.parametrize('stop', LATE)
def test_keys_shapes_dtypes(runs, stop):
    t, j = runs[3][stop]
    assert set(t) == set(j) == {'diff'}
    assert t['diff'].shape == j['diff'].shape
    assert t['diff'].dtype == j['diff'].dtype == np.float32


@pytest.mark.parametrize('stop', LATE)
def test_port_stop_is_its_full_run(runs, stop):
    _, _, tfull, stops = runs
    np.testing.assert_array_equal(stops[stop][0]['diff'],
                                  _port_value(tfull, stop))


@pytest.mark.parametrize('stop', LATE)
def test_reference_stop_is_its_full_run(runs, stop):
    """The definition of s checked on the reference itself: its stop
    against diff + s from its own full run, within rounding."""
    jfull, _, _, stops = runs
    j = stops[stop][1]['diff'].astype('f8')
    for b in range(j.shape[0]):
        s = 0.0
        mag = 0.0
        n = 1
        if stop == 'detect':
            s = float(jfull['det_n'][b])
        for k in _terms(stop):
            v = jfull[k][b].astype('f8')
            s += v.sum()
            mag += np.abs(v).sum()
            n = max(n, v.size)
        if stop == 'aps':
            s += float(jfull['rms_med'][b])
        want = jfull['diff'][b].astype('f8') + s
        tol = 4 * EPS * np.abs(want) + n * EPS * mag + 4 * EPS * abs(s)
        assert (np.abs(j[b] - want) <= tol).all(), (stop, b)


def test_detect_count_within_the_default_gate(runs):
    jfull, pert, tfull, _ = runs
    spread = np.abs(np.stack([p['det_n'] for p in pert])
                    - jfull['det_n']).max(0)
    for b in range(2):
        assert abs(int(tfull['det_n'][b]) - int(jfull['det_n'][b])) \
            <= 1 + 2 * int(spread[b])
