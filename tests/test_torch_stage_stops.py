"""The pipeline's stage stops against the JAX package on the CPU, at the
256^2 configuration of tests/test_torch_pipeline.py with the reference's
default ``deblend=True`` (B = 2, ``synth_inputs`` with 3 planted
sources): ``dbg_stop_after`` at 'warp', 'bkg', 'fit', 'fitdiag', 'ksum',
'apply' and 'noise' (the later stops are in
tests/test_torch_stage_stops_late.py), every ``det_dbg_stop_after`` probe,
and the reference's ``KeyError`` for a probe that never fires.

Keys, shapes and dtypes equal the reference's. A stop truncates the frame
and never reroutes it: each stop's output equals what the port's full run
computes at that point, bit for bit, where the full run returns it.

Float outputs against JAX: the warp within the warp row of
docs/PARITY_CONTRACT.md (rtol 3e-5, atol 5e-3 counts); every later field
by the default path's rule for ``diff`` (tests/test_torch_pipeline.py):
the port's distance from the reference at the median, 90th and 99th
percentiles and the maximum at most twice the reference's own distance
under a 1e-7 relative perturbation of ``sci``, plus 4 ulps of the field's
largest value for fields the perturbation leaves still. 'fit' adds
sum(coeffs), whose order of summation the reference's spread covers.
Integer outputs bit-equal.

The detection probes are integer sums of the reference's intermediates.
Upstream of detection the two pipelines' diffs differ at the ulp level
(the fit is ill-conditioned) and a threshold pixel may flip, so the probes
are held bit-equal to JAX's on identical inputs in
tests/test_torch_detect.py; here the pipeline's output is held to the
port's ``detect_sources`` probe on its own frames, wrapped as the
reference wraps it.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zuds_tpu.parallel import pipeline as jp
from zuds_tpu_torch import inputs
from zuds_tpu_torch.constants import BAD_SUM
from zuds_tpu_torch.ops import detect as td
from zuds_tpu_torch.parallel import pipeline as tp

torch.set_num_threads(2)

KW = dict(height=256, width=256, ksize=9, stamp=25, smax=32, order=2,
          nreg=2, max_det=128, box=64, deblend=True)
EARLY = ('warp', 'bkg', 'fit', 'fitdiag', 'ksum', 'apply', 'noise')
Q = [50, 90, 99, 100]


@pytest.fixture(scope='module')
def base():
    args, _ = inputs.plant_sources(
        inputs.synth_inputs(2, 256, 256, tp.PipelineConfig(**KW), seed=0),
        n=3, flux=2e4, seed=1)
    targs = inputs.to_torch(args, 'cpu')
    full = {k: v.numpy() for k, v in
            tp.SubtractDetectPipeline(tp.PipelineConfig(**KW))(*targs).items()}
    return args, targs, full


def _port(targs, **change):
    out = tp.SubtractDetectPipeline(tp.PipelineConfig(**{**KW, **change}))(
        *targs)
    return {k: v.numpy() for k, v in out.items()}


def _jax(args, perturb=False, **change):
    fn = jp.make_subtract_detect_pipeline(jp.PipelineConfig(**{**KW,
                                                              **change}))
    out = {k: np.asarray(v) for k, v in
           fn(*(jnp.asarray(a) for a in args)).items()}
    if not perturb:
        return out
    sci = (args[0] * np.float32(1 + 1e-7)).astype('f4')
    pert = {k: np.asarray(v) for k, v in
            fn(jnp.asarray(sci), *(jnp.asarray(a) for a in args[1:])).items()}
    return out, pert


@pytest.fixture(scope='module')
def early(base):
    args, targs, _ = base
    return {stop: (_port(targs, dbg_stop_after=stop),
                   *_jax(args, perturb=True, dbg_stop_after=stop))
            for stop in EARLY}


@pytest.mark.parametrize('stop', EARLY)
def test_keys_shapes_dtypes(early, stop):
    t, j, _ = early[stop]
    assert set(t) == set(j)
    for k in j:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k


def _within_spread(name, t, j, jp_):
    """The default path's rule: each percentile of |port - JAX| at most
    twice the reference's own under the perturbation, plus 4 ulps of the
    field's largest value."""
    ok = np.isfinite(j)
    np.testing.assert_array_equal(np.isfinite(t), ok, err_msg=name)
    port = np.percentile(np.abs(t.astype('f8') - j)[ok], Q)
    own = np.percentile(np.abs(jp_.astype('f8') - j)[ok], Q)
    floor = 4 * np.finfo(np.float32).eps * np.abs(j[ok]).max()
    print(f'{name}: port {port}, own {own}')
    assert (port <= 2.0 * own + floor).all(), (name, port, own)


@pytest.mark.parametrize('stop', EARLY)
def test_early_stop_matches_the_reference(early, stop):
    t, j, jpert = early[stop]
    for k in j:
        if j[k].dtype.kind in 'biu':
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        elif stop == 'warp':
            np.testing.assert_allclose(t[k], j[k], rtol=3e-5, atol=5e-3)
        else:
            _within_spread(f'{stop} {k}', t[k], j[k], jpert[k])


def test_stops_never_reroute(base, early):
    """Each stop's output where the full run also returns it: the fit's
    diagnostics, the unmasked difference before the no-data fill, the
    difference plus its noise; and 'fit' is 'fitdiag''s frame plus the
    coefficients' sum."""
    _, _, full = base
    fd = early['fitdiag'][0]
    np.testing.assert_array_equal(fd['coeffs'], full['kernel_coeffs'])
    np.testing.assert_array_equal(fd['stamp_ok'].sum(1),
                                  full['fit_stamps_ok'])
    ok = (full['submask'] & BAD_SUM) == 0
    np.testing.assert_array_equal(early['apply'][0]['diff'][ok],
                                  full['diff'][ok])
    np.testing.assert_array_equal(
        early['noise'][0]['diff'],
        (torch.as_tensor(full['diff']) + torch.as_tensor(full['rms']))
        .numpy())
    for b in range(2):
        np.testing.assert_array_equal(
            early['fit'][0]['diff'][b],
            (torch.as_tensor(fd['diff'][b])
             + torch.as_tensor(fd['coeffs'][b]).sum()).numpy())


@pytest.fixture(scope='module')
def probes(base):
    """Each detection probe through the port's pipeline, and the port's
    ``detect_sources`` probe on the port's full run's frames."""
    _, targs, full = base
    out = {}
    for p in td.DETECT_PROBES:
        tv = []
        for b in range(2):
            sm = full['submask'][b]
            tv.append(td.detect_sources(
                *(torch.as_tensor(full[k][b]) for k in ('diff', 'rms')),
                torch.as_tensor(sm), torch.as_tensor((sm & BAD_SUM) == 0),
                max_det=KW['max_det'], return_labels=False, deblend=True,
                dbg_stop_after=p)['dbg'])
        out[p] = (_port(targs, det_dbg_stop_after=p), torch.stack(tv))
    return out


@pytest.mark.parametrize('probe', td.DETECT_PROBES)
def test_detection_probe_wrapped_as_the_reference(base, probes, probe):
    """A probe with a dimension comes back as {'dbg'} stacked over the
    batch, a scalar one added to the frame's diff (pipeline.py:279-282).
    tests/test_torch_detect.py holds each probe bit-equal to JAX's."""
    _, _, full = base
    t, tv = probes[probe]
    if probe == 'deb_edges':
        assert set(t) == {'dbg'} and t['dbg'].shape == (2, 4)
        assert t['dbg'].dtype == np.int32
        np.testing.assert_array_equal(t['dbg'], tv.numpy())
    else:
        assert set(t) == {'diff'} and t['diff'].dtype == np.float32
        want = (torch.as_tensor(full['diff'])
                + tv.to(torch.float32)[:, None, None]).numpy()
        np.testing.assert_array_equal(t['diff'], want)


def test_vector_probe_through_the_reference_pipeline(base, probes):
    """The reference's pipeline returns a probe with a dimension as
    {'dbg': (B, 4) int32}; the port's has its keys, shape and dtype."""
    args, _, _ = base
    j = _jax(args, det_dbg_stop_after='deb_edges')
    t = probes['deb_edges'][0]
    assert set(j) == set(t) == {'dbg'}
    assert j['dbg'].shape == t['dbg'].shape and j['dbg'].dtype == np.int32


@pytest.mark.parametrize('deblend,probe', [(False, 'deb_lab'),
                                           ('watershed', 'deb_edges'),
                                           (True, 'no-such-probe')])
def test_probe_that_never_fires_raises_key_error(base, deblend, probe):
    args, targs, _ = base
    with pytest.raises(KeyError):
        _jax(args, deblend=deblend, det_dbg_stop_after=probe)
    with pytest.raises(KeyError):
        _port(targs, deblend=deblend, det_dbg_stop_after=probe)


def test_unknown_stage_runs_to_the_full_outputs(base):
    _, targs, full = base
    t = _port(targs, dbg_stop_after='no-such-stage')
    assert set(t) == set(full)
    for k in full:
        np.testing.assert_array_equal(t[k], full[k], err_msg=k)


def test_stop_config_mirrors_the_reference():
    jf = {f.name: f.default for f in dataclasses.fields(jp.PipelineConfig)}
    assert jf['dbg_stop_after'] is None and jf['det_dbg_stop_after'] is None
    tp.SubtractDetectPipeline(tp.PipelineConfig(**{**KW, 'sep_warp': True,
                                                   'dbg_stop_after': 'fit'}))
