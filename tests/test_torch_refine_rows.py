"""The premise of H23's row dedupe (``kernels/measure.cu``), on the CPU: the
slice hands ``refine_detections`` all ``max_det`` rows of
``detect_sources``, and every row without pixels (``npix == 0``, past the
frame's objects) carries the same six inputs (x, y, a, b, theta, fwhm),
bitwise, as the last row, ``max_det - 1``, so its eleven outputs are the
last row's. The kernel computes such a row once, at the last row's block,
and copies it; a change in ``detect_sources`` that gave empty rows other
inputs would make the copy useless, and one that gave a row with pixels
the empty rows' inputs would still be measured right (its inputs are
equal, so are its outputs), which the second check shows.

The scene is ``tests/test_torch_pipeline.py``'s: ``synth_inputs`` (B=2, 3
planted point sources) at 256^2 through the port's
``SubtractDetectPipeline``; ``detect_sources`` then runs on each frame's
diff at the three deblend modes.
"""
import numpy as np
import pytest
import torch

from zuds_tpu_torch import inputs
from zuds_tpu_torch.constants import BAD_SUM
from zuds_tpu_torch.kernels.launch import REFINE_KEYS
from zuds_tpu_torch.ops import detect as td
from zuds_tpu_torch.ops import measure as ms
from zuds_tpu_torch.parallel import pipeline as tp

torch.set_num_threads(2)

KW = dict(height=256, width=256, ksize=9, stamp=25, smax=32, order=2,
          nreg=2, max_det=128, box=64, deblend=False)
INPUTS = ('x', 'y', 'a', 'b', 'theta', 'fwhm')


@pytest.fixture(scope='module')
def frames():
    args, _ = inputs.plant_sources(
        inputs.synth_inputs(2, 256, 256, tp.PipelineConfig(**KW), seed=0),
        n=3, flux=2e4, seed=1)
    out = tp.SubtractDetectPipeline(tp.PipelineConfig(**KW))(
        *inputs.to_torch(args, 'cpu'))
    return out


def same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def check_rows(rows, meas, max_det, overflow):
    """Every empty row's inputs and outputs bitwise the last row's; a
    frame whose objects fill every row (``overflow`` objects past
    ``max_det``) has none."""
    empty = rows['npix'] == 0
    if not bool(empty.any()):
        assert int(overflow) > 0
        return
    assert bool(empty[max_det - 1])
    for k in INPUTS:
        col = rows[k]
        assert same_bits(col[empty], col[max_det - 1].expand(
            int(empty.sum()))), k
    for k in REFINE_KEYS:
        col = meas[k]
        assert same_bits(col[empty], col[max_det - 1].expand(
            int(empty.sum()))), k
    # a row with pixels has its own inputs
    for k in ('x', 'y'):
        assert not bool((rows[k][~empty] == rows[k][max_det - 1]).all())


@pytest.mark.parametrize('b', [0, 1])
def test_pipeline_rows(frames, b):
    """The slice's own rows: the detections and their refinement as the
    pipeline returns them."""
    rows = {k: frames[f'det_{k}'][b] for k in INPUTS + ('npix',)}
    meas = {k: frames[f'det_{k}'][b] for k in REFINE_KEYS}
    check_rows(rows, meas, KW['max_det'], frames['det_obj_overflow'][b])


@pytest.mark.parametrize('mode', [True, 'watershed', False])
@pytest.mark.parametrize('b', [0, 1])
def test_detect_rows(frames, b, mode):
    """``detect_sources`` on the slice's diff at each deblend mode, then
    ``refine_detections_plain`` on all its rows."""
    diff, rms, submask = (frames[k][b] for k in ('diff', 'rms', 'submask'))
    det = td.detect_sources(diff, rms, submask, (submask & BAD_SUM) == 0,
                            max_det=KW['max_det'], return_labels=False,
                            deblend=mode)
    meas = ms.refine_detections_plain(diff, rms,
                                      *(det[k] for k in INPUTS))
    check_rows(det, meas, KW['max_det'], det['obj_overflow'])
    assert int(det['n']) > 3
    assert np.isfinite(meas['xwin'][det['valid']].numpy()).all()
