"""The port's data parallelism (``zuds_tpu_torch/parallel/mesh.py``,
``legs.py``) on the CPU: two gloo ranks, started once for the module
(``spawn``, a file rendezvous), run the three legs, and the results are
held here against the single-process port and the JAX package:

* ``SubtractDetectPipeline(cfg, mesh)`` over 'data' at
  ``tests/test_torch_pipeline.py``'s 256^2 configuration (B=2, three
  planted sources): bit-equal to the single-process port on every output,
  and against the reference's ``make_subtract_detect_pipeline(cfg,
  mesh)`` (a ``shard_map`` over two virtual CPU devices) at
  ``test_torch_pipeline.py``'s tolerances: ``submask`` equal, ``det_n``
  within 1, the |diff|/rms distance at its median under 0.01 and at most
  twice the reference's own spread under a 1e-7 change of ``sci``,
  ``rms_med`` to 1e-4;
* the frames each rank runs are the blocks ``P('data')`` puts on each
  device (the legs place each rank's block alone, ``place_batch``), and
  ``local_batch`` takes the blocks of ``P('data')`` and ``P(('data',
  'space'))`` on meshes of up to 4x2;
* ``CoaddPipeline`` with its rows over 'space' (3 epochs and a padded one
  at 256^2): bit-equal to the single-process port at ``subtract_back``
  True and False;
* braai's ``train_step`` over the mesh (batch 8, 4 a rank) from one flax
  init with flax's masks against the JAX ``train_step``, at
  ``tests/test_torch_braai_train.py``'s step tolerances, and against the
  single-process port's step;
* a stage stop's partial dict (``dbg_stop_after='fitdiag'``, and
  ``det_dbg_stop_after='deb_edges'`` at ``deblend=True``) gathered over
  'data' is bit-equal to the single-process port's;
* a batch that does not divide over 'data' raises ``ValueError``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from zuds_tpu.models import braai as jbraai
from zuds_tpu.parallel import pipeline as jp
from zuds_tpu_torch import inputs
from zuds_tpu_torch.models import adam as tadam
from zuds_tpu_torch.models import braai as tbraai
from zuds_tpu_torch.parallel import legs, mesh as tmesh
from zuds_tpu_torch.parallel import pipeline as tp

torch.set_num_threads(2)

KW = dict(height=256, width=256, ksize=9, stamp=25, smax=32, order=2,
          nreg=2, max_det=128, box=64, deblend=False)
B = 2
COADD = tp.PipelineConfig(height=256, width=256, box=64)
EPOCHS = 3
N = 8
# stage stops whose partial dicts come back through gather_batch: a stop
# of four keys, and a detection probe of a (4,) vector a frame
STOPS = (tp.PipelineConfig(**KW, dbg_stop_after='fitdiag'),
         tp.PipelineConfig(**dict(KW, deblend=True),
                           det_dbg_stop_after='deb_edges'))
LR = 3e-4


def _triplets():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(N, 63, 63, 3)).astype('f4')
    return (t / np.sqrt((t * t).sum((1, 2), keepdims=True)),
            (np.arange(N) % 2).astype('f4'))


def _flax_masks(params, x, key):
    import flax.linen as nn
    _, state = jbraai.BraaiD6().apply(
        params, jnp.asarray(x), train=True, rngs={'dropout': key},
        capture_intermediates=lambda m, _: isinstance(m, nn.Dropout),
        mutable=['intermediates'])
    return {name: np.asarray(v['__call__'][0]) != 0
            for name, v in state['intermediates'].items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def train_inputs():
    _, params = jbraai.init_braai(0)
    params = _np_tree(params)
    t, y = _triplets()
    return params, t, y, _flax_masks(params, t, jax.random.PRNGKey(0))


@pytest.fixture(scope='module')
def ranks(train_inputs):
    params, t, y, masks = train_inputs
    cfg = tp.PipelineConfig(**KW)
    specs = [('subtract', (cfg, B, 0, 'cpu'), {}),
             ('coadd', (COADD, EPOCHS, 0, 'cpu'), {'subtract_back': True}),
             ('coadd', (COADD, EPOCHS, 0, 'cpu'), {'subtract_back': False}),
             ('train', (t, y, masks, 'cpu'), {'params': params})]
    specs += [('subtract', (stop, B, 0, 'cpu'), {}) for stop in STOPS]
    return tmesh.spawn_ranks(legs.run_legs, 2, (specs,), threads=2)


@pytest.fixture(scope='module')
def slice_args():
    args, _ = inputs.plant_sources(
        inputs.synth_inputs(B, 256, 256, tp.PipelineConfig(**KW), seed=0),
        n=3, flux=2e4, seed=1)
    return args


@pytest.fixture(scope='module')
def single(slice_args):
    out = tp.SubtractDetectPipeline(tp.PipelineConfig(**KW))(
        *inputs.to_torch(slice_args, 'cpu'))
    return out


@pytest.fixture(scope='module')
def jax_mesh_runs(slice_args):
    """The reference's pipeline shard_mapped over two virtual devices on
    the inputs and on ``sci`` changed by 1e-7."""
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                ('data', 'space'))
    sh = NamedSharding(mesh, P('data'))
    fn = jp.make_subtract_detect_pipeline(jp.PipelineConfig(**KW), mesh=mesh)

    def run(args):
        with mesh:
            out = fn(*[jax.device_put(jnp.asarray(a), sh) for a in args])
            return {k: np.asarray(v) for k, v in out.items()}

    pert = ((slice_args[0] * np.float32(1 + 1e-7)).astype('f4'),) \
        + tuple(slice_args[1:])
    return run(slice_args), run(pert)


def test_dp_pipeline_bit_equal_to_single_process(ranks, single):
    dp = ranks[0][0]['out']
    assert set(dp) == set(single)
    for k in single:
        assert dp[k].dtype == single[k].dtype, k
        assert torch.equal(dp[k], single[k]), k
    assert ranks[1][0]['out'] is None


@pytest.mark.parametrize('i', range(len(STOPS)))
def test_dp_partial_dict_bit_equal_to_single_process(ranks, slice_args, i):
    """A stop's partial dict, stacked over each rank's frames and
    gathered over 'data', is the single-process port's."""
    single = tp.SubtractDetectPipeline(STOPS[i])(
        *inputs.to_torch(slice_args, 'cpu'))
    dp = ranks[0][4 + i]['out']
    assert set(dp) == set(single)
    for k in single:
        assert dp[k].shape[0] == B, k
        assert dp[k].dtype == single[k].dtype, k
        assert torch.equal(dp[k], single[k]), k
    assert ranks[1][4 + i]['out'] is None


def test_dp_pipeline_against_the_reference_mesh(ranks, jax_mesh_runs):
    j, jpert = jax_mesh_runs
    t = {k: v.numpy() for k, v in ranks[0][0]['out'].items()}
    assert set(t) == set(j)
    for k in j:
        assert t[k].shape == j[k].shape, k
    np.testing.assert_array_equal(t['submask'], j['submask'])
    assert (np.abs(t['det_n'] - j['det_n']) <= 1).all()
    ok = j['submask'] == 0
    q = [50, 90, 99, 100]
    own = np.percentile((np.abs(jpert['diff'] - j['diff']) / j['rms'])[ok],
                        q)
    port = np.percentile((np.abs(t['diff'] - j['diff']) / j['rms'])[ok], q)
    assert port[0] < 0.01
    assert (port <= 2.0 * own).all(), (port, own)
    np.testing.assert_allclose(t['rms_med'], j['rms_med'], rtol=1e-4)


class _Mesh:
    """A stand-in for one rank's view of a DeviceMesh: the shape and this
    rank's coordinate, all ``shard_batch`` and ``local_batch`` read."""

    def __init__(self, n_data, r, n_space=1, s=0):
        self.mesh = torch.arange(n_data * n_space).reshape(n_data, n_space)
        self.r, self.s = r, s

    def get_coordinate(self):
        return [self.r, self.s]


@pytest.mark.parametrize('batch', [2, 4, 6])
def test_dp_split_matches_partition_spec(ranks, batch):
    """Rank r runs the frames P('data') puts on device r: contiguous
    blocks, not round robin."""
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                ('data', 'space'))
    x = jax.device_put(jnp.arange(batch), NamedSharding(mesh, P('data')))
    want = {s.device.id: np.asarray(s.data).tolist()
            for s in x.addressable_shards}
    for r, dev in enumerate(mesh.devices[:, 0]):
        got = tmesh.shard_batch(_Mesh(2, r), torch.arange(batch)).tolist()
        assert got == want[dev.id]
        if batch == B:
            assert ranks[r][0]['frames'] == got


@pytest.mark.parametrize('n_data,n_space', [(2, 1), (1, 2), (2, 2),
                                             (4, 2)])
def test_local_batch_matches_partition_spec(n_data, n_space):
    """A rank's block of a whole batch is what ``P('data')`` (the
    pipeline's layout) and ``P(('data', 'space'))`` (braai's step,
    ``space_dim=0``) put on its device, and a view."""
    mesh = Mesh(np.asarray(jax.devices()[:n_data * n_space])
                .reshape(n_data, n_space), ('data', 'space'))
    x = np.arange(8 * 3).reshape(8, 3)
    for spec, space_dim in ((P('data'), None), (P(('data', 'space')), 0)):
        placed = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
        want = {sh.device.id: np.asarray(sh.data)
                for sh in placed.addressable_shards}
        for r in range(n_data):
            for s in range(n_space):
                got = tmesh.local_batch(_Mesh(n_data, r, n_space, s), x,
                                        space_dim=space_dim)
                np.testing.assert_array_equal(
                    got.numpy(), want[mesh.devices[r, s].id])
                assert np.shares_memory(got.numpy(), x)


def test_odd_batch_raises(slice_args):
    with pytest.raises(ValueError, match="'data' axis"):
        tmesh.shard_batch(_Mesh(2, 0), torch.arange(3))
    pipe = tp.SubtractDetectPipeline(tp.PipelineConfig(**KW), mesh=_Mesh(2, 0))
    odd = inputs.to_torch(tuple(a[:1] for a in slice_args), 'cpu')
    with pytest.raises(ValueError, match='does not divide'):
        pipe(*odd)
    with pytest.raises(ValueError, match="'space' axis"):
        tmesh.local_batch(_Mesh(1, 0, 2, 0), np.arange(3), space_dim=0)


@pytest.mark.parametrize('i,subtract_back', [(1, True), (2, False)])
def test_dp_coadd_rows_bit_equal(ranks, i, subtract_back):
    args = inputs.to_torch(inputs.coadd_inputs(EPOCHS, 256, 256, 32, seed=0),
                           'cpu')
    want = tp.CoaddPipeline(COADD, subtract_back=subtract_back)(*args)
    got = ranks[0][i]['out']
    assert set(got) == set(want) == {'coadd', 'weight', 'mask', 'nexp'}
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the scene exercises the gates and the bands' edges
    assert (want['nexp'] == EPOCHS).float().mean() > 0.8
    assert (want['nexp'] < EPOCHS).any()
    assert ((want['mask'] >> 16) & 1).any()


def test_dp_train_step_matches_jax(ranks, train_inputs):
    params, t, y, masks = train_inputs
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jst = optax.adam(LR).init(jparams)
    mu0 = _np_tree(jst[0].mu)
    jp2, jst2, jl = jbraai.train_step(jparams, jst, jnp.asarray(t),
                                      jnp.asarray(y), jax.random.PRNGKey(0))
    out = ranks[0][3]['out']
    assert ranks[1][3]['out'] is None
    assert int(out['count']) == 1
    assert abs(float(out['loss']) - float(jl)) <= 1e-6 * abs(float(jl))
    like = tbraai.params_from_flax(params)
    got = {name: tadam.views_like(out[name], like)['params']
           for name in ('params', 'mu', 'nu')}
    g = jax.tree_util.tree_map(
        lambda m, m0: (np.asarray(m, np.float64) - 0.9 * m0) / 0.1,
        _np_tree(jst2[0].mu), mu0)
    for name, layer in like['params'].items():
        for k in layer:
            for mom, want in (('mu', jst2[0].mu), ('nu', jst2[0].nu)):
                w = np.asarray(want['params'][name][k], np.float64)
                err = np.abs(got[mom][name][k].numpy() - w).max()
                assert err <= 1e-4 * np.abs(w).max(), (mom, name, k)
            gg = np.abs(g['params'][name][k])
            near0 = gg <= 1e-3 * gg.max()
            d = np.abs(got['params'][name][k].numpy()
                       - np.asarray(jp2['params'][name][k], np.float64))
            assert (d[~near0] <= 1e-5).all(), (name, k)
            assert (d[near0] <= 2 * LR).all(), (name, k)
            assert (d > 1e-5).sum() <= 1e-3 * d.size, (name, k)


def test_dp_train_step_matches_single_process(ranks, train_inputs):
    params, t, y, masks = train_inputs
    p = tadam.flat_tree(tbraai.params_from_flax(params), 'cpu')
    st = tadam.Adam(tbraai.TRAIN_LR).init(p)
    p, st, loss = tbraai.train_step(p, st, t, y, 0, masks=masks)
    out = ranks[0][3]['out']
    assert abs(float(out['loss']) - float(loss)) <= 1e-6 * abs(float(loss))
    # another summation order of the gradient, no more: Adam's first step
    # is lr * sign(g), so a sign that differs at g ~ 0 moves a parameter
    # by up to 2 lr
    d = (out['params'] - p.flat).abs()
    assert (d > 1e-5).float().mean() <= 1e-3
    assert float(d.max()) <= 2 * LR
    mu = st['mu'].flat
    assert float((out['mu'] - mu).abs().max()) <= 1e-5 * float(mu.abs().max())


def test_batch_sharding_and_init_distributed(monkeypatch):
    """``batch_sharding`` gives the placements of ``P('data')`` and of
    ``P('data', 'space')`` over rows; ``init_distributed`` is a no-op in a
    single process (no slurm or torchrun environment)."""
    from torch.distributed.tensor import Replicate, Shard
    assert tmesh.batch_sharding(None) == (Shard(0), Replicate())
    assert tmesh.batch_sharding(None, space_dim=1) == (Shard(0), Shard(1))
    for k in ('SLURM_NTASKS', 'WORLD_SIZE', 'RANK'):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.init_distributed('cpu') == (0, 1)
    assert not torch.distributed.is_initialized()
    assert tmesh.block_bounds(10, 3, 0) == (0, 4)
    assert [tmesh.block_bounds(10, 3, i) for i in range(3)] == [
        (0, 4), (4, 7), (7, 10)]
