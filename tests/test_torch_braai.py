"""The port's braai (``zuds_tpu_torch/models/braai.py``) against the JAX
package's flax model on the CPU.

* The constants of the ML step equal the reference's.
* The npz both ways: the JAX package's ``save_braai`` read by the port's
  ``load_braai`` and the port's ``save_braai`` read by the JAX package's,
  arrays equal under the flax key names.
* ``BraaiD6`` against ``rb_scores`` on 64 unit Gaussian triplets from a
  numpy seed, at the seed-0 flax init (the scores sit within ~0.002 of
  0.498, where a permuted flatten hardly shows) and with the weights
  spread by ``inputs.spread_braai`` (scores over a range of ~0.2): within 1e-6
  absolute. The first three layers come out bit-equal; the last
  convolution and the 9216-long dense products add in another order than
  XLA:CPU's (~4e-7 relative), which caps the gains of the spread.
* Each layer (H13's plain version) against flax's ``nn.Conv`` + ReLU (+
  ``max_pool``): rtol 1e-5, atol 1e-6.
* ``init_braai`` draws flax's distribution (truncated normal, variance 1 /
  fan_in, zero biases) from a seeded ``torch.Generator``.
* Without a device the entry points mean the card (``device='cpu'`` is
  the only way onto the CPU), so the tests pass it.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as nn
import pytest
import torch

from zuds_tpu import constants as jconst
from zuds_tpu.models import braai as jbraai
from zuds_tpu_torch import constants as tconst
from zuds_tpu_torch import inputs
from zuds_tpu_torch.kernels import launch
from zuds_tpu_torch.models import braai as tbraai
from zuds_tpu_torch.models.adam import flat_tree as tflat_tree

torch.set_num_threads(2)

N = 64
LAYERS = ('Conv_0', 'Conv_1', 'Conv_2', 'Conv_3', 'Dense_0', 'Dense_1')


def unit_triplets(n=N, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, 63, 63, 3)).astype('f4')
    return t / np.sqrt((t * t).sum((1, 2), keepdims=True))


@pytest.fixture(scope='module')
def flax_init():
    _, params = jbraai.init_braai(0)
    return jax.tree_util.tree_map(np.asarray, params)


def jax_scores(params, t):
    tree = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float32)), params)
    return np.asarray(jbraai.rb_scores(tree, jnp.asarray(t)))


def test_ml_constants_equal_the_reference():
    assert tconst.CUTOUT_SIZE == jconst.CUTOUT_SIZE == 63
    assert tconst.RB_CUT == jconst.RB_CUT
    assert tconst.BRAAI_MODEL == jconst.BRAAI_MODEL == 'braai_d6_m9'


def test_param_shapes_are_flax_s(flax_init):
    shapes = tbraai.param_shapes()
    assert list(shapes) == list(LAYERS)
    for name in LAYERS:
        assert flax_init['params'][name]['kernel'].shape == shapes[name]
        assert flax_init['params'][name]['bias'].shape == shapes[name][-1:]
    assert shapes['Dense_0'] == (9216, 256)


def test_npz_from_jax_to_port(tmp_path, flax_init):
    path = str(tmp_path / 'jax.npz')
    jbraai.save_braai(flax_init, path)
    with np.load(path) as f:
        keys = set(f.files)
    assert keys == {f"['params']['{n}']['{k}']" for n in LAYERS
                    for k in ('kernel', 'bias')}
    model, params = tbraai.load_braai(path, seed=5, device='cpu')
    for name in LAYERS:
        for k in ('kernel', 'bias'):
            np.testing.assert_array_equal(
                params['params'][name][k].numpy(),
                flax_init['params'][name][k], err_msg=f'{name} {k}')
            assert getattr(model, name)[k] is not None


def test_npz_from_port_to_jax(tmp_path):
    model, params = tbraai.init_braai(3, device='cpu')
    path = str(tmp_path / 'port.npz')
    tbraai.save_braai(model, path)
    _, jparams = jbraai.load_braai(path)
    for name in LAYERS:
        for k in ('kernel', 'bias'):
            np.testing.assert_array_equal(
                np.asarray(jparams['params'][name][k]),
                params['params'][name][k].numpy(), err_msg=f'{name} {k}')
    # a missing file is the fresh init, as in the reference
    fresh, _ = tbraai.load_braai(str(tmp_path / 'absent.npz'), seed=3,
                                 device='cpu')
    assert torch.equal(fresh.Dense_0['kernel'], model.Dense_0['kernel'])


@pytest.mark.parametrize('spread', [False, True])
def test_scores_match_flax(flax_init, spread):
    params = inputs.spread_braai(flax_init) if spread else flax_init
    t = unit_triplets()
    want = jax_scores(params, t)
    model = tbraai.BraaiD6().load_params(params)
    got = tbraai.rb_scores(model, t)
    assert got.shape == (N,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if spread:
        assert want.max() - want.min() > 0.15
    else:
        assert np.abs(want - 0.498).max() < 0.005
    # the parameter tree scores as the model does
    np.testing.assert_array_equal(
        tbraai.rb_scores(model.params(), t, device='cpu').numpy(),
        got.numpy())


def test_a_permuted_flatten_shows_at_the_spread_weights(flax_init):
    """An NCHW flatten before Dense_0 moves the init's scores by under
    0.01 (they all sit near 0.498) and the spread weights' by far more."""
    t = torch.as_tensor(unit_triplets(16))
    deltas = []
    for spread in (False, True):
        params = inputs.spread_braai(flax_init) if spread else flax_init
        model = tbraai.BraaiD6().load_params(params)
        x = t
        for i in range(4):
            layer = getattr(model, f'Conv_{i}')
            x = tbraai.conv3x3_plain(x, layer['kernel'], layer['bias'],
                                     i % 2 == 1)
        wrong = x.permute(0, 3, 1, 2).reshape(16, -1)
        h = torch.relu(wrong @ model.Dense_0['kernel']
                       + model.Dense_0['bias'])
        bad = torch.sigmoid(h @ model.Dense_1['kernel']
                            + model.Dense_1['bias'])[:, 0]
        deltas.append(float((bad - model(t)).abs().max()))
    assert deltas[0] < 0.01 and deltas[1] > 0.1, deltas


@pytest.mark.parametrize('i', range(4))
def test_each_layer_matches_flax(flax_init, i):
    """Layer ``i`` on the seed-0 init, fed flax's output of the layers
    before it on unit triplets (the scale the scorer sees)."""
    x = jnp.asarray(unit_triplets(8))
    for j in range(i + 1):
        layer = flax_init['params'][f'Conv_{j}']
        inp = np.array(x)
        x = jax.lax.conv_general_dilated(
            x, jnp.asarray(layer['kernel']), (1, 1), 'VALID',
            dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
        x = jax.nn.relu(x + jnp.asarray(layer['bias']))
        if j % 2:
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
    got = tbraai.conv3x3(torch.from_numpy(inp),
                         torch.tensor(layer['kernel']),
                         torch.tensor(layer['bias']), i % 2 == 1)
    want = np.asarray(x)
    assert got.shape == want.shape == (8,) + {0: (61, 61, 32),
                                              1: (29, 29, 32),
                                              2: (27, 27, 64),
                                              3: (12, 12, 64)}[i]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_init_draws_flax_s_distribution():
    _, a = tbraai.init_braai(0, device='cpu')
    _, b = tbraai.init_braai(0, device='cpu')
    _, c = tbraai.init_braai(1, device='cpu')
    for name, shape in tbraai.param_shapes().items():
        k = a['params'][name]['kernel']
        assert torch.equal(k, b['params'][name]['kernel'])
        assert not torch.equal(k, c['params'][name]['kernel'])
        assert not a['params'][name]['bias'].any()
        std = 1.0 / math.sqrt(math.prod(shape[:-1]))
        assert float(k.abs().max()) <= 2.0 * std / 0.87962566103423978
        if k.numel() >= 800:
            assert abs(float(k.std()) - std) < 0.1 * std


def test_parameters_are_checked(flax_init):
    bad = jax.tree_util.tree_map(lambda a: a, flax_init)
    bad['params']['Dense_0']['kernel'] = np.zeros((64, 256), 'f4')
    with pytest.raises(ValueError, match='Dense_0'):
        tbraai.params_from_flax(bad)
    with pytest.raises(KeyError, match='Conv_0'):
        tbraai.params_from_flax({})


def test_h13_wrapper_refuses_cpu_tensors_and_other_layers():
    x = torch.zeros((2, 63, 63, 3))
    w, b = torch.zeros((3, 3, 3, 32)), torch.zeros(32)
    n0 = launch.braai_conv3x3.launches
    with pytest.raises(ValueError, match='CUDA'):
        launch.braai_conv3x3(x, w, b, False)
    with pytest.raises(ValueError, match='CUDA'):
        launch.triplet_cut(x[0, :, :, 0], x[0, :, :, 0], x[0, :, :, 0],
                           torch.zeros(1, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match='CUDA'):
        launch.negpix_veto(x[0, :, :, 0], torch.zeros(()), torch.zeros(()),
                           torch.zeros(1, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32))
    assert launch.braai_conv3x3.launches == n0
    assert launch.BRAAI_LAYERS == tuple(
        (s[2], s[3], i % 2 == 1)
        for i, s in enumerate(list(tbraai.param_shapes().values())[:4]))
    assert {'triplet_cut', 'negpix_veto', 'braai_conv3x3'} <= set(
        launch.WRAPPERS)


def test_entry_points_default_to_the_card(flax_init, tmp_path):
    """Without a device the braai entry points mean the card: on a machine
    without one they raise and name ``device='cpu'``; a model stays where
    the caller put it."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: device=None is the card')
    t = unit_triplets(2)
    for call in (lambda: tbraai.init_braai(0),
                 lambda: tbraai.load_braai(str(tmp_path / 'absent.npz')),
                 lambda: tbraai.rb_scores(flax_init, t),
                 lambda: tbraai.make_train_state(0),
                 lambda: tbraai.opt_state_from_optax(
                     (0, flax_init, flax_init)),
                 lambda: tflat_tree(tbraai.params_from_flax(flax_init))):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()
    # train_step takes no tree it would have to place: a numpy or
    # params_from_flax tree is refused, not trained on the CPU
    for tree in (flax_init, tbraai.params_from_flax(flax_init)):
        with pytest.raises(TypeError, match='flat_tree'):
            tbraai.train_step(tree, None, t, np.array([0.0, 1.0], 'f4'), 0)
    model = tbraai.BraaiD6().load_params(flax_init)
    assert tbraai.rb_scores(model, t).device.type == 'cpu'
    assert tbraai.rb_scores(flax_init, t, device='cpu').device.type == 'cpu'
