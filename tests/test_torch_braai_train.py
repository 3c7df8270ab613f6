"""The port's braai training (``zuds_tpu_torch/models/braai.py``,
``models/adam.py``) against the JAX package's ``train_step`` and optax on
the CPU, at the full width of the d6 net and a batch of 8.

* Each ``Conv3x3Fn`` (the plain path of H13t, H19, H20) against
  ``jax.vjp`` of the flax layer (conv, ReLU, and for the pooled layers
  ``max_pool`` and flax's dropout ``select(mask, x / keep, 0)``) with the
  same mask and cotangent: values and gradients within 1e-5 of the
  reference's largest magnitude (another summation order, no more).
* ``bce_loss`` and its gradient at and beyond the clip's edges against
  ``jax.grad`` of the reference's loss (braai.py:96-100): the gradient is 0
  outside [1e-7, 1 - 1e-7] and halved on the edges, as ``jnp.clip``'s.
* ``Adam.update`` against ``optax.adam(3e-4).update`` and
  ``apply_updates`` over 3 steps on random gradients: params, mu and nu
  within 1 ulp.
* ``opt_state_from_optax`` and ``opt_state_to_numpy`` both ways.
* ``train_step`` against the JAX ``train_step`` from one flax init carried
  over by ``params_from_flax`` and ``opt_state_from_optax``, 3 chained
  steps with flax's own dropout masks (read back from the flax module's
  outputs): the loss within 1e-6 relative (it comes out equal), mu and nu
  within 1e-4 of each leaf's largest magnitude, and the parameters by the
  Adam-aware rule: Adam's first steps move each parameter by about lr
  times the sign of its gradient, so where the gradient is near 0 (under
  1e-3 of its leaf's largest) a sign that differs between the frameworks
  moves it by up to 2 lr; there the parameters may differ by 2 lr, and
  elsewhere by 1e-5 (lr / 30); elements past 1e-5 stay under 0.1% of each
  leaf.
* The slice whole: ``make_train_state(device='cpu')``, 5 steps on
  ``inputs.labelled_triplets``, ``save_braai``, then the JAX package's
  ``load_braai`` and ``rb_scores`` score as the port does (1e-6).
* The new wrappers refuse CPU tensors.
* The precision of H19 and H20 (3xTF32 on the card's tensor cores)
  emulated here: ``cvt.rna`` on the uint32 view (round half away from
  zero on the 13 dropped mantissa bits), hi*hi + hi*lo + lo*hi in f32,
  on one CPU step's own tensors at a batch of 4 (layer 3's input
  gradient, layer 2's weight gradient): within 1e-5 (H19) and 1e-4 (H20)
  of the float64 gradient's largest magnitude, the tolerances
  ``chip_smoke.py`` holds the kernels to, and no further from float64
  than the fp32 plain version times 4.
"""
import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as nn
import optax
import pytest
import torch

from zuds_tpu.models import braai as jbraai
from zuds_tpu_torch import inputs
from zuds_tpu_torch.kernels import launch
from zuds_tpu_torch.models import adam as tadam
from zuds_tpu_torch.models import braai as tbraai

torch.set_num_threads(2)

N = 8
STEPS = 3
LR = 3e-4
LAYERS = ('Conv_0', 'Conv_1', 'Conv_2', 'Conv_3', 'Dense_0', 'Dense_1')
# the layers' input sides (63, 61, 29, 27)
SIDES = (63, 61, 29, 27)


def unit_triplets(n=N, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(n, 63, 63, 3)).astype('f4')
    return t / np.sqrt((t * t).sum((1, 2), keepdims=True))


def labels(n=N):
    return (np.arange(n) % 2).astype('f4')


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def flax_init():
    _, params = jbraai.init_braai(0)
    return np_tree(params)


def flax_masks(params, x, key):
    """The dropout masks ``BraaiD6().apply(..., train=True)`` draws from
    ``key``: True where a Dropout's output is non-zero. Where its input is
    0 the mask cannot be read, and need not be: the forward is 0 either
    way, and so is the gradient (a pool output of 0 means ReLU's gradient
    is 0 at all four of its positions; Dense_0's ReLU likewise)."""
    _, state = jbraai.BraaiD6().apply(
        params, jnp.asarray(x), train=True, rngs={'dropout': key},
        capture_intermediates=lambda m, _: isinstance(m, nn.Dropout),
        mutable=['intermediates'])
    return {name: np.asarray(v['__call__'][0]) != 0
            for name, v in state['intermediates'].items()}


def reference_loss(scores, y):
    """braai.py:96-100's loss on given scores."""
    eps = 1e-7
    s = jnp.clip(scores, eps, 1 - eps)
    return -jnp.mean(y * jnp.log(s) + (1 - y) * jnp.log(1 - s))


def close_to_max(got, want, rel, what):
    err = np.abs(np.asarray(got, np.float64) - want).max()
    scale = np.abs(want).max()
    assert err <= rel * scale, f'{what}: {err:.3g} > {rel} x {scale:.3g}'


@pytest.mark.parametrize('i', range(4))
def test_conv3x3fn_matches_flax_vjp(flax_init, i):
    """Layer ``i`` fed flax's output of the layers before it on unit
    triplets (the scale training sees), a dropout mask from a numpy seed
    and a random cotangent: the forward and the three gradients."""
    x = jnp.asarray(unit_triplets())
    for j in range(i):
        layer = flax_init['params'][f'Conv_{j}']
        x = jax.lax.conv_general_dilated(
            x, jnp.asarray(layer['kernel']), (1, 1), 'VALID',
            dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
        x = jax.nn.relu(x + jnp.asarray(layer['bias']))
        if j % 2:
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
    layer = flax_init['params'][f'Conv_{i}']
    pool = i % 2 == 1
    keep = tbraai.KEEP_CONV
    out_shape = tbraai.dropout_shapes(N)[f'Dropout_{i // 2}'] if pool else \
        (N, SIDES[i] - 2, SIDES[i] - 2, layer['kernel'].shape[-1])
    rng = np.random.default_rng(10 + i)
    mask = rng.random(out_shape) < keep if pool else None
    gy = rng.normal(size=out_shape).astype('f4')

    def f(x, w, b):
        y = jax.lax.conv_general_dilated(
            x, w, (1, 1), 'VALID', dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
        y = jax.nn.relu(y + b)
        if pool:
            y = nn.max_pool(y, (2, 2), strides=(2, 2))
            y = jax.lax.select(jnp.asarray(mask), y / keep, jnp.zeros_like(y))
        return y

    want, vjp = jax.vjp(f, x, jnp.asarray(layer['kernel']),
                        jnp.asarray(layer['bias']))
    gx_w, gw_w, gb_w = (np.asarray(a) for a in vjp(jnp.asarray(gy)))
    xt = torch.tensor(np.asarray(x), requires_grad=True)
    wt = torch.tensor(layer['kernel'], requires_grad=True)
    bt = torch.tensor(layer['bias'], requires_grad=True)
    got = tbraai.Conv3x3Fn.apply(
        xt, wt, bt, pool, None if mask is None else torch.from_numpy(mask),
        keep if pool else 1.0)
    assert got.shape == out_shape
    close_to_max(got.detach().numpy(), np.asarray(want), 1e-5, 'forward')
    got.backward(torch.from_numpy(gy))
    close_to_max(xt.grad.numpy(), gx_w, 1e-5, 'input gradient')
    close_to_max(wt.grad.numpy(), gw_w, 1e-5, 'kernel gradient')
    close_to_max(bt.grad.numpy(), gb_w, 1e-5, 'bias gradient')
    if pool:
        # the routing bytes name the first maximum of each window
        _, route = tbraai.conv3x3_train_plain(
            xt.detach(), wt.detach(), bt.detach(), True)
        assert route.dtype == torch.uint8 and route.shape == out_shape
        assert set(np.unique(route.numpy())) <= {0, 1, 2, 3, 255}
        assert (route.numpy() == 255).any() and (route.numpy() < 4).any()


def test_conv0_skips_the_input_gradient(flax_init):
    """The triplets need no gradient: Conv_0's backward forms none."""
    layer = flax_init['params']['Conv_0']
    w = torch.tensor(layer['kernel'], requires_grad=True)
    b = torch.tensor(layer['bias'], requires_grad=True)
    x = torch.from_numpy(unit_triplets(2))
    y = tbraai.Conv3x3Fn.apply(x, w, b, False, None, 1.0)
    y.sum().backward()
    assert x.grad is None and w.grad is not None and b.grad is not None


def test_bce_loss_and_its_gradient_at_the_clip_edges():
    lo, hi = np.float32(1e-7), np.float32(1 - 1e-7)
    s = np.array([0.0, 5e-8, lo, np.nextafter(lo, np.float32(1)), 0.3, 0.5,
                  np.nextafter(hi, np.float32(0)), hi, 0.99999994, 1.0],
                 np.float32)
    for y in (np.zeros_like(s), np.ones_like(s), (np.arange(10) % 2)
              .astype('f4')):
        want, gwant = jax.value_and_grad(reference_loss)(jnp.asarray(s),
                                                          jnp.asarray(y))
        st = torch.tensor(s, requires_grad=True)
        got = tbraai.bce_loss(st, torch.from_numpy(y))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6)
        g = st.grad.numpy()
        np.testing.assert_allclose(g, np.asarray(gwant), rtol=1e-6, atol=0)
        assert (g[[0, 1, 8, 9]] == 0).all()       # outside the clip
        # on the edges half of the log's gradient, inside all of it
        with np.errstate(divide='ignore', invalid='ignore'):
            full = -(y / s.astype(np.float64)
                     - (1 - y) / (1 - s.astype(np.float64))) / len(s)
        np.testing.assert_allclose(g[[2, 7]], 0.5 * full[[2, 7]], rtol=1e-5)
        np.testing.assert_allclose(g[[3, 4, 5, 6]], full[[3, 4, 5, 6]],
                                   rtol=1e-5)


def _random_tree(rng, scale):
    return {'params': {name: {
        'kernel': (scale * rng.normal(size=shape)).astype('f4'),
        'bias': (scale * rng.normal(size=shape[-1:])).astype('f4')}
        for name, shape in tbraai.param_shapes().items()}}


def test_adam_matches_optax_within_one_ulp():
    rng = np.random.default_rng(3)
    params = _random_tree(rng, 0.05)
    tx = optax.adam(LR)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = tx.init(jp)
    adam = tadam.Adam(LR)
    tp = tadam.flat_tree(tbraai.params_from_flax(params), 'cpu')
    tst = adam.init(tp)
    for step in range(STEPS):
        grads = _random_tree(rng, 10.0 ** -(step + 2))
        # a few exact zeros and tiny values, where eps matters
        grads['params']['Dense_0']['kernel'][:3] = 0.0
        grads['params']['Dense_0']['kernel'][3:6] *= 1e-6
        updates, jst = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                 jst, jp)
        jp = optax.apply_updates(jp, updates)
        tp, tst = adam.update(
            tadam.flat_tree(tbraai.params_from_flax(grads), 'cpu'), tst, tp)
        assert int(tst['count']) == int(jst[0].count) == step + 1
        for name in LAYERS:
            for k in ('kernel', 'bias'):
                for got, want in ((tp, jp), (tst['mu'], jst[0].mu),
                                  (tst['nu'], jst[0].nu)):
                    np.testing.assert_array_max_ulp(
                        got['params'][name][k].numpy(),
                        np.asarray(want['params'][name][k]), maxulp=1)


def test_adam_updates_flat_buffers_in_place():
    tp = tbraai.params_from_flax(_random_tree(np.random.default_rng(4), 0.1))
    views = tadam.flat_tree(tp, 'cpu')
    flat = views.flat
    assert views['params']['Conv_0']['kernel'].data_ptr() == flat.data_ptr()
    assert tp['params']['Conv_0']['kernel'].data_ptr() != flat.data_ptr()
    adam = tadam.Adam(LR)
    state = adam.init(views)
    before = flat.clone()
    grads = tadam.views_like(torch.ones_like(flat), views)
    out, state = adam.update(grads, state, views)
    assert out is views and int(state['count']) == 1
    assert torch.allclose(flat, before - LR, rtol=0, atol=1e-6)
    # any other tree is refused, and so are moments on another device than
    # the parameters: nothing is copied or written
    after = flat.clone()
    with pytest.raises(TypeError, match='flat_tree'):
        adam.update(grads, state, tp)
    with pytest.raises(TypeError, match='flat_tree'):
        adam.init(tp)
    elsewhere = dict(state, mu=tadam.views_like(
        torch.zeros(flat.numel(), device='meta'), views))
    with pytest.raises(ValueError, match='meta'):
        adam.update(grads, elsewhere, views)
    assert torch.equal(flat, after) and int(state['count']) == 1


def test_opt_state_both_ways(flax_init):
    tx = optax.adam(LR)
    rng = np.random.default_rng(5)
    jst = tx.init(flax_init)
    _, jst = tx.update(jax.tree_util.tree_map(jnp.asarray,
                                              _random_tree(rng, 1e-3)),
                       jst, flax_init)
    jst = np_tree(jst)
    st = tbraai.opt_state_from_optax(jst, device='cpu')
    assert st['count'].dtype == torch.int32 and int(st['count']) == 1
    count, mu, nu = tbraai.opt_state_to_numpy(st)
    assert count == 1 and count.dtype == np.int32
    for name in LAYERS:
        for k in ('kernel', 'bias'):
            for got, want in ((st['mu'], jst[0].mu), (st['nu'], jst[0].nu)):
                np.testing.assert_array_equal(
                    got['params'][name][k].numpy(),
                    want['params'][name][k])
            np.testing.assert_array_equal(mu['params'][name][k],
                                          jst[0].mu['params'][name][k])
            np.testing.assert_array_equal(nu['params'][name][k],
                                          jst[0].nu['params'][name][k])
    # optax takes the way back as its own state
    back = (optax.ScaleByAdamState(*tbraai.opt_state_to_numpy(st)),
            optax.EmptyState())
    again = tbraai.opt_state_from_optax(back, device='cpu')
    assert torch.equal(again['nu'].flat, st['nu'].flat)
    # the moments are views of one flat buffer each
    assert isinstance(st['mu'], tadam.FlatTree)
    assert st['mu']['params']['Conv_0']['kernel'].data_ptr() == \
        st['mu'].flat.data_ptr()


@pytest.fixture(scope='module')
def chained(flax_init):
    """STEPS chained steps of both packages from the flax init, the port
    fed flax's masks: per step (jax params, jax state, jax loss, port
    params, port state, port loss) as numpy, and the JAX gradients formed
    from its moments."""
    t, y = unit_triplets(), labels()
    jp = jax.tree_util.tree_map(jnp.asarray, flax_init)
    jst = optax.adam(LR).init(jp)
    tp = tadam.flat_tree(tbraai.params_from_flax(flax_init), 'cpu')
    tst = tbraai.opt_state_from_optax(np_tree(jst), device='cpu')
    out = []
    for step in range(STEPS):
        key = jax.random.PRNGKey(step)
        masks = flax_masks(jp, t, key)
        mu_before = np_tree(jst[0].mu)
        jp, jst, jl = jbraai.train_step(jp, jst, jnp.asarray(t),
                                        jnp.asarray(y), key)
        tp, tst, tl = tbraai.train_step(tp, tst, t, y, 0, masks=masks)
        # mu = 0.1 g + 0.9 mu_before
        g = jax.tree_util.tree_map(
            lambda m, m0: (np.asarray(m, np.float64) - 0.9 * m0) / 0.1,
            np_tree(jst[0].mu), mu_before)
        out.append(dict(jp=np_tree(jp), jst=np_tree(jst), jl=float(jl),
                        tp={n: {k: v.numpy().copy() for k, v in layer.items()}
                            for n, layer in tp['params'].items()},
                        tst=tbraai.opt_state_to_numpy(tst), tl=float(tl),
                        g=g, masks=masks))
    return out


@pytest.mark.parametrize('step', range(STEPS))
def test_train_step_matches_jax(chained, step):
    r = chained[step]
    assert abs(r['tl'] - r['jl']) <= 1e-6 * abs(r['jl']), (r['tl'], r['jl'])
    _, mu, nu = r['tst']
    assert int(r['tst'][0]) == int(r['jst'][0].count) == step + 1
    for name in LAYERS:
        for k in ('kernel', 'bias'):
            for got, want in ((mu, r['jst'][0].mu), (nu, r['jst'][0].nu)):
                close_to_max(got['params'][name][k],
                             want['params'][name][k], 1e-4, f'{name} {k}')
            g = np.abs(r['g']['params'][name][k])
            near0 = g <= 1e-3 * g.max()
            d = np.abs(r['tp'][name][k]
                       - r['jp']['params'][name][k].astype(np.float64))
            assert (d[~near0] <= 1e-5).all(), (name, k, d[~near0].max())
            assert (d[near0] <= 2 * LR).all(), (name, k, d[near0].max())
            assert (d > 1e-5).sum() <= 1e-3 * d.size, (name, k)


def test_flax_masks_are_the_steps_masks(chained):
    """The recovered masks keep about their keep share of the non-zero
    outputs, and every step's differ (keys 0, 1, 2)."""
    for r in chained:
        m = r['masks']
        assert set(m) == {'Dropout_0', 'Dropout_1', 'Dropout_2'}
        assert m['Dropout_0'].shape == (N, 29, 29, 32)
        assert 0.4 < m['Dropout_0'].mean() < 0.75
        assert 0.4 < m['Dropout_1'].mean() < 0.75
        assert 0.1 < m['Dropout_2'].mean() < 0.5
    assert (chained[0]['masks']['Dropout_0']
            != chained[1]['masks']['Dropout_0']).any()


def test_training_mode_forward_matches_flax(flax_init):
    """``BraaiD6.forward(train=True, masks=)`` against flax's training
    forward with the key the masks came from."""
    t = unit_triplets()
    key = jax.random.PRNGKey(7)
    masks = flax_masks(flax_init, t, key)
    want = np.asarray(jbraai.BraaiD6().apply(flax_init, jnp.asarray(t),
                                             train=True,
                                             rngs={'dropout': key}))
    model = tbraai.BraaiD6().load_params(flax_init)
    masks_t = {k: torch.from_numpy(v) for k, v in masks.items()}
    got = model(torch.from_numpy(t), train=True, masks=masks_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    plain = model.forward_plain(torch.from_numpy(t), train=True,
                                masks=masks_t)
    assert torch.equal(plain, got)
    with pytest.raises(ValueError, match='rng or masks'):
        model(torch.from_numpy(t), train=True)


def test_masks_drawn_from_a_seed():
    a = tbraai.draw_masks(4, 3, 'cpu')
    b = tbraai.draw_masks(4, 3, 'cpu')
    c = tbraai.draw_masks(4, torch.Generator().manual_seed(3), 'cpu')
    for name, shape in tbraai.dropout_shapes(4).items():
        assert a[name].shape == shape and a[name].dtype == torch.bool
        assert torch.equal(a[name], b[name]) and torch.equal(a[name],
                                                             c[name])
    assert abs(float(a['Dropout_0'].float().mean()) - 0.75) < 0.01
    assert abs(float(a['Dropout_2'].float().mean()) - 0.5) < 0.1


def test_labelled_triplets():
    t, y = inputs.labelled_triplets(12, seed=2)
    t2, y2 = inputs.labelled_triplets(12, seed=2)
    assert t.shape == (12, 63, 63, 3) and t.dtype == np.float32
    assert np.array_equal(t, t2) and np.array_equal(y, y2)
    assert y.dtype == np.float32 and set(np.unique(y)) == {0.0, 1.0}
    np.testing.assert_allclose(np.sqrt((t * t).sum((1, 2))), 1.0, rtol=1e-5)
    real = t[y == 1]
    # a real source: new and sub peak together at the centre, ref has none
    c = slice(28, 35)
    for ch in (0, 2):
        assert (real[:, c, c, ch].max((1, 2))
                > 3 * np.abs(real[:, :10, :10, ch]).max((1, 2))).all()
    assert (np.abs(real[:, c, c, 1]).max((1, 2))
            < 3 * np.abs(real[:, :10, :10, 1]).max((1, 2))).all()
    assert not np.array_equal(t, inputs.labelled_triplets(12, seed=3)[0])


def test_make_train_state_and_the_slice_whole(tmp_path):
    """make_train_state on the CPU, 5 steps on labelled triplets (the loss
    falls), save_braai, then the JAX package's load_braai + rb_scores give
    the port's scores of the trained model."""
    model, params, tx, state = tbraai.make_train_state(0, lr=1e-3,
                                                       device='cpu')
    assert isinstance(tx, tadam.Adam) and tx.lr == 1e-3
    assert int(state['count']) == 0
    assert params['params']['Conv_0']['kernel'].data_ptr() == \
        model.Conv_0['kernel'].data_ptr()
    assert params.flat.numel() == 2425377
    t, y = inputs.labelled_triplets(16, seed=0)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(5):
        out, state, loss = tbraai.train_step(params, state, t, y, gen)
        assert out is params     # in place
        losses.append(float(loss))
    assert int(state['count']) == 5
    assert losses[-1] < losses[0], losses
    # the model is the trained tree
    path = str(tmp_path / 'trained.npz')
    tbraai.save_braai(model, path)
    _, jparams = jbraai.load_braai(path)
    want = np.asarray(jbraai.rb_scores(jparams, jnp.asarray(t)))
    got = tbraai.rb_scores(model, t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tbraai.rb_scores(params, t, device='cpu').numpy(), got.numpy())


def test_train_step_copies_other_trees(flax_init):
    """Only ``flat_tree`` copies a tree: ``train_step`` refuses any tree
    that is not a FlatTree, and moments on another device than the
    parameters, before it writes anything; on the explicit copy it works in
    place, the tree it came from left as it was."""
    tp = tbraai.params_from_flax(flax_init)
    t, y = unit_triplets(2), labels(2)
    flat = tadam.flat_tree(tp, 'cpu')
    st = tadam.Adam().init(flat)
    for params in (tp, flax_init):
        with pytest.raises(TypeError, match='flat_tree'):
            tbraai.train_step(params, st, t, y, 1)
    before = flat.flat.clone()
    elsewhere = dict(st, nu=tadam.views_like(
        torch.zeros(before.numel(), device='meta'), flat))
    with pytest.raises(ValueError, match='meta'):
        tbraai.train_step(flat, elsewhere, t, y, 1)
    assert torch.equal(flat.flat, before) and int(st['count']) == 0
    out, st2, _ = tbraai.train_step(flat, st, t, y, 1)
    assert out is flat and st2['mu'] is st['mu']
    assert not torch.equal(flat.flat, before)
    np.testing.assert_array_equal(tp['params']['Conv_0']['kernel'].numpy(),
                                  flax_init['params']['Conv_0']['kernel'])
    out2, _, _ = tbraai.train_step(out, st2, t, y, 2)
    assert out2 is out


def test_training_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 61, 61, 32))
    w, b = torch.zeros((3, 3, 32, 32)), torch.zeros(32)
    gy = torch.zeros((2, 29, 29, 32))
    route = torch.zeros((2, 29, 29, 32), dtype=torch.uint8)
    counts = {k: launch.WRAPPERS[k].launches for k in (
        'braai_conv3x3_train', 'braai_conv3x3_dgrad', 'braai_conv3x3_wgrad',
        'adam_step')}
    with pytest.raises(ValueError, match='CUDA'):
        launch.braai_conv3x3_train(x, w, b, True)
    with pytest.raises(ValueError, match='CUDA'):
        launch.braai_conv3x3_dgrad(gy, w, route, None, 0.75, True,
                                   tuple(x.shape))
    with pytest.raises(ValueError, match='CUDA'):
        launch.braai_conv3x3_wgrad(x, gy, route, None, 0.75, True)
    p = torch.zeros(16)
    with pytest.raises(ValueError, match='CUDA'):
        launch.adam_step(p, p, p, p, torch.ones(()), torch.ones(()), LR,
                         0.9, 0.999, 1e-8)
    for k, n in counts.items():
        assert launch.WRAPPERS[k].launches == n


def tf32_rna(a):
    """``cvt.rna.tf32.f32`` in numpy: the 13 low mantissa bits dropped,
    the magnitude rounded half away from zero (the sign bit is apart)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mm_3xtf32(a, b):
    """``a @ b`` as H19 and H20 form it: each operand split hi = tf32(v),
    lo = tf32(v - hi); lo*hi + hi*lo + hi*hi, each product exact in f32
    (11-bit significands), summed in f32."""
    ah = tf32_rna(a)
    al = tf32_rna(a - ah)
    bh = tf32_rna(b)
    bl = tf32_rna(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


@pytest.fixture(scope='module')
def backward_args():
    """The arguments of H19 and H20 in one CPU train_step at a batch of 4
    (the card's dispatchers, recorded): {'dgrad': [...], 'wgrad': [...]}"""
    t, y = inputs.labelled_triplets(4, seed=3)
    _, params, _, state = tbraai.make_train_state(0, device='cpu')
    rec = {'dgrad': [], 'wgrad': []}
    saved = tbraai.conv3x3_dgrad, tbraai.conv3x3_wgrad

    def keep(store, fn):
        def call(*args):
            store.append(tuple(a.detach() if torch.is_tensor(a) else a
                               for a in args))
            return fn(*args)
        return call

    tbraai.conv3x3_dgrad = keep(rec['dgrad'], saved[0])
    tbraai.conv3x3_wgrad = keep(rec['wgrad'], saved[1])
    try:
        tbraai.train_step(params, state, t, y, 0)
    finally:
        tbraai.conv3x3_dgrad, tbraai.conv3x3_wgrad = saved
    return rec


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max())


def test_h19_precision_3xtf32_layer3(backward_args):
    """Layer 3's input gradient (29x29x32 from the 27x27x64 gradient of its
    output): per tap gz_shift @ w[ky, kx]^T in 3xTF32, the taps added in
    f32 as the kernel flushes them."""
    gy, w, saved, mask, keep, pool, in_shape = next(
        a for a in backward_args['dgrad'] if tuple(a[6])[1] == 29)
    n, h, wd, cin = in_shape
    gz = tbraai.grad_z_plain(gy, saved, mask, keep, pool,
                             (h - 2, wd - 2)).numpy()
    pad = np.pad(gz, ((0, 0), (2, 2), (2, 2), (0, 0)))
    wn = w.numpy()
    emu = np.zeros((n * h * wd, cin), np.float32)
    ref = np.zeros((n * h * wd, cin), np.float64)
    for ky in range(3):
        for kx in range(3):
            a = pad[:, 2 - ky:2 - ky + h, 2 - kx:2 - kx + wd].reshape(
                n * h * wd, -1)
            emu += mm_3xtf32(a, np.ascontiguousarray(wn[ky, kx].T))
            ref += a.astype(np.float64) @ wn[ky, kx].T.astype(np.float64)
    ref = ref.reshape(n, h, wd, cin)
    plain = tbraai.conv3x3_dgrad_plain(gy, w, saved, mask, keep, pool,
                                       in_shape).numpy()
    e3, ep = _max_err(emu.reshape(ref.shape), ref), _max_err(plain, ref)
    scale = float(np.abs(ref).max())
    assert scale > 0 and e3 <= 1e-5 * scale, (e3, scale)
    assert e3 <= 4 * ep, (e3, ep)


def test_h20_precision_3xtf32_layer2(backward_args):
    """Layer 2's weight gradient (3x3x32x32 over 4 images of 58x58 routed
    positions): per image and tap x_shift^T @ gz in 3xTF32, the images
    added in f32 as the kernel's chunks are."""
    x, gy, saved, mask, keep, pool = next(
        a for a in backward_args['wgrad'] if a[0].shape[1] == 61)
    n, h, wd, cin = x.shape
    gz = tbraai.grad_z_plain(gy, saved, mask, keep, pool,
                             (h - 2, wd - 2)).numpy()
    he, we = 2 * gy.shape[1], 2 * gy.shape[2]
    xn = x.numpy()
    emu = np.zeros((3, 3, cin, gz.shape[-1]), np.float32)
    ref = np.zeros(emu.shape, np.float64)
    for i in range(n):
        g = gz[i, :he, :we].reshape(he * we, -1)
        for ky in range(3):
            for kx in range(3):
                a = np.ascontiguousarray(
                    xn[i, ky:ky + he, kx:kx + we].reshape(he * we, cin).T)
                emu[ky, kx] += mm_3xtf32(a, g)
                ref[ky, kx] += a.astype(np.float64) @ g.astype(np.float64)
    plain, _ = tbraai.conv3x3_wgrad_plain(x, gy, saved, mask, keep, pool)
    e3, ep = _max_err(emu, ref), _max_err(plain.numpy(), ref)
    scale = float(np.abs(ref).max())
    assert scale > 0 and e3 <= 1e-4 * scale, (e3, scale)
    assert e3 <= 4 * ep, (e3, ep)
