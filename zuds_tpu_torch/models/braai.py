"""The braai real/bogus CNN (twin of ``zuds_tpu/models/braai.py``): the d6
VGG of Duev et al. 2019 that scores 63x63x3 new/ref/sub triplets, and its
training step.

The four convolution layers run the hand kernel H13 (``kernels/braai.cu``:
3x3 VALID correlation, bias, ReLU, the 2x2 max pool fused into layers 2
and 4) on a CUDA tensor and their plain version (``F.conv2d``) on a CPU
tensor; the dense head is two ``torch.matmul`` in full fp32 (the package
turns TF32 off). Activations are NHWC as in flax, so the flatten before
``Dense_0`` takes (h, w, c) order. Dropout is the identity at inference.

Parameters are kept in flax's layout (HWIO convolution kernels, (in, out)
dense kernels) and read and written as the JAX package's npz, whose keys
are ``jax.tree_util.keystr`` paths such as ``['params']['Conv_0']['kernel']``.

Training (``make_train_state``, ``train_step``, braai.py:84-105): each
convolution layer is :class:`Conv3x3Fn`, whose forward is H13t (H13 that
also writes the pool's routing bytes and applies the dropout after the
pool) and whose backward is H19 (the input gradient, layers 2-4) and H20
(the weight and bias gradient); the dense head goes through autograd of
``torch.matmul``; the Adam step is H21 (``models/adam.py``). Dropout is
flax's ``select(mask, x / keep, 0)``, a division, with masks drawn per
step from a ``torch.Generator`` (not threefry's bits) or handed in.
Every entry point runs on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import launch
from .adam import Adam, flat_buffer, flat_tree, views_like

__all__ = ['BraaiD6', 'init_braai', 'load_braai', 'save_braai',
           'params_from_flax', 'rb_scores', 'conv3x3', 'conv3x3_plain',
           'conv3x3_train', 'conv3x3_train_plain', 'conv3x3_dgrad',
           'conv3x3_dgrad_plain', 'conv3x3_wgrad', 'conv3x3_wgrad_plain',
           'grad_z_plain', 'Conv3x3Fn', 'bce_loss', 'draw_masks',
           'dropout_shapes', 'make_train_state', 'train_step',
           'train_step_plain', 'opt_state_from_optax', 'opt_state_to_numpy',
           'TRIPLET_SHAPE']

TRIPLET_SHAPE = (63, 63, 3)
# flax's truncated normal keeps [-2, 2] standard deviations; this is the
# standard deviation of the unit normal so truncated
_TRUNC_STD = 0.87962566103423978


# the d6 net's widths (braai.py:30-31): two blocks of two convolutions,
# then a dense layer
FEATURES = (32, 64)
DENSE = 256
# dropout after each block's pool and after Dense_0 (braai.py:32-33), kept
# with probability 1 - rate, named after flax's modules
KEEP_CONV = 1 - 0.25
KEEP_DENSE = 1 - 0.5
# the reference's train_step builds optax.adam(3e-4) inside the step
# (braai.py:93): make_train_state's lr never reaches it
TRAIN_LR = 3e-4


def param_shapes():
    """Layer name -> kernel shape of the d6 net on 63x63x3 triplets (each
    bias is the kernel's last dimension)."""
    shapes, cin, side, i = {}, TRIPLET_SHAPE[-1], TRIPLET_SHAPE[0], 0
    for f in FEATURES:
        for _ in range(2):
            shapes[f'Conv_{i}'] = (3, 3, cin, f)
            cin, side, i = f, side - 2, i + 1
        side //= 2
    shapes['Dense_0'] = (side * side * cin, DENSE)
    shapes['Dense_1'] = (DENSE, 1)
    return shapes


def dropout_shapes(n):
    """Dropout name -> the shape of its mask for a batch of ``n``: after
    each block's pool, then after Dense_0."""
    shapes, side = {}, TRIPLET_SHAPE[0]
    for i, f in enumerate(FEATURES):
        side = (side - 4) // 2      # two VALID 3x3 convolutions, the pool
        shapes[f'Dropout_{i}'] = (n, side, side, f)
    shapes[f'Dropout_{len(FEATURES)}'] = (n, DENSE)
    return shapes


def _keep(name):
    return KEEP_DENSE if name == f'Dropout_{len(FEATURES)}' else KEEP_CONV


def _generator(rng, device):
    """``rng`` (a ``torch.Generator`` on ``device``) or a new generator on
    ``device`` seeded by the int ``rng``."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(int(rng))


def draw_masks(n, rng, device):
    """One step's dropout masks for a batch of ``n`` on ``device``: name ->
    bool tensor, True where kept (``uniform < keep``, flax's bernoulli),
    drawn from ``rng`` (a generator on ``device`` or an int seed) in the
    order Dropout_0, Dropout_1, Dropout_2."""
    gen = _generator(rng, device)
    return {name: torch.rand(shape, generator=gen, device=device)
            < _keep(name) for name, shape in dropout_shapes(n).items()}


def _div(x, keep):
    """``x / keep`` rounded as one division: on a card PyTorch multiplies
    by the reciprocal of a Python number, so the divisor is a tensor."""
    return x / torch.full((), keep, dtype=x.dtype, device=x.device)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous()


def conv3x3_plain(x, w, b, pool):
    """Plain version of H13: ``relu(conv3x3_valid(x, w) + b)`` on the NHWC
    batch ``x`` with the HWIO kernel ``w``, then with ``pool`` the 2x2/2
    max pool (floor), NHWC out."""
    y = torch.relu(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), b))
    if pool:
        y = F.max_pool2d(y, 2, 2)
    return _nhwc(y)


def conv3x3(x, w, b, pool):
    """One layer of :func:`conv3x3_plain`: H13 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.is_cuda:
        return launch.braai_conv3x3(x.contiguous(), w, b, pool)
    return conv3x3_plain(x, w, b, pool)


def conv3x3_train_plain(x, w, b, pool, mask=None, keep=1.0):
    """Plain version of H13t: (out, route). ``out`` is
    :func:`conv3x3_plain`'s, for a pooled layer with the dropout ``mask``
    (bool, the output's shape, or None) applied as ``mask ? v / keep :
    0``; ``route`` (u8, the output's shape; None unpooled) the index 0-3 of
    the first maximum of each 2x2 window in row-major order (max_pool2d's
    index), 255 where that maximum is <= 0."""
    z = torch.relu(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), b))
    if not pool:
        return _nhwc(z), None
    y, idx = F.max_pool2d(z, 2, 2, return_indices=True)
    wc = z.shape[-1]
    oy = torch.arange(y.shape[-2], device=y.device).view(-1, 1)
    ox = torch.arange(y.shape[-1], device=y.device)
    at = (idx // wc - 2 * oy) * 2 + idx % wc - 2 * ox
    route = _nhwc(torch.where(y > 0, at, 255).to(torch.uint8))
    y = _nhwc(y)
    if mask is not None:
        y = torch.where(mask, _div(y, keep), 0.0)
    return y, route


def conv3x3_train(x, w, b, pool, mask=None, keep=1.0):
    """:func:`conv3x3_train_plain`'s (out, route): H13t on a CUDA tensor,
    the plain version on a CPU tensor."""
    if x.is_cuda:
        return launch.braai_conv3x3_train(x.contiguous(), w, b, pool, mask,
                                          keep)
    return conv3x3_train_plain(x, w, b, pool, mask, keep)


def grad_z_plain(gy, saved, mask, keep, pool, conv_hw):
    """The gradient at a layer's convolution output (N, Hc, Wc, Cout) from
    the gradient ``gy`` of its output: through the dropout
    (``select(mask, gy / keep, 0)``), the pool's routing bytes ``saved``
    (the odd last row and column get 0) and the ReLU, as XLA's VJP of
    train_step forms it (selects and one division). For an unpooled layer
    ``saved`` is its output: ``gy`` where that is > 0."""
    if not pool:
        return torch.where(saved > 0, gy, 0.0)
    g = gy if mask is None else torch.where(mask, _div(gy, keep), 0.0)
    n, ho, wo, c = gy.shape
    gz = gy.new_zeros((n,) + tuple(conv_hw) + (c,))
    for dy in range(2):
        for dx in range(2):
            gz[:, dy:2 * ho:2, dx:2 * wo:2] = torch.where(
                saved == 2 * dy + dx, g, 0.0)
    return gz


def conv3x3_dgrad_plain(gy, w, saved, mask, keep, pool, in_shape):
    """Plain version of H19: the gradient of the layer's input (the NHWC
    ``in_shape``) from :func:`grad_z_plain` through
    ``torch.nn.grad.conv2d_input``."""
    n, h, wd, cin = in_shape
    gz = grad_z_plain(gy, saved, mask, keep, pool, (h - 2, wd - 2))
    gx = torch.nn.grad.conv2d_input((n, cin, h, wd), w.permute(3, 2, 0, 1),
                                    _nchw(gz))
    return _nhwc(gx)


def conv3x3_dgrad(gy, w, saved, mask, keep, pool, in_shape):
    """H19 on a CUDA tensor, :func:`conv3x3_dgrad_plain` on a CPU one."""
    if gy.is_cuda:
        return launch.braai_conv3x3_dgrad(gy.contiguous(), w.contiguous(),
                                          saved, mask, keep, pool, in_shape)
    return conv3x3_dgrad_plain(gy, w, saved, mask, keep, pool, in_shape)


def conv3x3_wgrad_plain(x, gy, saved, mask, keep, pool):
    """Plain version of H20: (gw HWIO, gb) of the layer from its input
    ``x`` and :func:`grad_z_plain` through ``torch.nn.grad.conv2d_weight``
    and a sum."""
    n, h, wd, cin = x.shape
    gz = grad_z_plain(gy, saved, mask, keep, pool, (h - 2, wd - 2))
    cout = gz.shape[-1]
    gw = torch.nn.grad.conv2d_weight(_nchw(x), (cout, cin, 3, 3), _nchw(gz))
    return gw.permute(2, 3, 1, 0).contiguous(), gz.sum((0, 1, 2))


def conv3x3_wgrad(x, gy, saved, mask, keep, pool):
    """H20 on a CUDA tensor, :func:`conv3x3_wgrad_plain` on a CPU one."""
    if x.is_cuda:
        return launch.braai_conv3x3_wgrad(x.contiguous(), gy.contiguous(),
                                          saved, mask, keep, pool)
    return conv3x3_wgrad_plain(x, gy, saved, mask, keep, pool)


class Conv3x3Fn(torch.autograd.Function):
    """One convolution layer in training: forward H13t (or its plain
    version), backward H19 for the input (skipped where the input needs no
    gradient, as the triplets of Conv_0) and H20 for the kernel and bias.
    It saves the layer's input and kernel, and the routing bytes and mask
    of a pooled layer or the output of an unpooled one.

    ``apply(x, w, b, pool, mask, keep, plain=False)``; ``plain`` runs every
    kernel's plain version, on any device."""

    @staticmethod
    def forward(ctx, x, w, b, pool, mask, keep, plain=False):
        fwd = conv3x3_train_plain if plain else conv3x3_train
        y, route = fwd(x, w, b, pool, mask, keep)
        ctx.pool, ctx.keep, ctx.plain = pool, keep, plain
        ctx.in_shape = tuple(x.shape)
        ctx.save_for_backward(x, w, route if pool else y, mask)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w, saved, mask = ctx.saved_tensors
        gy = gy.contiguous()
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            dgrad = conv3x3_dgrad_plain if ctx.plain else conv3x3_dgrad
            gx = dgrad(gy, w, saved, mask, ctx.keep, ctx.pool, ctx.in_shape)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            wgrad = conv3x3_wgrad_plain if ctx.plain else conv3x3_wgrad
            gw, gb = wgrad(x, gy, saved, mask, ctx.keep, ctx.pool)
        return gx, gw, gb, None, None, None, None


def _apply(layers, x, train=False, masks=None, plain=False):
    """The d6 net on the NHWC batch ``x`` with ``layers`` (name -> {'kernel',
    'bias'}); in training with the dropout ``masks`` (:func:`draw_masks`'
    form)."""
    for i in range(2 * len(FEATURES)):
        layer = layers[f'Conv_{i}']
        w, b, pool = layer['kernel'], layer['bias'], i % 2 == 1
        if train:
            mask = masks[f'Dropout_{i // 2}'] if pool else None
            x = Conv3x3Fn.apply(x, w, b, pool, mask,
                                KEEP_CONV if pool else 1.0, plain)
        else:
            x = (conv3x3_plain if plain else conv3x3)(x, w, b, pool)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ layers['Dense_0']['kernel'] + layers['Dense_0']['bias'])
    if train:
        x = torch.where(masks[f'Dropout_{len(FEATURES)}'],
                        _div(x, KEEP_DENSE), 0.0)
    x = x @ layers['Dense_1']['kernel'] + layers['Dense_1']['bias']
    return torch.sigmoid(x)[..., 0]


class BraaiD6(nn.Module):
    """VGG-6: 2 x [conv-conv-pool-dropout] + a dense head, sigmoid output
    (braai.py:27-49). ``forward`` takes NHWC (N, 63, 63, 3) and returns
    (N,) scores; the parameters are attributes named as flax's layers,
    each a dict of ``kernel`` and ``bias``."""

    def __init__(self):
        super().__init__()
        for name, shape in param_shapes().items():
            setattr(self, name, nn.ParameterDict({
                'kernel': nn.Parameter(torch.zeros(shape),
                                       requires_grad=False),
                'bias': nn.Parameter(torch.zeros(shape[-1]),
                                     requires_grad=False)}))

    def forward(self, x, train=False, rng=None, masks=None):
        """Scores of ``x``; with ``train`` the training forward (H13t and
        dropout) with ``masks`` (:func:`draw_masks`' form) or masks drawn
        from ``rng`` (a generator on ``x``'s device or an int seed)."""
        return _apply(self._layers(), x, train,
                      self._masks(x, train, rng, masks))

    def forward_plain(self, x, train=False, rng=None, masks=None):
        """The same scores with every layer's plain version, on any
        device."""
        return _apply(self._layers(), x, train,
                      self._masks(x, train, rng, masks), plain=True)

    def _masks(self, x, train, rng, masks):
        if not train or masks is not None:
            return masks
        if rng is None:
            raise ValueError('BraaiD6: the training forward needs rng or '
                             'masks for its dropout')
        return draw_masks(x.shape[0], rng, x.device)

    def _layers(self):
        return {name: dict(layer.items())
                for name, layer in self.named_children()}

    def params(self):
        """flax's parameter tree, ``{'params': {layer: {'kernel', 'bias'}}}``,
        of this model's tensors."""
        return {'params': {name: {k: t.data for k, t in layer.items()}
                           for name, layer in self.named_children()}}

    def load_params(self, params):
        """Copy a parameter tree (:func:`params_from_flax` form) in."""
        for name, layer in params_from_flax(params)['params'].items():
            for k, t in layer.items():
                getattr(self, name)[k].data.copy_(t)
        return self

    def bind_params(self, params):
        """Make this model's parameters the tensors of ``params`` (a tree
        on the model's device, such as a ``FlatTree``): no copy, so an
        update of the tree is an update of the model."""
        for name, layer in params['params'].items():
            for k, t in layer.items():
                getattr(self, name)[k].data = t
        return self


def _keystr(path):
    return ''.join(f"['{p}']" for p in path)


def params_from_flax(arrays):
    """The port's parameter tree (f32 CPU tensors) from the JAX package's
    parameters: either flax's nested ``{'params': {...}}`` of arrays, or
    the flat npz mapping keyed by ``['params']['Conv_0']['kernel']``.
    Raises on a missing key or a shape other than the d6 net's."""
    if 'params' in arrays and hasattr(arrays['params'], 'keys'):
        def get(name, k):
            return arrays['params'][name][k]
    else:
        def get(name, k):
            return arrays[_keystr(('params', name, k))]
    out = {}
    for name, shape in param_shapes().items():
        layer = {}
        for k, want in (('kernel', shape), ('bias', (shape[-1],))):
            try:
                a = get(name, k)
            except KeyError:
                raise KeyError(f'braai parameters: no {name} {k}') from None
            t = (a.detach().to('cpu', torch.float32) if torch.is_tensor(a)
                 else torch.as_tensor(np.array(a, np.float32)))
            if tuple(t.shape) != want:
                raise ValueError(f'braai parameters: {name} {k} has shape '
                                 f'{tuple(t.shape)}, expected {want}')
            layer[k] = t
        out[name] = layer
    return {'params': out}


def _device(device):
    from ..inputs import resolve_device
    return resolve_device(device)


def init_braai(seed=0, device=None):
    """(model, params) at flax's default initialisers: ``lecun_normal``
    kernels (a normal truncated to 2 standard deviations, scaled to
    variance 1 / fan_in) and zero biases, drawn on the CPU from a
    ``torch.Generator`` seeded by ``seed``, on ``device`` (the card unless
    ``'cpu'``). The values are not flax's (another generator); their
    distribution is, and they are the same on every device."""
    device = _device(device)
    gen = torch.Generator().manual_seed(int(seed))
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    model = BraaiD6()
    for name, shape in param_shapes().items():
        fan_in = math.prod(shape[:-1])
        u = lo + (hi - lo) * torch.rand(shape, generator=gen,
                                        dtype=torch.float64)
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        getattr(model, name)['kernel'].data.copy_(
            math.sqrt(2) * torch.erfinv(u) * std)
    model = model.to(device)
    return model, model.params()


def save_braai(params, path):
    """Write ``params`` (a tree or a :class:`BraaiD6`) as the JAX package's
    npz (braai.py:60-63)."""
    if isinstance(params, BraaiD6):
        params = params.params()
    arrays = {_keystr(('params', name, k)): t.detach().cpu().numpy()
              for name, layer in params_from_flax(params)['params'].items()
              for k, t in layer.items()}
    np.savez(path, **arrays)


def load_braai(path=None, seed=0, device=None):
    """(model, params) on ``device`` (the card unless ``'cpu'``): the npz at
    ``path`` if it exists, else the fresh init of ``seed``
    (braai.py:65-75; no pretrained weights ship)."""
    model, params = init_braai(seed, device)
    if path and os.path.exists(path):
        with np.load(path) as loaded:
            model.load_params(dict(loaded))
    return model, model.params()


def rb_scores(params_or_model, triplets, device=None):
    """(N,) real/bogus scores of the (N, 63, 63, 3) L2-normalised triplets
    (braai.py:78-81). A :class:`BraaiD6` scores where the caller put it; a
    parameter tree is put on ``device`` (the card unless ``'cpu'``). The
    triplets go to the model."""
    model = params_or_model
    if not isinstance(model, BraaiD6):
        model = BraaiD6().load_params(params_or_model).to(_device(device))
    dev = model.Conv_0['kernel'].device
    x = torch.as_tensor(triplets, dtype=torch.float32).to(dev)
    with torch.no_grad():
        return model(x)


def bce_loss(scores, labels):
    """The reference's loss (braai.py:96-100): the mean binary cross-entropy
    of ``scores`` clipped to [1e-7, 1 - 1e-7], in f32. The clip is
    ``jnp.clip``'s ``minimum(hi, maximum(lo, s))``, whose gradient splits a
    tie in half as JAX's does (0 outside the interval, 1/2 on its edges)."""
    labels = torch.as_tensor(labels).to(scores)
    lo = torch.full((), 1e-7, dtype=scores.dtype, device=scores.device)
    hi = torch.full((), 1 - 1e-7, dtype=scores.dtype, device=scores.device)
    s = torch.minimum(hi, torch.maximum(lo, scores))
    return -torch.mean(labels * torch.log(s) + (1 - labels) * torch.log(1 - s))


def make_train_state(seed=0, lr=3e-4, device=None):
    """(model, params, tx, opt_state) on ``device`` (the card unless
    ``'cpu'``), as braai.py:84-87: the init of ``seed``, its parameters as
    a ``FlatTree`` (bound to ``model``: training the tree trains the
    model), ``tx = Adam(lr)`` and its zero state. As in the reference,
    :func:`train_step` steps with lr 3e-4 whatever ``lr`` is."""
    device = _device(device)
    model, params = init_braai(seed, device)
    params = flat_tree(params, device)
    model.bind_params(params)
    tx = Adam(lr)
    return model, params, tx, tx.init(params)


def train_step(params, opt_state, triplets, labels, rng, masks=None):
    """One BCE training step with Adam (braai.py:90-105): (params,
    opt_state, loss). The forward and backward run H13t, H19 and H20 on the
    card (the dense head through autograd of ``torch.matmul``), the update
    H21, all on the device where the parameters lie.

    The step updates IN PLACE on that device. ``params`` and the moments
    of ``opt_state`` are ``FlatTree`` s, views of flat buffers, as
    ``make_train_state``, ``opt_state_from_optax`` and an earlier step
    give them; their buffers are overwritten and the same trees come
    back. Any other tree (a ``params_from_flax`` tree, numpy arrays) is
    refused with a TypeError: ``flat_tree(tree, device)`` makes a
    ``FlatTree`` of it, on the card unless ``device='cpu'``. Moments on
    another device than the parameters raise a ValueError; nothing is
    copied. As in the reference, the step uses Adam at lr 3e-4, not the
    lr of ``make_train_state`` (ROADMAP section 3).

    ``triplets`` (N, 63, 63, 3) and ``labels`` (N,) in 0/1 go to the
    parameters' device. ``rng``: a ``torch.Generator`` on that device or an
    int seed, from which one step's dropout masks are drawn
    (:func:`draw_masks`); ``masks`` hands in given ones instead (name ->
    bool tensor), as the tests feed flax's."""
    return _step(params, opt_state, triplets, labels, rng, masks, False)


def train_step_plain(params, opt_state, triplets, labels, rng, masks=None):
    """:func:`train_step` with every kernel's plain version (the layers'
    and Adam's), on any device."""
    return _step(params, opt_state, triplets, labels, rng, masks, True)


def _step(params, opt_state, triplets, labels, rng, masks, plain):
    flat = flat_buffer(params, 'train_step: params')
    dev = flat.device
    x = torch.as_tensor(triplets, dtype=torch.float32).to(dev).contiguous()
    y = torch.as_tensor(labels, dtype=torch.float32).to(dev)
    if masks is None:
        masks = draw_masks(x.shape[0], rng, dev)
    else:
        masks = {k: torch.as_tensor(v).to(dev, torch.bool).contiguous()
                 for k, v in masks.items()}
    grads = views_like(torch.zeros_like(flat), params)
    layers = {}
    for name, layer in params['params'].items():
        layers[name] = {}
        for k, t in layer.items():
            leaf = t.detach().requires_grad_()
            leaf.grad = grads['params'][name][k]    # backward adds into it
            layers[name][k] = leaf
    with torch.enable_grad():
        loss = bce_loss(_apply(layers, x, True, masks, plain), y)
        loss.backward()
    params, opt_state = Adam(TRAIN_LR).update(grads, opt_state, params,
                                              plain)
    return params, opt_state, loss.detach()


def opt_state_from_optax(state, device=None):
    """The port's Adam state on ``device`` (the card unless ``'cpu'``) from
    optax's: ``(ScaleByAdamState(count, mu, nu), EmptyState())`` as
    ``optax.adam(...).init`` or ``update`` gives it, the bare
    ``ScaleByAdamState``, or :func:`opt_state_to_numpy`'s (count, mu, nu);
    arrays as numpy (or anything ``np.asarray`` reads), the moments in
    flax's tree."""
    if len(state) == 2:
        state = state[0]
    count, mu, nu = state
    dev = _device(device)
    return {'count': torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                                  device=dev),
            'mu': flat_tree(params_from_flax(mu), dev),
            'nu': flat_tree(params_from_flax(nu), dev)}


def opt_state_to_numpy(state):
    """(count, mu, nu) of the port's Adam state as numpy copies: an int32
    scalar and the moments in flax's tree, the fields of optax's
    ``ScaleByAdamState`` (``ScaleByAdamState(*opt_state_to_numpy(s))``)."""
    def tree(t):
        return {'params': {name: {k: np.array(v.detach().cpu())
                                  for k, v in layer.items()}
                           for name, layer in params_from_flax(t)['params']
                           .items()}}

    return (np.int32(int(state['count'])), tree(state['mu']),
            tree(state['nu']))
