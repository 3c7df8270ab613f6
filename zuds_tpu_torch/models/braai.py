"""The braai real/bogus CNN's forward pass (twin of
``zuds_tpu/models/braai.py``): the d6 VGG of Duev et al. 2019 that scores
63x63x3 new/ref/sub triplets.

The four convolution layers run the hand kernel H13 (``kernels/braai.cu``:
3x3 VALID correlation, bias, ReLU, the 2x2 max pool fused into layers 2
and 4) on a CUDA tensor and their plain version (``F.conv2d``) on a CPU
tensor; the dense head is two ``torch.matmul`` in full fp32 (the package
turns TF32 off). Activations are NHWC as in flax, so the flatten before
``Dense_0`` takes (h, w, c) order. Dropout is the identity at inference.

Parameters are kept in flax's layout (HWIO convolution kernels, (in, out)
dense kernels) and read and written as the JAX package's npz, whose keys
are ``jax.tree_util.keystr`` paths such as ``['params']['Conv_0']['kernel']``.
Training (``make_train_state``, ``train_step``) is not ported.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import launch

__all__ = ['BraaiD6', 'init_braai', 'load_braai', 'save_braai',
           'params_from_flax', 'rb_scores', 'conv3x3', 'conv3x3_plain',
           'TRIPLET_SHAPE']

TRIPLET_SHAPE = (63, 63, 3)
# flax's truncated normal keeps [-2, 2] standard deviations; this is the
# standard deviation of the unit normal so truncated
_TRUNC_STD = 0.87962566103423978


# the d6 net's widths (braai.py:30-31): two blocks of two convolutions,
# then a dense layer
FEATURES = (32, 64)
DENSE = 256


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


def conv3x3_plain(x, w, b, pool):
    """Plain version of H13: ``relu(conv3x3_valid(x, w) + b)`` on the NHWC
    batch ``x`` with the HWIO kernel ``w``, then with ``pool`` the 2x2/2
    max pool (floor), NHWC out."""
    y = torch.relu(F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b))
    if pool:
        y = F.max_pool2d(y, 2, 2)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3(x, w, b, pool):
    """One layer of :func:`conv3x3_plain`: H13 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.is_cuda:
        return launch.braai_conv3x3(x.contiguous(), w, b, pool)
    return conv3x3_plain(x, w, b, pool)


class BraaiD6(nn.Module):
    """VGG-6: 2 x [conv-conv-pool] + a dense head, sigmoid output
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

    def forward(self, x):
        return self._layers(x, conv3x3)

    def forward_plain(self, x):
        """The same scores with every layer's plain version, on any
        device."""
        return self._layers(x, conv3x3_plain)

    def _layers(self, x, conv):
        for i in range(2 * len(FEATURES)):
            layer = getattr(self, f'Conv_{i}')
            x = conv(x, layer['kernel'], layer['bias'], pool=i % 2 == 1)
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(x @ self.Dense_0['kernel'] + self.Dense_0['bias'])
        x = x @ self.Dense_1['kernel'] + self.Dense_1['bias']
        return torch.sigmoid(x)[..., 0]

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


def init_braai(seed=0):
    """(model, params) at flax's default initialisers: ``lecun_normal``
    kernels (a normal truncated to 2 standard deviations, scaled to
    variance 1 / fan_in) and zero biases, drawn from a ``torch.Generator``
    seeded by ``seed``. The values are not flax's (another generator);
    their distribution is."""
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


def load_braai(path=None, seed=0):
    """(model, params): the npz at ``path`` if it exists, else the fresh
    init of ``seed`` (braai.py:65-75; no pretrained weights ship)."""
    model, params = init_braai(seed)
    if path and os.path.exists(path):
        with np.load(path) as loaded:
            model.load_params(dict(loaded))
    return model, model.params()


def rb_scores(params_or_model, triplets):
    """(N,) real/bogus scores of the (N, 63, 63, 3) L2-normalised triplets
    (braai.py:78-81), on the device of the model (or of the parameter
    tree's tensors); the triplets go there."""
    model = params_or_model
    if not isinstance(model, BraaiD6):
        tree = params_from_flax(params_or_model)
        dev = next(iter(params_or_model['params'].values()))['kernel']
        dev = dev.device if torch.is_tensor(dev) else torch.device('cpu')
        model = BraaiD6().load_params(tree).to(dev)
    dev = model.Conv_0['kernel'].device
    x = torch.as_tensor(triplets, dtype=torch.float32).to(dev)
    with torch.no_grad():
        return model(x)
