"""The port's twin of ``optax.adam`` (optax 0.2.6: ``scale_by_adam`` then
``scale_by_learning_rate``, applied by ``optax.apply_updates``), as
braai's ``train_step`` uses it (``zuds_tpu/models/braai.py:90-105``).

The state is ``{'count', 'mu', 'nu'}``: an int32 0-d count and two trees of
the parameters' shape, optax's ``ScaleByAdamState``. The parameters, their
gradients and the moments are each a :class:`FlatTree`, views of one flat
f32 buffer, so one pass of H21 (``kernels/adam.cu``) updates every
parameter in place. The update keeps optax's
order of operations, each rounded on its own:

    mu = (1 - b1) g + b1 mu,  nu = (1 - b2) (g g) + b2 nu,  count += 1
    u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    p = p + u (-lr)

with the powers in f32 on the count's device (XLA's ``pow`` of an f32 by
an int32 gives the same bits as PyTorch's on the CPU).
"""
from __future__ import annotations

import torch

from ..kernels import launch

__all__ = ['Adam', 'FlatTree', 'adam_update_plain', 'bias_corrections',
           'flat_buffer', 'flat_tree', 'views_like', 'B1', 'B2', 'EPS']

# optax.adam's defaults
B1, B2, EPS = 0.9, 0.999, 1e-8


def _leaves(tree):
    """The tensors of a nested dict, in insertion order, with their paths."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def _rebuild(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return next(it)

    return walk(tree)


class FlatTree(dict):
    """A tree of the parameters' structure (nested dicts of f32 tensors)
    whose leaves are consecutive views of the one 1-D buffer ``flat``, in
    the tree's order: one pass over ``flat`` updates every leaf. The
    training step and :class:`Adam` take only such trees, made by
    :func:`flat_tree` (or ``make_train_state``, :meth:`Adam.init`,
    ``opt_state_from_optax``)."""

    def __init__(self, flat, tree):
        super().__init__(tree)
        self.flat = flat


def flat_tree(tree, device=None):
    """A :class:`FlatTree` on ``device`` (the card unless ``'cpu'``)
    holding a copy of the leaves of ``tree`` (tensors or arrays, e.g.
    ``params_from_flax``'s), the tree left as it is."""
    from ..inputs import resolve_device
    device = resolve_device(device)
    parts = [torch.as_tensor(t).detach().to(device, torch.float32).reshape(-1)
             for _, t in _leaves(tree)]
    if not parts:
        raise ValueError('flat_tree: the tree has no leaves')
    return views_like(torch.cat(parts), tree)


def views_like(flat, tree):
    """A :class:`FlatTree` of the structure and leaf shapes of ``tree``
    whose leaves are consecutive views of the 1-D ``flat``."""
    leaves, off = [], 0
    for _, t in _leaves(tree):
        n = int(torch.Size(tuple(t.shape)).numel())
        leaves.append(flat[off:off + n].view(tuple(t.shape)))
        off += n
    if off != flat.numel():
        raise ValueError(f'views_like: the tree holds {off} values, the '
                         f'buffer {flat.numel()}')
    return FlatTree(flat, _rebuild(tree, leaves))


def flat_buffer(tree, what, device=None):
    """The buffer of the :class:`FlatTree` ``tree``; raises TypeError for
    any other tree, and ValueError where ``device`` is given and the
    buffer lies elsewhere (nothing is copied)."""
    if not isinstance(tree, FlatTree):
        raise TypeError(f'{what} is not a FlatTree: make one with '
                        'flat_tree(tree, device)')
    if device is not None and tree.flat.device != device:
        raise ValueError(f'{what} lies on {tree.flat.device}, the '
                         f'parameters on {device}')
    return tree.flat


def bias_corrections(count, b1=B1, b2=B2):
    """(1 - b1^count, 1 - b2^count) as f32 0-d tensors on ``count``'s
    device (optax's ``tree_bias_correction``)."""
    c = count.to(torch.int32)
    one = torch.ones((), dtype=torch.float32, device=c.device)

    def corr(b):
        return one - torch.full((), b, dtype=torch.float32,
                                device=c.device) ** c

    return corr(b1), corr(b2)


def _sqrt(x):
    """The correctly rounded f32 root: the CPU build's vectorised ``sqrt``
    may be an ulp off it; a root taken in double and rounded once to f32 is
    the f32 root (53 >= 2 x 24 + 2 bits), on every device."""
    return torch.sqrt(x.double()).float()


def adam_update_plain(p, g, mu, nu, bc1, bc2, lr, b1=B1, b2=B2, eps=EPS):
    """Plain version of H21: the new (p, mu, nu) of one Adam step from the
    gradient ``g`` and the bias corrections ``bc1``, ``bc2`` (f32 0-d
    tensors on the device of ``p``), every operation rounded on its own in
    optax's order. The divisors are tensors on the device (a CUDA division
    by a Python number multiplies by its reciprocal)."""
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * (g * g) + b2 * nu
    u = (mu / bc1) / (_sqrt(nu / bc2) + eps)
    return p + u * -lr, mu, nu


class Adam:
    """``optax.adam(lr)`` with b1 0.9, b2 0.999, eps 1e-8, eps_root 0."""

    def __init__(self, lr=3e-4, b1=B1, b2=B2, eps=EPS):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params):
        """The zero state of the :class:`FlatTree` ``params``: count 0, and
        ``mu``, ``nu`` zero :class:`FlatTree` s on the parameters'
        device."""
        flat = flat_buffer(params, 'Adam.init: params')
        return {'count': torch.zeros((), dtype=torch.int32,
                                     device=flat.device),
                'mu': views_like(torch.zeros_like(flat), params),
                'nu': views_like(torch.zeros_like(flat), params)}

    def update(self, grads, state, params, plain=False):
        """One step: (params, state) after ``grads``, computed by H21 where
        the parameters lie on the card and by :func:`adam_update_plain` on
        the CPU (or anywhere with ``plain``). Unlike optax's ``update``,
        the step is applied, in place: ``params``, ``grads`` and the
        moments are :class:`FlatTree` s on one device (TypeError or
        ValueError otherwise, before anything is written), and the same
        trees come back with the count's successor."""
        p = flat_buffer(params, 'Adam.update: params')
        dev = p.device
        g = flat_buffer(grads, 'Adam.update: grads', dev)
        mu = flat_buffer(state['mu'], 'Adam.update: mu', dev)
        nu = flat_buffer(state['nu'], 'Adam.update: nu', dev)
        count = state['count']
        if not torch.is_tensor(count) or count.device != dev:
            raise ValueError('Adam.update: the count is not a tensor on '
                             f'the parameters\' device {dev}')
        if not p.shape == g.shape == mu.shape == nu.shape:
            raise ValueError('Adam.update: the parameters, gradients and '
                             'moments differ in size')
        count = count.to(torch.int32) + 1
        bc1, bc2 = bias_corrections(count, self.b1, self.b2)
        if p.is_cuda and not plain:
            launch.adam_step(p, g, mu, nu, bc1, bc2, self.lr, self.b1,
                             self.b2, self.eps)
        else:
            new = adam_update_plain(p, g, mu, nu, bc1, bc2, self.lr, self.b1,
                                    self.b2, self.eps)
            for buf, val in zip((p, mu, nu), new):
                buf.copy_(val)
        return params, {'count': count, 'mu': state['mu'],
                        'nu': state['nu']}
