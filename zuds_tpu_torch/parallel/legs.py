"""The data-parallel legs of a multi-rank run, the port's counterpart of
the reference's multi-device dry run (``__graft_entry__.py:87-210``).

Each leg is a function ``(rank, world, ...)`` for
:func:`zuds_tpu_torch.parallel.mesh.spawn_ranks` (or one rank of a
``torchrun`` or slurm launch after ``init_distributed``): it lays the
ranks out with ``quadrant_mesh``, makes its inputs from a seed, runs on
``device`` and returns a dict with rank 0's gathered result (``None`` on
the other ranks, as CPU tensors), the rank's block, the host seconds of
the run and the kernel launches the rank counted in it. With ``warmup``
the leg runs once before the counted run (a fresh process's first calls
set up cuBLAS, cuSOLVER and the allocator), on a copy of its state.

- :func:`subtract_leg`: ``SubtractDetectPipeline`` over 'data' on
  ``inputs.synth_inputs`` with three planted sources (seed s plants with
  seed s + 1, as ``chip_smoke.py``'s slice does), each rank uploading
  only its block (``place_batch``).
- :func:`coadd_leg`: ``CoaddPipeline`` with its rows over 'space' (all
  the ranks) on ``inputs.coadd_inputs``.
- :func:`train_leg`: one braai ``train_step`` over the whole mesh, each
  rank uploading only its block of the batch.

:func:`run_legs` runs several of them in one set of ranks, which then
start once.
"""
from __future__ import annotations

import time

import torch

from .mesh import gather_batch, place_batch, quadrant_mesh

__all__ = ['subtract_leg', 'coadd_leg', 'train_leg', 'run_legs', 'LEGS']


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def _timed(device, fn):
    """(fn(), host seconds, launches) with every kernel count set to 0
    just before."""
    from ..kernels import all_wrappers
    wrappers = all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    secs = time.perf_counter() - t0
    return out, secs, {k: w.launches for k, w in wrappers.items()}


def _cpu(out):
    return {k: v.detach().cpu() for k, v in out.items()}


def subtract_leg(rank, world, cfg, B, seed, device, warmup=False):
    """The batch over 'data'; ``secs`` the rank's frames, ``gather_secs``
    the gather of the global batch, ``frames`` the rank's frames."""
    from .. import inputs
    from .pipeline import SubtractDetectPipeline
    mesh = quadrant_mesh(devices=device)
    args, _ = inputs.plant_sources(
        inputs.synth_inputs(B, cfg.height, cfg.width, cfg, seed=seed),
        n=3, flux=2e4, seed=seed + 1)
    targs = place_batch(mesh, *inputs.to_torch(args, 'cpu'), device=device)
    pipe = SubtractDetectPipeline(cfg, mesh=mesh)
    if warmup:
        gather_batch(mesh, pipe(*targs))
    block, secs, launches = _timed(device, lambda: pipe(*targs))
    out, gather_secs, _ = _timed(device, lambda: gather_batch(mesh, block))
    return {'out': _cpu(out) if rank == 0 else None,
            'frames': place_batch(mesh, torch.arange(B), device=device)
            .to_local().tolist(),
            'secs': secs, 'gather_secs': gather_secs, 'launches': launches}


def coadd_leg(rank, world, cfg, N, seed, device, subtract_back=True,
              warmup=False):
    from .. import inputs
    from .pipeline import CoaddPipeline
    mesh = quadrant_mesh(n_space=world, devices=device)
    args = inputs.to_torch(inputs.coadd_inputs(
        N, cfg.height, cfg.width, cfg.map_step, seed=seed), device)
    pipe = CoaddPipeline(cfg, subtract_back=subtract_back, mesh=mesh)
    if warmup:
        pipe(*args)
    out, secs, launches = _timed(device, lambda: pipe(*args))
    return {'out': _cpu(out) if rank == 0 else None, 'secs': secs,
            'launches': launches}


def train_leg(rank, world, triplets, labels, masks, device, params=None,
              seed=0, warmup=False):
    """One step from ``params`` (a flax-form tree of numpy arrays) or the
    port's init of ``seed``, with ``masks`` (numpy, the global batch's)
    or masks drawn from ``seed``; optax's zero state."""
    from ..models import adam, braai
    mesh = quadrant_mesh(devices=device)

    def state():
        if params is None:
            _, p, _, st = braai.make_train_state(seed, device=device)
            return p, st
        p = adam.flat_tree(braai.params_from_flax(params), device)
        return p, adam.Adam(braai.TRAIN_LR).init(p)

    x, y = place_batch(mesh, triplets, labels, device=device, space_dim=0)
    if warmup:
        braai.train_step(*state(), x, y, seed, masks=masks, mesh=mesh)
    p, st = state()
    (p, st, loss), secs, launches = _timed(device, lambda: braai.train_step(
        p, st, x, y, seed, masks=masks, mesh=mesh))
    out = {'params': p.flat, 'mu': st['mu'].flat, 'nu': st['nu'].flat,
           'count': st['count'], 'loss': loss}
    return {'out': _cpu(out) if rank == 0 else None, 'secs': secs,
            'launches': launches}


LEGS = {'subtract': subtract_leg, 'coadd': coadd_leg, 'train': train_leg}


def run_legs(rank, world, specs):
    """The legs of ``specs``, a list of ``(name, args, kwargs)`` with a
    name of :data:`LEGS`, in order; returns their results."""
    return [LEGS[name](rank, world, *args, **kwargs)
            for name, args, kwargs in specs]
