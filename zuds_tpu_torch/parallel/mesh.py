"""Process mesh and data parallelism over ranks (twin of
``zuds_tpu/parallel/mesh.py``).

The reference shards a batch of quadrants over a JAX mesh of devices with
the axes ``('data', 'space')``: ``data`` carries independent quadrants,
``space`` optionally splits image rows. The port runs one process per rank
under ``torch.distributed`` and lays the ranks out on a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names.
Rank r over ``data`` holds the contiguous frames ``[r B/n, (r+1) B/n)``
of a batch of B, the split of the reference's ``P('data')``.

Where the reference exports ``P`` and ``NamedSharding``, the port exports
:func:`batch_sharding`, which returns the ``torch.distributed.tensor``
placements (``Shard``, ``Replicate``) of the same layout, one per mesh
axis. Where the reference places a host batch with ``jax.device_put(x,
NamedSharding(mesh, P('data')))``, :func:`place_batch` makes it a
``DTensor`` of those placements of which each rank uploads only its own
block; the data-parallel entry points take such a batch
(:func:`local_batch`).

The collectives run over NCCL on the card and over gloo when the caller
asks for the CPU. Gloo may also serve CUDA tensors (several ranks that
share one card, where NCCL refuses two ranks on one device): every
collective of this module on a gloo group copies a CUDA tensor to the
host, runs there and copies the result back (:func:`all_gather`,
:func:`all_reduce_`). That copy is the only path a CUDA tensor takes
through gloo here; nothing else falls back to the host.
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

__all__ = ['quadrant_mesh', 'batch_sharding', 'shard_batch', 'place_batch',
           'local_batch', 'gather_batch', 'init_distributed', 'all_gather', 'all_reduce_', 'axis_index',
           'axis_size', 'block_bounds', 'spawn_ranks', 'AXES']

AXES = ('data', 'space')


def _device_type(devices):
    if devices is None:
        return 'cuda'
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices).type
    return torch.device(devices[0]).type


def init_distributed(device=None):
    """Bring up the process group of a multi-process run (mesh.py:54-60)
    and return ``(rank, world)``: from slurm's environment when
    ``SLURM_NTASKS`` > 1 (``SLURM_PROCID``, ``SLURM_LOCALID``), else from
    ``torchrun``'s (``WORLD_SIZE`` > 1, ``RANK``, ``LOCAL_RANK``), with the
    rendezvous at ``MASTER_ADDR``:``MASTER_PORT`` (slurm: the launch
    node's address and port 29500 when they are unset). On the card
    (``device`` None or CUDA) the group runs NCCL and the process is pinned
    to ``torch.cuda.set_device(local_rank)``; with ``device='cpu'`` it
    runs gloo. A single process, or a group already up, is left as it is.
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if int(env.get('SLURM_NTASKS', 1)) > 1:
        rank, world = int(env['SLURM_PROCID']), int(env['SLURM_NTASKS'])
        local = int(env.get('SLURM_LOCALID', 0))
        env.setdefault('MASTER_ADDR',
                       env.get('SLURM_LAUNCH_NODE_IPADDR', 'localhost'))
        env.setdefault('MASTER_PORT', '29500')
    elif int(env.get('WORLD_SIZE', 1)) > 1:
        rank, world = int(env['RANK']), int(env['WORLD_SIZE'])
        local = int(env.get('LOCAL_RANK', 0))
    else:
        return 0, 1
    card = _device_type(device) == 'cuda'
    if card:
        torch.cuda.set_device(local)
    dist.init_process_group('nccl' if card else 'gloo', init_method='env://',
                            rank=rank, world_size=world)
    return rank, world


def quadrant_mesh(n_data=None, n_space=1, devices=None):
    """A ``DeviceMesh`` with the axes ``('data', 'space')`` over the ranks
    of the process group (mesh.py:21-29): ``n_data`` defaults to the world
    size over ``n_space``, and ``n_data * n_space`` must equal it.
    ``devices``: the device type, the card (``'cuda'``, the default) or
    ``'cpu'``, or a list of one device per rank. Without a process group a
    group of one is brought up in this process, NCCL on the card and gloo
    on the CPU (no rendezvous: an in-process store)."""
    from torch.distributed.device_mesh import DeviceMesh
    dtype = _device_type(devices)
    if not dist.is_initialized():
        dist.init_process_group('nccl' if dtype == 'cuda' else 'gloo',
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if dtype == 'cuda':
        # one card a rank on the host (``init_distributed`` pins it; the
        # ranks of one spawn take rank mod the cards)
        torch.cuda.set_device(int(os.environ.get(
            'LOCAL_RANK', dist.get_rank() % torch.cuda.device_count())))
    if not isinstance(devices, (type(None), str, torch.device)):
        assert len(devices) == n, (len(devices), n)
    if n_data is None:
        n_data = n // n_space
    assert n_data * n_space == n, (n_data, n_space, n)
    return DeviceMesh(dtype, torch.arange(n).reshape(n_data, n_space),
                      mesh_dim_names=AXES)


def axis_size(mesh, axis):
    """The number of ranks along ``axis`` ('data' or 'space')."""
    return int(mesh.mesh.shape[AXES.index(axis)])


def axis_index(mesh, axis):
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_coordinate()[AXES.index(axis)])


def block_bounds(n, parts, index):
    """[lo, hi) of block ``index`` of ``parts`` contiguous blocks of ``n``,
    the first ``n % parts`` one longer (``np.array_split``'s rule)."""
    size, extra = divmod(n, parts)
    lo = index * size + min(index, extra)
    return lo, lo + size + (index < extra)


def batch_sharding(mesh, space_dim=None):
    """The placements of a (B, H, W) stack, one per mesh axis (mesh.py:
    32-41): the batch sharded over 'data' and, with ``space_dim``, that
    dimension over 'space', else replicated over it. Use them with
    ``torch.distributed.tensor.distribute_tensor(t, mesh, placements)``."""
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0), Replicate() if space_dim is None else Shard(space_dim))


def shard_batch(mesh, *arrays, space=False):
    """This rank's block of each (B, ...) array (mesh.py:44-51): frames
    ``[r B/n, (r+1) B/n)`` for coordinate r of n over 'data', the split of
    ``P('data')``, and with ``space`` the rows (dimension 1 of an array of
    3 or more dimensions) of its coordinate over 'space'. A batch that does
    not divide by the 'data' size raises ``ValueError``. Views, not
    copies."""
    nd, r = axis_size(mesh, 'data'), axis_index(mesh, 'data')
    ns, s = axis_size(mesh, 'space'), axis_index(mesh, 'space')
    out = []
    for a in arrays:
        B = a.shape[0]
        if B % nd:
            raise ValueError(f'a batch of {B} does not divide over the '
                             f"{nd} ranks of the mesh's 'data' axis")
        a = a[r * (B // nd):(r + 1) * (B // nd)]
        if space and a.ndim >= 3:
            lo, hi = block_bounds(a.shape[1], ns, s)
            a = a[:, lo:hi]
        out.append(a)
    return out if len(out) > 1 else out[0]


def _block(mesh, t, placements):
    """This rank's block of ``t`` under ``placements`` (even splits only:
    a dimension that does not divide raises ``ValueError``)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        n = int(mesh.mesh.shape[i])
        if not isinstance(p, Shard) or n == 1:
            continue
        size = t.shape[p.dim]
        if size % n:
            raise ValueError(f'a batch of {size} does not divide over the '
                             f'{n} ranks of the mesh\'s {AXES[i]!r} axis')
        t = t.narrow(p.dim, int(coord[i]) * (size // n), size // n)
    return t


def place_batch(mesh, *arrays, device=None, space_dim=None):
    """The global batch of each host array (numpy or a CPU tensor,
    leading dimension the batch) as a ``DTensor`` laid out by
    ``batch_sharding(mesh, space_dim)``, of which this rank copies only its
    own block to ``device`` (the card unless ``'cpu'``): the counterpart of
    the reference's ``jax.device_put(x, NamedSharding(mesh, P('data')))``.
    ``space_dim=0`` splits the batch over 'space' too (the reference's
    braai leg, ``P(('data', 'space'))``). Every split must be even, else
    ``ValueError``."""
    from torch.distributed.tensor import DTensor
    placements = batch_sharding(mesh, space_dim)
    device = torch.device('cuda' if device is None else device)
    out = [DTensor.from_local(
        _block(mesh, torch.as_tensor(a), placements).to(device).contiguous(),
        mesh, placements) for a in arrays]
    return out if len(out) > 1 else out[0]


def local_batch(mesh, *arrays, space_dim=None):
    """This rank's block of each array of a global batch laid out by
    ``batch_sharding(mesh, space_dim)``: a ``DTensor`` (:func:`place_batch`)
    gives its local block, with no copy; a plain tensor or numpy array is
    taken to hold the whole batch and is sliced (a view). A batch that does
    not divide, or a ``DTensor`` of other placements, raises
    ``ValueError``."""
    from torch.distributed.tensor import DTensor
    want = batch_sharding(mesh, space_dim)
    out = []
    for a in arrays:
        if isinstance(a, DTensor):
            if any(p != w for p, w, n in zip(a.placements, want,
                                             mesh.mesh.shape) if n > 1):
                raise ValueError(f'a batch placed as {a.placements}, not '
                                 f'{want}')
            t = a.to_local()
            if _block(mesh, torch.empty(a.shape, device='meta'),
                      want).shape != t.shape:
                raise ValueError(f'a block of {tuple(t.shape)} of a batch of '
                                 f'{tuple(a.shape)}')
            out.append(t)
        else:
            out.append(_block(mesh, torch.as_tensor(a), want))
    return out if len(out) > 1 else out[0]


def _via_host(t, group):
    return t.is_cuda and dist.get_backend(group) == 'gloo'


def _wire(t):
    # gloo has no bool: its bytes travel as uint8
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def all_gather(t, group):
    """The list of ``t`` from every rank of ``group``, in rank order, on
    ``t``'s device. A CUDA tensor on a gloo group goes through the host
    (see the module docstring). Every rank's ``t`` has one shape."""
    host = _via_host(t, group)
    src = _wire(t.cpu() if host else t)
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    if t.dtype == torch.bool:
        parts = [p.view(torch.bool) for p in parts]
    return [p.to(t.device) for p in parts] if host else parts


def all_reduce_(t, group, op=dist.ReduceOp.SUM):
    """Reduce ``t`` over ``group`` in place and return it. A CUDA tensor on
    a gloo group is reduced on the host and copied back."""
    if _via_host(t, group):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def gather_batch(mesh, out):
    """The global batch from each rank's block (a tensor or a dict of
    them, leading dimension the rank's frames): the blocks over 'data'
    concatenated in rank order, on every rank. Replicas over 'space' hold
    the same blocks and are not gathered."""
    group = mesh.get_group('data')
    if isinstance(out, dict):
        return {k: gather_batch(mesh, v) for k, v in out.items()}
    return torch.cat(all_gather(out, group))


def _rank_main(rank, fn, world, backend, rendezvous, outdir, args, threads):
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f'file://{rendezvous}',
                            rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(outdir, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world, args=(), backend='gloo', threads=None,
                timeout=None):
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method, so CUDA is safe in them) joined in one process
    group over ``backend``, rendezvous through a file in a temporary
    directory (no network). Returns the ranks' return values in rank
    order (each saved with ``torch.save``: tensors and plain containers).
    ``fn`` must be importable by name from a module; ``threads`` sets each
    rank's ``torch.set_num_threads`` (else PyTorch's default). Past
    ``timeout`` seconds the ranks are terminated and ``TimeoutError``
    raised; a rank that fails fails the call. Build the kernel
    library before starting ranks that use it, so that they load one
    build and do not race the compiler."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix='zuds-ranks-') as tmp:
        ctx = mp.start_processes(
            _rank_main, nprocs=world, start_method='spawn', join=False,
            args=(fn, world, backend, os.path.join(tmp, 'rendezvous'), tmp,
                  tuple(args), threads))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f'{world} ranks still running after '
                                   f'{timeout} s')
        return [torch.load(os.path.join(tmp, f'rank{r}.pt'),
                           weights_only=False) for r in range(world)]
