"""Work distribution across processes (twin of ``zuds_tpu/mpi.py``, whose
``rank_info`` asks JAX first): the same file-list split over slurm array
tasks and ranks, with the rank from ``torch.distributed`` when a process
group is up, else MPI (mpi4py) when launched under mpirun, else slurm's
environment, else a single process. ``barrier`` waits on the process group
when one is up, else on MPI's world when mpi4py is there, else returns."""
from __future__ import annotations

import os

import numpy as np

__all__ = ['get_my_share_of_work', 'get_nthreads', 'has_mpi', 'rank_info',
           'barrier']


def has_mpi():
    try:
        from mpi4py import MPI  # noqa
        return True
    except ImportError:
        return False


def _process_group():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def rank_info():
    """(rank, size) of this worker process."""
    dist = _process_group()
    if dist is not None:
        return dist.get_rank(), dist.get_world_size()
    if has_mpi():
        from mpi4py import MPI
        comm = MPI.COMM_WORLD
        return comm.Get_rank(), comm.Get_size()
    if 'SLURM_PROCID' in os.environ:
        return (int(os.environ['SLURM_PROCID']),
                int(os.environ.get('SLURM_NTASKS', 1)))
    return 0, 1


def barrier():
    """Wait for every rank (mpi.py:49-52)."""
    dist = _process_group()
    if dist is not None:
        dist.barrier()
    elif has_mpi():
        from mpi4py import MPI
        MPI.COMM_WORLD.Barrier()


def get_nthreads():
    """Threads available to this rank (mpi.py:55-60)."""
    from .constants import NTHREADS_PER_NODE
    if 'SLURM_CPUS_PER_TASK' in os.environ:
        return int(os.environ['SLURM_CPUS_PER_TASK'])
    return NTHREADS_PER_NODE


def get_my_share_of_work(fname, reader=None):
    """This rank's slice of the work list in ``fname``: the slurm array
    task's part (SLURM_ARRAY_TASK_ID over SLURM_ARRAY_TASK_MAX + 1), then
    this rank's part of that; the whole list in a single process."""
    if reader is None:
        def reader(f):
            with open(f) as fh:
                return np.asarray([line.strip() for line in fh
                                   if line.strip()])
    work = np.atleast_1d(reader(fname))

    array_id = os.getenv('SLURM_ARRAY_TASK_ID')
    if array_id is not None:
        ntask = int(os.environ.get('SLURM_ARRAY_TASK_MAX', 0)) + 1
        work = np.array_split(work, ntask)[int(array_id)]

    rank, size = rank_info()
    if size > 1:
        work = np.array_split(work, size)[rank]
    return work
