"""Work distribution across processes (twin of ``zuds_tpu/mpi.py:36-86``,
whose ``rank_info`` asks JAX first): the same file-list split over slurm
array tasks and ranks, with the rank from ``torch.distributed`` when a
process group is up, else MPI (mpi4py) when launched under mpirun, else
slurm's environment, else a single process."""
from __future__ import annotations

import os

import numpy as np

__all__ = ['get_my_share_of_work', 'rank_info']


def rank_info():
    """(rank, size) of this worker process."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    try:
        from mpi4py import MPI
    except ImportError:
        MPI = None
    if MPI is not None:
        comm = MPI.COMM_WORLD
        return comm.Get_rank(), comm.Get_size()
    if 'SLURM_PROCID' in os.environ:
        return (int(os.environ['SLURM_PROCID']),
                int(os.environ.get('SLURM_NTASKS', 1)))
    return 0, 1


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
