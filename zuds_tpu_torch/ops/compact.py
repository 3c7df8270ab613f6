"""Fixed-capacity stream compaction (twin of ``compact_indices``,
``zuds_tpu/ops/detect.py:86-154``): hand kernel H6 (``kernels/compact.cu``)
on a CUDA tensor, :func:`compact_indices_plain` on a CPU tensor; and the
scatter back from a compact list."""
from __future__ import annotations

import torch

from ..kernels import launch

__all__ = ['compact_indices', 'compact_indices_plain', 'scatter_into']


def compact_indices_plain(mask, size, fill_value):
    """Plain version of H6: (int64 (size,) flat indices of the first
    ``size`` True entries of the flat bool ``mask``, ascending, padded with
    ``fill_value``; int64 () count of True entries)."""
    idx = torch.nonzero(mask).reshape(-1)[:size]
    out = torch.full((size,), fill_value, dtype=torch.int64,
                     device=mask.device)
    out[:idx.numel()] = idx
    return out, mask.sum()


def compact_indices(mask, size, fill_value):
    """(flat indices of the first ``size`` True entries of the flat bool
    ``mask``, ascending, padded with ``fill_value`` (detect.py:86); the
    number of True entries as a 0-d tensor). The host does not wait for
    the card."""
    if mask.is_cuda:
        return launch.compact(mask, size, fill_value)
    return compact_indices_plain(mask, size, fill_value)


def scatter_into(n, idx, ok, vals, fill):
    """``out = full(n, fill); out[idx] = vals`` for the ``ok`` entries only:
    the rest land in a discard slot, so no two writes share an index."""
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    out[torch.where(ok, idx, n)] = vals
    return out[:n]
