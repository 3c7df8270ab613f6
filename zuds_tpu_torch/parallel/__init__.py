"""Batched pipelines of the PyTorch port and their data parallelism over
ranks (twin of ``zuds_tpu/parallel``)."""
from .mesh import (batch_sharding, gather_batch, init_distributed,
                   local_batch, place_batch, quadrant_mesh, shard_batch)
from .pipeline import (CoaddPipeline, PipelineConfig, SubtractDetectPipeline,
                       prepare_epoch_inputs, prepare_frame_inputs)

__all__ = ['quadrant_mesh', 'batch_sharding', 'shard_batch', 'place_batch',
           'local_batch', 'gather_batch', 'init_distributed', 'PipelineConfig', 'SubtractDetectPipeline',
           'prepare_frame_inputs', 'CoaddPipeline', 'prepare_epoch_inputs']
