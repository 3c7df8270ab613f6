"""Batched pipelines of the PyTorch port (twin of ``zuds_tpu/parallel``)."""
from .pipeline import (CoaddPipeline, PipelineConfig, SubtractDetectPipeline,
                       prepare_epoch_inputs, prepare_frame_inputs)

__all__ = ['PipelineConfig', 'SubtractDetectPipeline', 'prepare_frame_inputs',
           'CoaddPipeline', 'prepare_epoch_inputs']
