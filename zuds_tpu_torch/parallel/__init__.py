"""Batched pipelines of the PyTorch port (twin of ``zuds_tpu/parallel``)."""
from .pipeline import (PipelineConfig, SubtractDetectPipeline,
                       prepare_frame_inputs)

__all__ = ['PipelineConfig', 'SubtractDetectPipeline', 'prepare_frame_inputs']
