"""Batched pipelines of the PyTorch port (twin of ``zuds_tpu/parallel``)."""
from .pipeline import PipelineConfig, SubtractDetectPipeline

__all__ = ['PipelineConfig', 'SubtractDetectPipeline']
