"""Device op layer of the PyTorch port (twin of ``zuds_tpu/ops``)."""
