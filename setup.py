from setuptools import setup, find_packages

setup(
    name='zuds-tpu',
    version='0.1.0',
    description='TPU-native transient-discovery image pipeline for ZTF',
    packages=find_packages(exclude=['tests', 'tests.*']),
    package_data={
        'zuds_tpu': ['config/*.yaml', 'alert_schemas/**/*.avsc'],
        # the port builds its CUDA kernels from these at first use
        'zuds_tpu_torch': ['kernels/*.cu', 'kernels/*.cuh'],
    },
    python_requires='>=3.10',
    install_requires=[
        'numpy',
        'jax',
        'flax',
        'optax',
        'pyyaml',
    ],
    # the PyTorch / CUDA port (zuds_tpu_torch); never a core requirement
    extras_require={'torch': ['torch']},
)
