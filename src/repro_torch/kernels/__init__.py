"""CUDA kernels of the port (``csrc/``), their wrappers, plain versions and
dispatch."""
