"""Numeric ops and CUDA kernels of the port (mirrors ``sheeprl_tpu/ops``)."""
