"""Numeric substrate: DSP helpers, the exact correlation, and the CUDA
correlation-power kernels with their plain versions."""
