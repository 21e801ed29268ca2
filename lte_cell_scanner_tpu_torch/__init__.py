"""LTE cell scanner on PyTorch and CUDA.

The counterpart of ``lte_cell_scanner_tpu`` for NVIDIA Hopper GPUs: the
same module layout, plain PyTorch for the tensor code, and hand-written
CUDA kernels (``csrc/``) where the TPU package used Pallas.  Entry points
take a ``device`` argument; ``None`` means ``"cuda"``.  On the CPU the
port keeps complex128/float64 so it can be held against the TPU package
at the reference tolerances.
"""

from .cell import Cell, CpType, PhichDuration, PhichResource

__all__ = ["Cell", "CpType", "PhichDuration", "PhichResource"]
