"""The benchmark of lte_cell_scanner_tpu_torch (see run.py)."""
