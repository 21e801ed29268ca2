"""Synthetic eNodeB downlink generator and channel impairments."""

from .channel import apply_freq_offset, awgn
from .dl_sig import create_dl_sig

__all__ = ["apply_freq_offset", "awgn", "create_dl_sig"]
