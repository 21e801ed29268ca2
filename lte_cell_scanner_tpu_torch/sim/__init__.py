"""Synthetic eNodeB downlink generator and channel impairments."""

from .channel import (ClockResampler, apply_coupled_offset,
                      apply_freq_offset, awgn, multipath_channel)
from .dl_sig import create_dl_sig

__all__ = ["ClockResampler", "apply_coupled_offset", "apply_freq_offset", "awgn",
           "create_dl_sig", "multipath_channel"]
