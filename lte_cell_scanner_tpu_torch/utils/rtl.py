"""Raw rtl_sdr-format IQ files: reading them, and the bytes of one.

Behavioral contract: reference itpp_ext::rtl_sdr_to_cvec
(reference src/itpp_ext.cpp:176-217): interleaved unsigned bytes,
value mapped as (x - 127) / 128 into I and Q.
"""

from __future__ import annotations

import numpy as np


def iq_u8_to_complex(raw: np.ndarray) -> np.ndarray:
    """Convert interleaved u8 IQ samples to complex128 on the unit scale."""
    raw = np.asarray(raw, dtype=np.uint8)
    n = raw.size // 2
    f = (raw[: 2 * n].astype(np.float64) - 127.0) / 128.0
    return f[0::2] + 1j * f[1::2]


def complex_to_iq_u8(capbuf: np.ndarray) -> np.ndarray:
    """Interleaved u8 IQ bytes of a capture: byte = clip(round(128 x) +
    127, 0, 255) per component, the inverse of iq_u8_to_complex on the
    8-bit ADC grid (a capture on that grid round-trips exactly through a
    file written with ``.tofile``)."""
    c = np.asarray(capbuf)
    planes = np.stack([c.real, c.imag], axis=-1).reshape(-1)
    return np.clip(np.round(128.0 * planes) + 127.0, 0, 255).astype(np.uint8)


def read_rtlsdr_file(path: str, drop_seconds: float = 0.0,
                     fs: float = 1.92e6) -> np.ndarray:
    """Read a raw rtl_sdr capture file into a complex vector.

    drop_seconds discards the initial AGC-settling portion, as the
    reference's --drop flag does (LTE-Tracker.cpp:540-559).
    """
    raw = np.fromfile(path, dtype=np.uint8)
    v = iq_u8_to_complex(raw)
    n_drop = int(round(drop_seconds * fs))
    return v[n_drop:]
