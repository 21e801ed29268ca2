"""E4000 tuner PLL frequency model.

Behavioral contract: reference compute_fc_programmed
(reference src/from_osmocom.cpp:113-166, integer VCO arithmetic from
osmocom): the tuner cannot hit an arbitrary LO; the actually-programmed
frequency is quantized by the R-divider and the 16-bit fractional-N
synthesizer.  The scanner needs the *actual* LO to model the k_factor
correctly (used at reference capbuf.cpp:134-149, including the +58 Hz
empirical fudge).
"""

from __future__ import annotations

# (upper frequency bound in Hz, three-phase bit << 3 | index, R divider)
_PLL_VARS = (
    (72_400_000, (1 << 3) | 7, 48),
    (81_200_000, (1 << 3) | 6, 40),
    (108_300_000, (1 << 3) | 5, 32),
    (162_500_000, (1 << 3) | 4, 24),
    (216_600_000, (1 << 3) | 3, 16),
    (325_000_000, (1 << 3) | 2, 12),
    (350_000_000, (1 << 3) | 1, 8),
    (432_000_000, (0 << 3) | 3, 8),
    (667_000_000, (0 << 3) | 2, 6),
    (1_200_000_000, (0 << 3) | 1, 4),
)

_PLL_Y = 65536


def compute_fc_programmed(fosc: float, intended_flo: float) -> float:
    """Actually-programmed E4000 LO for an intended LO (integer PLL math)."""
    r = 2
    for freq, _reg, mult in _PLL_VARS:
        if intended_flo < freq:
            r = mult
            break

    fosc_i = int(fosc)
    intended_fvco = int(intended_flo) * r
    z = intended_fvco // fosc_i
    remainder = intended_fvco - fosc_i * z
    x = (remainder * _PLL_Y) // fosc_i
    fvco = fosc_i * z + (fosc_i * x) // _PLL_Y
    return float(fvco // r)


def fc_programmed_with_fudge(fc_requested: float,
                             fosc: float = 28.8e6) -> float:
    """Tuned frequency including the reference's +58 Hz drift-taming fudge
    (capbuf.cpp:143)."""
    return compute_fc_programmed(fosc, fc_requested) + 58.0
