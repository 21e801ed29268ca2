"""Synthetic captures with known truth for end-to-end checks.

``two_cell_capture`` models the reference's two-cell air capture at
739 MHz (cells 277 and 271, both 2 ports, normal CP, decoded at about
+35 kHz): cell 277 (n_id_1 92, n_id_2 1) plus cell 271 (n_id_1 90,
n_id_2 1) 3 dB weaker and delayed, through one dongle-crystal channel
(carrier offset with the coupled sample-clock offset) and AWGN.
``adc_quantize`` puts a capture on the 8-bit dongle grid.
``band_captures`` lays that capture on three carriers of a 10 MHz band
of 101 carriers and noise on the rest.
"""

from __future__ import annotations

import numpy as np

from ..cell import CpType
from ..constants import CAPLENGTH, FS_WORK
from .channel import apply_coupled_offset, awgn
from .dl_sig import create_dl_sig

# leading slots generated for the delayed cell: 2 subframes, so its
# frame boundary can sit up to 3840 samples into the capture
_LEAD_SLOTS = 4
_LEAD = int(_LEAD_SLOTS * 0.0005 * FS_WORK)

TWO_CELL_TRUTH = {277: {"n_ports": 2, "sfn": 0},
                  271: {"n_ports": 2, "sfn": 100}}
# cell 271's frame boundary (samples into the capture, at most _LEAD),
# its level against cell 277, and the AWGN SNR
DELAY_271 = 3000
REL_DB_271 = -3.0
SNR_DB = 10.0
# ADC code the capture's largest |Re| or |Im| maps to (no clipping)
ADC_PEAK_CODE = 100.0


# the band: 101 carriers on the 100 kHz raster, 739.0-749.0 MHz (a 10
# MHz LTE band, the widest the standard has); the two-cell capture on the
# first, middle and last carriers, where the middle carrier's shared fold
# table is furthest off for the edge ones
BAND_FCS = 739.0e6 + 100e3 * np.arange(101)
BAND_CELL_CARRIERS = (0, 50, 100)
# the two-cell capture's crystal error: 35 kHz at 739 MHz (~47.4 ppm)
BAND_PPM = 35e3 / 739e6 * 1e6


def band_offset(fc: float) -> float:
    """The carrier offset the band's crystal error puts on carrier fc."""
    return BAND_PPM * 1e-6 * fc


def _two_cell_signal(rng: np.random.Generator, f_off: float,
                     fc: float) -> np.ndarray:
    n_ms = int(np.ceil(CAPLENGTH / FS_WORK * 1e3))
    a = create_dl_sig(CpType.NORMAL, n_ms, 0, 92, 1, 0.5, rng=rng,
                      n_ports=2, sfn=TWO_CELL_TRUTH[277]["sfn"])
    b = create_dl_sig(CpType.NORMAL, n_ms + _LEAD_SLOTS // 2, 20 - _LEAD_SLOTS,
                      90, 1, 0.5, rng=rng, n_ports=2,
                      sfn=TWO_CELL_TRUTH[271]["sfn"] - 1)
    b = b[_LEAD - DELAY_271: _LEAD - DELAY_271 + CAPLENGTH]
    sig = a[:CAPLENGTH] + b * 10.0 ** (REL_DB_271 / 20.0)
    return apply_coupled_offset(sig, f_off, fc)


def two_cell_capture(seed: int = 0, f_off: float = 35e3,
                     fc: float = 739e6) -> np.ndarray:
    """Cell 277 (SFN 0 at sample 0) + cell 271 (frame 100 starting at
    sample DELAY_271) at REL_DB_271, received by a dongle at ``fc`` whose
    crystal puts the carrier ``f_off`` Hz off (and its sampler off in
    proportion), AWGN at SNR_DB; CAPLENGTH samples.  Decoded SFNs are the
    frame where the grid locks: the truth's SFN or the next one."""
    rng = np.random.default_rng(seed)
    return awgn(_two_cell_signal(rng, f_off, fc), SNR_DB, rng=rng)


def band_captures():
    """A 10 MHz band as (float band, ADC-grid band): two lists of
    (capbuf, fc, fc) over BAND_FCS.  The carriers of BAND_CELL_CARRIERS
    hold the two-cell capture (seed 1 + j for the j-th) with the crystal
    offset band_offset(fc); every other carrier holds AWGN alone (seed 0),
    at the noise power of the first cell carrier.  The ADC-grid band is
    each capture through adc_quantize."""
    noise_rng = np.random.default_rng(0)
    cells = {}
    noise_power = None
    for j, k in enumerate(BAND_CELL_CARRIERS):
        rng = np.random.default_rng(1 + j)
        sig = _two_cell_signal(rng, band_offset(BAND_FCS[k]), BAND_FCS[k])
        if noise_power is None:
            noise_power = float(np.mean(np.abs(sig) ** 2)) \
                / 10.0 ** (SNR_DB / 10.0)
        cells[k] = awgn(sig, SNR_DB, rng=rng)
    band = []
    for k, fc in enumerate(BAND_FCS):
        cap = cells.get(k)
        if cap is None:
            cap = (noise_rng.normal(size=CAPLENGTH)
                   + 1j * noise_rng.normal(size=CAPLENGTH)) \
                * np.sqrt(noise_power / 2.0)
        band.append((cap, float(fc), float(fc)))
    return band, [(adc_quantize(c), fc, fcp) for c, fc, fcp in band]


def adc_quantize(capbuf: np.ndarray) -> np.ndarray:
    """Scale so the largest |Re| or |Im| maps to ADC_PEAK_CODE codes,
    then quantize to the dongle grid x -> (clip(round(128 x) + 127, 0,
    255) - 127) / 128."""
    c = np.asarray(capbuf)
    scale = ADC_PEAK_CODE / (128.0 * max(np.max(np.abs(c.real)),
                                         np.max(np.abs(c.imag))))

    def plane(p):
        k = np.clip(np.round(128.0 * p * scale) + 127.0, 0.0, 255.0)
        return (k - 127.0) / 128.0

    return plane(c.real) + 1j * plane(c.imag)
