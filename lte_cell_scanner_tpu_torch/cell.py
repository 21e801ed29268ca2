"""Cell record: progressively-filled description of a detected LTE cell.

Mirrors the behavior of the reference ``Cell`` class
(reference include/common.h.in:101-129, src/common.cpp:29-56):
fields start as "unknown" (None here; -1/NaN in the reference) and are
filled in as the pipeline stages succeed (PSS -> SSS -> FOE -> MIB).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Optional


class CpType(enum.Enum):
    UNKNOWN = "unknown"
    NORMAL = "normal"
    EXTENDED = "extended"


class PhichDuration(enum.Enum):
    UNKNOWN = "unknown"
    NORMAL = "normal"
    EXTENDED = "extended"


class PhichResource(enum.Enum):
    UNKNOWN = "unknown"
    ONE_SIXTH = "1/6"
    HALF = "1/2"
    ONE = "one"
    TWO = "two"


@dataclass
class Cell:
    # Filled by peak_search (PSS detection)
    fc_requested: float = float("nan")
    fc_programmed: float = float("nan")
    pss_pow: float = float("nan")
    ind: int = -1                      # PSS peak lag within the half frame
    freq: float = float("nan")         # coarse frequency offset (hypothesis grid)
    n_id_2: int = -1

    # Filled by sss_detect
    n_id_1: int = -1
    cp_type: CpType = CpType.UNKNOWN
    frame_start: float = float("nan")  # fractional sample index of frame start

    # Filled by pss_sss_foe
    freq_fine: float = float("nan")

    # Filled by tfoec
    freq_superfine: float = float("nan")

    # Filled by decode_mib
    n_ports: int = -1
    n_rb_dl: int = -1
    phich_duration: PhichDuration = PhichDuration.UNKNOWN
    phich_resource: PhichResource = PhichResource.UNKNOWN
    sfn: int = -1

    def n_id_cell(self) -> int:
        """Physical cell ID = 3*n_id_1 + n_id_2 (reference common.cpp:29-31)."""
        if self.n_id_1 < 0 or self.n_id_2 < 0:
            return -1
        return 3 * self.n_id_1 + self.n_id_2

    def n_symb_dl(self) -> int:
        """OFDM symbols per slot: 7 for normal CP, 6 for extended."""
        if self.cp_type is CpType.NORMAL:
            return 7
        if self.cp_type is CpType.EXTENDED:
            return 6
        raise ValueError("CP type not yet determined")

    def evolve(self, **kwargs) -> "Cell":
        """Return a copy with the given fields updated."""
        return replace(self, **kwargs)

    def k_factor(self, freq: Optional[float] = None) -> float:
        """Crystal scale factor (fc_requested - freq_offset) / fc_programmed.

        A single crystal drives both tuner LO and sampler, so a carrier
        frequency offset implies a proportional sample-clock offset
        (derivation: reference src/searcher.cpp:18-43).
        """
        f = self.freq if freq is None else freq
        return (self.fc_requested - f) / self.fc_programmed

    def __str__(self) -> str:
        parts = [f"cellID={self.n_id_cell()}", f"nID2={self.n_id_2}"]
        if self.n_id_1 >= 0:
            parts += [f"nID1={self.n_id_1}", f"cp={self.cp_type.value}",
                      f"frame_start={self.frame_start:.4f}"]
        parts += [f"fc={self.fc_requested/1e6:.3f}M", f"pow={self.pss_pow:.4g}"]
        for name in ("freq", "freq_fine", "freq_superfine"):
            v = getattr(self, name)
            if v == v:  # not NaN
                parts.append(f"{name}={v:.2f}Hz")
        if self.n_rb_dl > 0:
            parts += [f"nRB={self.n_rb_dl}", f"ports={self.n_ports}",
                      f"phich={self.phich_duration.value}/{self.phich_resource.value}",
                      f"sfn={self.sfn}"]
        return "Cell(" + " ".join(parts) + ")"
