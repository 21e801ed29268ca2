"""Capture acquisition: record/replay and pluggable sample sources.

Behavioral contract: reference capture_data (reference src/
capbuf.cpp:81-200): 80 ms capture from the dongle or from a recorded
``capbuf_XXXX.it`` file (fields ``capbuf`` + ``fc``); ``--record`` writes
the same files.  Raw ``rtl_sdr``-format u8 files are read through
utils.rtl.  The ``CaptureSource`` protocol is the seam where a live
dongle plugs in (``io/rtlsdr.py``): ``capture`` gives one buffer
for the searches, ``stream`` the tracker's continuous sample blocks.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from ..cell import CpType
from ..constants import CAPLENGTH, FS_WORK
from ..sim.channel import (ClockResampler, apply_coupled_offset,
                           apply_freq_offset, awgn)
from ..sim.dl_sig import create_dl_sig
from ..utils.itfile import read_itfile, write_itfile
from ..utils.rtl import read_rtlsdr_file
from .e4000 import fc_programmed_with_fudge


class CaptureSource:
    """A source of capture buffers."""

    fs_programmed: float = FS_WORK

    def capture(self, fc_requested: float) -> Tuple[np.ndarray, float]:
        """Return (capbuf, fc_programmed)."""
        raise NotImplementedError

    def stream(self, block: int = 10000) -> Iterator[np.ndarray]:
        """Yield consecutive sample blocks of ``block`` samples (a
        bounded source may end with a shorter one, or stop)."""
        raise NotImplementedError


def _add_noise(buf: np.ndarray, noise_power: float,
               rng: np.random.Generator) -> np.ndarray:
    """Complex white Gaussian noise of ``noise_power`` added to buf (the
    reference's --noise-power, LTE-Tracker.cpp:248-255)."""
    n = (rng.normal(size=len(buf)) + 1j * rng.normal(size=len(buf))) \
        * np.sqrt(noise_power / 2)
    return buf + n


class FileSource(CaptureSource):
    """Replay recorded captures: .it containers or raw rtl_sdr u8 files.

    ``rng`` draws the ``noise_power`` noise; without one a fresh,
    unseeded generator does (pass a seeded one to reproduce a run)."""

    def __init__(self, paths, drop_seconds: float = 0.0,
                 repeat: bool = False, noise_power: Optional[float] = None,
                 rng: Optional[np.random.Generator] = None):
        self.paths = list(paths)
        self.drop_seconds = drop_seconds
        self.repeat = repeat
        self.noise_power = noise_power
        self.rng = rng or np.random.default_rng()
        self._idx = 0

    def _load(self, path: str) -> np.ndarray:
        if path.endswith(".it"):
            return read_itfile(path)["capbuf"]
        return read_rtlsdr_file(path, self.drop_seconds)

    def capture(self, fc_requested: float) -> Tuple[np.ndarray, float]:
        if self._idx >= len(self.paths):
            if not self.repeat:
                # ValueError (not StopIteration, which the iteration
                # protocol would swallow) so the CLI prints a clean message
                raise ValueError("no more recorded captures")
            self._idx = 0
        buf = self._load(self.paths[self._idx])
        self._idx += 1
        buf = buf[:CAPLENGTH]
        if self.noise_power is not None:
            buf = _add_noise(buf, self.noise_power, self.rng)
        return buf, fc_requested

    def stream(self, block: int = 10000) -> Iterator[np.ndarray]:
        """Every file whole, in order, cut into blocks (each file's last
        block may be short); again from the first with ``repeat``."""
        while True:
            for path in self.paths:
                buf = self._load(path)
                if self.noise_power is not None:
                    buf = _add_noise(buf, self.noise_power, self.rng)
                for i in range(0, len(buf), block):
                    yield buf[i: i + block]
            if not self.repeat:
                return


class SimSource(CaptureSource):
    """Synthetic eNodeB source (fault injection / self-test)."""

    def __init__(self, n_id_1: int = 92, n_id_2: int = 1,
                 cp_type: CpType = CpType.NORMAL, n_ports: int = 2,
                 snr_db: float = 10.0, freq_offset: float = 0.0,
                 load_factor: float = 0.5, seed: int = 0,
                 capture_ms: int = 80, coupled_fc: float = 0.0):
        """coupled_fc > 0 applies ``freq_offset`` through the
        coupled-crystal channel at that carrier (carrier AND sample
        clock offset together, sim.channel.apply_coupled_offset); 0 =
        ideal clock, carrier mix only.  capture_ms > 80 lengthens the
        incoherent fold (n_comb grows)."""
        self.n_id_1 = n_id_1
        self.n_id_2 = n_id_2
        self.cp_type = cp_type
        self.n_ports = n_ports
        self.snr_db = snr_db
        self.freq_offset = freq_offset
        self.load_factor = load_factor
        self.coupled_fc = coupled_fc
        self.capture_ms = capture_ms
        self.rng = np.random.default_rng(seed)

    def capture(self, fc_requested: float) -> Tuple[np.ndarray, float]:
        sig = create_dl_sig(self.cp_type, self.capture_ms, 0, self.n_id_1,
                            self.n_id_2, self.load_factor, rng=self.rng,
                            n_ports=self.n_ports)
        if self.coupled_fc and self.freq_offset:
            sig = apply_coupled_offset(sig, self.freq_offset, self.coupled_fc)
        else:
            sig = apply_freq_offset(sig, self.freq_offset)
        return awgn(sig, self.snr_db, rng=self.rng), fc_requested

    def _nominal(self, ms: int) -> np.ndarray:
        return create_dl_sig(self.cp_type, ms, 0, self.n_id_1, self.n_id_2,
                             self.load_factor, rng=self.rng,
                             n_ports=self.n_ports)

    def stream(self, block: int = 10000) -> Iterator[np.ndarray]:
        """Endless stream generated 200 ms at a time.  Without the
        coupled channel each 200 ms restarts the carrier mix at phase 0;
        through it the mixer phase runs on and ``ClockResampler``
        carries the fractional sample position across the 200 ms
        boundaries, so the clock's timing drift accumulates as a live
        dongle's would."""
        if not (self.coupled_fc and self.freq_offset):
            while True:
                sig = apply_freq_offset(self._nominal(200), self.freq_offset)
                buf = awgn(sig, self.snr_db, rng=self.rng)
                for i in range(0, len(buf), block):
                    yield buf[i: i + block]
        rs = ClockResampler((self.coupled_fc - self.freq_offset)
                            / self.coupled_fc)
        mixed_at = 0
        pending = np.zeros(0, np.complex128)
        while True:
            nominal = self._nominal(200)
            mixed = nominal * np.exp(
                1j * 2 * np.pi * self.freq_offset
                * (mixed_at + np.arange(len(nominal))) / FS_WORK)
            mixed_at += len(nominal)
            out = rs.push(mixed)
            if len(out):
                pending = np.concatenate(
                    [pending, awgn(out, self.snr_db, rng=self.rng)])
            while len(pending) >= block:
                yield pending[:block]
                pending = pending[block:]


class CaptureSession:
    """Run-scoped capture numbering + the reference capture_data flow.

    The reference numbers capbuf_XXXX.it files with a function-static
    counter reset per process run (capbuf.cpp:94); a module-global here
    would misnumber files when one process performs two scans (library
    use, record-then-load).  Each scan owns one session."""

    def __init__(self, data_dir: str = "."):
        self.data_dir = data_dir
        self._counter = 0

    def capture_data(self, fc_requested: float,
                     source: Optional[CaptureSource],
                     save_cap: bool = False,
                     use_recorded_data: bool = False,
                     tuner: str = "e4000",
                     index: Optional[int] = None
                     ) -> Tuple[np.ndarray, float]:
        """Capture or replay one buffer, optionally recording it.

        Returns (capbuf, fc_programmed).  A source that reports its own
        fc_programmed is trusted; otherwise an E4000-style tuner emulates
        the PLL model (+58 Hz fudge, reference capbuf.cpp:134-149), and
        ``tuner="none"`` keeps fc_requested.

        ``index`` overrides the session counter for the capbuf_XXXX.it
        filename (and leaves the counter untouched), for a caller that
        numbers captures by their band index.
        """
        n = self._counter if index is None else index
        filename = os.path.join(self.data_dir, f"capbuf_{n:04d}.it")
        if use_recorded_data:
            d = read_itfile(filename)
            capbuf = d["capbuf"]
            fc_file = float(d["fc"][0])
            if fc_file != fc_requested:
                print(f"Warning: capture {filename} was taken at "
                      f"{fc_file / 1e6:.3f} MHz, "
                      f"not {fc_requested / 1e6:.3f}")
            fc_programmed = fc_requested
        else:
            if source is None:
                raise RuntimeError("no capture source available")
            capbuf, fc_programmed = source.capture(fc_requested)
            if fc_programmed is None or fc_programmed == fc_requested:
                fc_programmed = fc_programmed_with_fudge(fc_requested) \
                    if tuner == "e4000" else fc_requested
        if save_cap:
            write_itfile(filename, {
                "capbuf": np.asarray(capbuf, dtype=np.complex128),
                "fc": np.array([int(fc_requested)], dtype=np.int32)})
        if index is None:
            self._counter += 1
        return capbuf, fc_programmed


def capture_data(fc_requested: float, source: Optional[CaptureSource],
                 save_cap: bool = False, use_recorded_data: bool = False,
                 data_dir: str = ".", tuner: str = "e4000",
                 session: Optional[CaptureSession] = None
                 ) -> Tuple[np.ndarray, float]:
    """One-shot wrapper over CaptureSession.capture_data (numbering is
    per-session; pass `session` to keep it across calls)."""
    if session is None:
        session = CaptureSession(data_dir)
    return session.capture_data(fc_requested, source, save_cap,
                                use_recorded_data, tuner)
