"""The one traffic generator: the tracker's stream with its truth, made
from a configuration and the run's seed.

Plain numpy over the frozen generator (frozen/); it imports nothing of
the program.  The same seed gives the same stream and the same truth.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .frozen import channel
from .frozen.dl_sig import create_dl_sig

FS = channel.FS


@dataclass
class TrueCell:
    """One transmitted cell as the receiver should report it."""
    n_id_1: int
    n_id_2: int
    frame0: int       # first sample at which a frame begins
    sfn0: int         # that frame's SFN
    n_ports: int
    n_rb_dl: int
    normal_cp: bool = True
    phich: Tuple[str, str] = ("normal", "one")
    loop_frames: int = 1024   # the stream replays after this many frames

    @property
    def n_id_cell(self) -> int:
        return 3 * self.n_id_1 + self.n_id_2

    def sfn(self, f: int) -> int:
        """The SFN of frame ``f``, counted from frame0."""
        return (self.sfn0 + f % self.loop_frames) % 1024


def tracker_cells(cfg: dict) -> List[TrueCell]:
    """The stream's cells: (n_id_1, slot_start, sfn0) from the plan;
    frame0 is the first frame boundary at or after sample 0."""
    s = cfg["stream"]
    return [TrueCell(n1, s["n_id_2"], ((20 - slot) % 20) * 960,
                     (sfn0 + (1 if slot else 0)) % 1024, s["n_ports"],
                     s["n_rb_dl"], loop_frames=s["loop_ms"] // 10)
            for n1, slot, sfn0 in s["cell_plan"][: s["n_cells"]]]


def tracker_loop(seed: int, cfg: dict, workers: int = 4) -> np.ndarray:
    """The tracker stream as one seamless loop of ``loop_ms`` (complex64
    on the 8-bit grid): the plan's cells summed at equal power, mixed up
    by ``f_off_hz`` with a continuous phase, AWGN, quantised per chunk
    of ``chunk_ms``.  loop_ms is a whole number of SFN periods and of
    mixer cycles, so the loop replays without a seam.  Each chunk draws
    from its own generator spawned from the seed, so ``workers``
    threads make the same loop as one."""
    s = cfg["stream"]
    loop_ms, chunk_ms = s["loop_ms"], s["chunk_ms"]
    n_chunk = int(chunk_ms * FS / 1000)
    n = loop_ms // chunk_ms
    out = np.empty(n * n_chunk, dtype=np.complex64)
    seqs = np.random.SeedSequence(seed).spawn(n)

    def chunk(j: int) -> None:
        rng = np.random.default_rng(seqs[j])
        acc = np.zeros(n_chunk, dtype=np.complex128)
        for n1, slot, sfn0 in s["cell_plan"][: s["n_cells"]]:
            sfn = (sfn0 + j * chunk_ms // 10) % 1024
            acc += create_dl_sig(True, chunk_ms, slot, n1, s["n_id_2"],
                                 s["load_factor"], rng, s["n_ports"], sfn,
                                 s["n_rb_dl"])
        acc = channel.apply_freq_offset(acc, s["f_off_hz"], j * n_chunk)
        acc = channel.awgn(acc, s["snr_db"], rng)
        out[j * n_chunk: (j + 1) * n_chunk] = channel.adc_quantize_rms(acc)

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(chunk, range(n)))
    return out
