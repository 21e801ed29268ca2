"""Band scans whose carriers are spread over processes
(``torch.distributed``).

The counterpart of the TPU package's ``parallel/multihost.py``.  The
reference scans a band serially on one machine (reference
src/CellSearch.cpp:469-471) and merges the results with a final dedup
(:573, :285-319).  Here:

- each process captures or loads its own slice of the band (the
  carriers are the data-parallel axis; capture I/O is local to its
  host);
- each process runs the band scan of ``parallel/carriers.py`` (front
  end, peak search, back half) on its own carriers, on its own device:
  ``cuda:(rank % device_count)``, or the host with ``device="cpu"``;
- what crosses processes is three all-gathers of small host tensors of
  fixed shape: the carrier counts (every rank pads its slice to the
  largest by repeating its last capture, so chunk boundaries are equal
  everywhere), each chunk's route verdict (so every rank runs the same
  kernel route), and the decoded cells as fixed-width records.  They go
  over gloo on CPU tensors: no collective carries device data, so no
  NCCL is used, and several ranks may share one card;
- the final ``dedup`` runs identically on every rank, so rank 0 can
  print the reference's results table.

Every rank must call ``scan_band_multihost`` with the same arguments but
its captures, after ``initialize``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..cell import Cell, CpType, PhichDuration, PhichResource
from ..models.search import SearchConfig, dedup
from ..ops.corr_cuda import is_adc_grid
from .carriers import _plan_scan_bands, _scan_staged, _stage_chunk, v4_band_kv

_CP_CODE = {CpType.UNKNOWN: 0, CpType.NORMAL: 1, CpType.EXTENDED: 2}
_PD_CODE = {PhichDuration.UNKNOWN: 0, PhichDuration.NORMAL: 1,
            PhichDuration.EXTENDED: 2}
_PR_CODE = {PhichResource.UNKNOWN: 0, PhichResource.ONE_SIXTH: 1,
            PhichResource.HALF: 2, PhichResource.ONE: 3,
            PhichResource.TWO: 4}
_CP_FROM = {v: k for k, v in _CP_CODE.items()}
_PD_FROM = {v: k for k, v in _PD_CODE.items()}
_PR_FROM = {v: k for k, v in _PR_CODE.items()}

# field order of the flat float64 cell record (the gather's wire format)
_FIELDS = ("fc_requested", "fc_programmed", "pss_pow", "ind", "freq",
           "n_id_2", "n_id_1", "frame_start", "freq_fine", "freq_superfine",
           "n_ports", "n_rb_dl", "sfn")
N_REC = len(_FIELDS) + 4  # + cp_type, phich_duration, phich_resource, valid


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, **kwargs) -> None:
    """Join the process group: gloo, rendezvous at ``HOST:PORT`` (rank 0
    listens there); ``kwargs`` go to ``init_process_group`` (e.g.
    ``timeout``).  A second call in the same process does nothing."""
    if dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)


def finalize() -> None:
    """Leave the process group (nothing to do outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_device(device=None) -> torch.device:
    """This rank's device: ``cuda:(rank % device_count)`` for None or a
    CUDA device without an index, else the device named.  Without a card
    a CUDA rank raises; it never moves to the host by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device for this rank (device='cpu' "
                           "runs it on the host)")
    return torch.device("cuda", dist.get_rank() % n)


def _allgather(arr: np.ndarray) -> np.ndarray:
    """[world, *arr.shape]: every rank's ``arr`` (same shape and type on
    every rank), in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).numpy()


def cells_to_records(cells: Sequence[Cell], n_max: int) -> np.ndarray:
    """[n_max, N_REC] float64, zero-padded, valid flag last."""
    if len(cells) > n_max:
        raise ValueError(f"{len(cells)} cells exceed the {n_max}-record "
                         f"gather budget; raise max_cells_per_host")
    out = np.zeros((n_max, N_REC), dtype=np.float64)
    for i, c in enumerate(cells):
        out[i, :len(_FIELDS)] = [float(getattr(c, f)) for f in _FIELDS]
        out[i, len(_FIELDS) + 0] = _CP_CODE[c.cp_type]
        out[i, len(_FIELDS) + 1] = _PD_CODE[c.phich_duration]
        out[i, len(_FIELDS) + 2] = _PR_CODE[c.phich_resource]
        out[i, len(_FIELDS) + 3] = 1.0
    return out


def records_to_cells(rec: np.ndarray) -> List[Cell]:
    rec = np.asarray(rec).reshape(-1, N_REC)
    cells = []
    for row in rec:
        if row[len(_FIELDS) + 3] < 0.5:
            continue
        kw = {}
        for j, f in enumerate(_FIELDS):
            v = row[j]
            kw[f] = int(v) if f in ("ind", "n_id_2", "n_id_1", "n_ports",
                                    "n_rb_dl", "sfn") else float(v)
        kw["cp_type"] = _CP_FROM[int(row[len(_FIELDS) + 0])]
        kw["phich_duration"] = _PD_FROM[int(row[len(_FIELDS) + 1])]
        kw["phich_resource"] = _PR_FROM[int(row[len(_FIELDS) + 2])]
        cells.append(Cell(**kw))
    return cells


def _scan_chunk(chunk, chunk_real: int, dev: torch.device,
                f_search_set: np.ndarray, fs_programmed: float,
                cfg: SearchConfig, verdicts: Optional[list]
                ) -> List[List[Cell]]:
    """One chunk, of equal length on every rank: the route verdict
    gathered and combined, then this rank's band scan of the chunk; the
    cell lists of its first ``chunk_real`` (real) carriers.

    Each rank plans its operands from its own middle carrier, so the
    kernel route must be imposed the same everywhere: int8 only if every
    rank's captures are all on the ADC grid; the fused v4 route only if
    no rank's chunk fails the v4 gate, taken at margin 1 so that ranks
    whose middle tables differ cannot disagree near the window's edge."""
    ch = _stage_chunk(chunk, f_search_set, fs_programmed, 1)
    local_grid = all(is_adc_grid(c) for c in ch.capbufs)
    flags = _allgather(np.array(
        [1 if local_grid else 0, v4_band_kv(ch.starts, margin=1)], np.int32))
    kv_glob = 0 if np.any(flags[:, 1] == 0) else int(np.max(flags[:, 1]))
    if verdicts is not None:
        verdicts.append(flags.tolist())
    route = _plan_scan_bands(ch.tmpl, ch.starts, ch.capbufs, cfg, dev,
                             force_int8=bool(np.all(flags[:, 0])),
                             force_v4=kv_glob)
    return _scan_staged(ch, route, f_search_set, fs_programmed, cfg, [dev],
                        None, n_real=chunk_real)


def scan_band_multihost(
        local_captures: Sequence[Tuple[np.ndarray, float, float]],
        f_search_set: np.ndarray, fs_programmed: float,
        config: Optional[SearchConfig] = None,
        max_cells_per_host: int = 128,
        max_carriers_per_program: int = 64, device=None,
        verdicts: Optional[list] = None,
) -> Tuple[List[List[Cell]], List[Cell]]:
    """Scan a band whose carriers are spread over the processes of the
    group (``initialize`` first).

    local_captures: THIS process's (capbuf, fc_requested, fc_programmed)
    slice of the band.  Uneven slices are fine: the counts are gathered
    and every process pads its own list to the largest by repeating its
    last capture (dropped before the back half: the caller never
    duplicates RF dwell time).  Every process must contribute at least
    one carrier.  The slices run in chunks of
    ``max_carriers_per_program`` carriers, with equal boundaries on every
    process.

    device: this rank's device (``local_device``).  verdicts: if a list
    is given, each chunk's gathered route verdict ([world, 2]: every
    rank's ADC-grid flag and v4 kv at margin 1) is appended to it.

    Returns (per-local-carrier decoded cell lists, the globally deduped
    cell list), the latter equal on every process."""
    cfg = config or SearchConfig()
    if not local_captures:
        raise ValueError(
            "every process must contribute at least one local carrier "
            "(run a band narrower than the process count with fewer "
            "processes)")
    dev = local_device(device)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)

    c_real = len(local_captures)
    n_eq = int(np.max(_allgather(np.array([c_real], np.int64))))
    padded = list(local_captures) \
        + [local_captures[-1]] * (n_eq - c_real)

    limit = max(1, max_carriers_per_program)
    results_local: List[List[Cell]] = []
    for i0 in range(0, n_eq, limit):
        chunk = padded[i0: i0 + limit]
        chunk_real = max(0, min(c_real - i0, len(chunk)))
        results_local.extend(_scan_chunk(
            chunk, chunk_real, dev, f_search_set, fs_programmed, cfg,
            verdicts))

    # every rank learns every rank's cell count first, so that a rank
    # over the record budget fails on every rank instead of leaving its
    # peers waiting in the records' gather
    flat = [c for cells in results_local for c in cells]
    n_cells = _allgather(np.array([len(flat)], np.int64))
    if int(n_cells.max()) > max_cells_per_host:
        raise ValueError(f"a process found {int(n_cells.max())} cells, over "
                         f"the {max_cells_per_host}-record gather budget; "
                         f"raise max_cells_per_host")
    # gloo carries the float64 records bit for bit (the 100 kHz
    # raster's low digits survive)
    all_rec = _allgather(cells_to_records(flat, max_cells_per_host))
    merged = dedup([records_to_cells(all_rec)])
    return results_local, merged
