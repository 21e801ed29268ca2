"""The port's band scan over processes (lte_cell_scanner_tpu_torch/
parallel/multihost.py) against the TPU package's single-process band, on
the CPU.

Two ``tools_torch/multihost_worker.py --device cpu`` ranks join one gloo
group on localhost and scan the four-carrier band of
tools/multihost_worker.py (cells 277 and 503 on the first and last
carriers, noise between), as tests/test_multihost.py:48-177 does with
the TPU package's workers.  Both ranks' merged lists must be equal, and
equal to the TPU package's single-process ``scan_band`` of the same four
captures (complex128, its 8 virtual devices) in the fields and bounds of
tests/test_multihost.py:100-127; the 3 + 1 split must give the 2 + 2
split's list; the ADC-grid band must find 3*92+1 and 3*167+2 with the
gathered route verdict [1, kv] on both ranks.  The records must round
trip and equal the TPU package's bit for bit.
"""

import importlib.util
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from lte_cell_scanner_tpu.cell import (Cell as JCell, CpType as JCpType,
                                       PhichDuration as JPd,
                                       PhichResource as JPr)
from lte_cell_scanner_tpu.constants import FS_LTE
from lte_cell_scanner_tpu.models.search import SearchConfig as JConfig
from lte_cell_scanner_tpu.models.search import dedup as jdedup
from lte_cell_scanner_tpu.parallel import multihost as jmh
from lte_cell_scanner_tpu.parallel.carriers import scan_band as jscan_band
from lte_cell_scanner_tpu_torch.cell import (Cell, CpType, PhichDuration,
                                             PhichResource)
from lte_cell_scanner_tpu_torch.parallel import multihost as tmh

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "tools_torch" / "multihost_worker.py"

spec = importlib.util.spec_from_file_location("torch_multihost_worker",
                                              WORKER)
worker_mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(worker_mod)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    port = _free_port()
    procs, outs = [], []
    for pid in range(2):
        out = tmp / f"out_{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
             str(pid), "--out", str(out), "--device", "cpu"],
            env=dict(os.environ, OMP_NUM_THREADS="2"), cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, \
            f"worker {pid} failed (rc={p.returncode}):\n{log[-4000:]}"
    return sorted((json.loads(o.read_text()) for o in outs),
                  key=lambda r: r["process"])


def _jax_band(captures, cfg):
    lists = jscan_band(captures, np.asarray(worker_mod.F_SEARCH),
                       FS_LTE / 16, cfg, dtype=np.complex128)
    return sorted(jdedup(lists), key=lambda c: c.fc_requested)


def test_two_process_band_matches_tpu_single_process(worker_results):
    r0, r1 = worker_results
    assert (r0["n_processes"], r0["device"]) == (2, "cpu")
    assert r0["merged"] == r1["merged"]
    # each embedded cell decoded on the process that owns its carrier
    assert 3 * 92 + 1 in {c["n_id_cell"] for cells in r0["local"]
                          for c in cells}
    assert 3 * 167 + 2 in {c["n_id_cell"] for cells in r1["local"]
                           for c in cells}
    for g in r0["merged"]:
        assert (g["n_ports"], g["n_rb_dl"], g["phich_duration"]) == \
            (2, 6, "normal")

    captures = [worker_mod.make_capture(i)
                for i in range(worker_mod.N_CARRIERS)]
    ref = _jax_band(captures, JConfig())
    got = r0["merged"]
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g["n_id_cell"] == r.n_id_cell()
        assert g["cp"] == r.cp_type.value
        assert g["fc"] == r.fc_requested
        assert abs(g["frame_start"] - r.frame_start) < 1e-3
        assert abs(g["freq_fine"] - r.freq_fine) < 1.0
        assert abs(g["pss_pow"] - r.pss_pow) < 1e-6 * abs(r.pss_pow) + 1e-12
        assert (g["n_ports"], g["n_rb_dl"], g["sfn"]) == \
            (r.n_ports, r.n_rb_dl, r.sfn)


def test_unequal_band_split_matches(worker_results):
    """The 3 + 1 split gives the 2 + 2 split's merge: each rank pads its
    own slice (tests/test_multihost.py:132)."""
    r0, r1 = worker_results
    assert r0["merged_unequal"] == r1["merged_unequal"] == r0["merged"]
    assert r0["verdicts"]["unequal"] == r1["verdicts"]["unequal"]


def test_adc_grid_band_and_route_verdict(worker_results):
    """Captures on the 8-bit grid: the cells of
    tests/test_multihost.py:141, the same IDs as the TPU package's exact
    single-process band, and both ranks gathered [1, kv] from both."""
    r0, r1 = worker_results
    assert r0["merged_pallas_ids"] == r1["merged_pallas_ids"]
    assert {3 * 92 + 1, 3 * 167 + 2} <= set(r0["merged_pallas_ids"])
    gcaps = [(worker_mod.to_grid(c), fc, fcp) for c, fc, fcp in
             (worker_mod.make_capture(i)
              for i in range(worker_mod.N_CARRIERS))]
    ref = _jax_band(gcaps, JConfig(decode=False))
    assert r0["merged_pallas_ids"] == sorted(c.n_id_cell() for c in ref)
    for r in (r0, r1):
        (flags,) = r["verdicts"]["adc"]
        assert [f[0] for f in flags] == [1, 1]
        assert flags[0][1] == flags[1][1] == 256
        # the float band's verdict: not on the grid
        assert [f[0] for f in r["verdicts"]["equal"][0]] == [0, 0]


def _cells(mod_cell, cp, pd, pr):
    c = mod_cell(fc_requested=739e6, fc_programmed=739.1e6, pss_pow=0.137,
                 ind=8675, freq=40e3, n_id_2=1, n_id_1=92,
                 cp_type=cp.NORMAL, frame_start=17449.525,
                 freq_fine=39967.89, freq_superfine=39970.1, n_ports=2,
                 n_rb_dl=50, phich_duration=pd.NORMAL,
                 phich_resource=pr.ONE, sfn=649)
    partial = mod_cell(fc_requested=1e9 + 0.1, fc_programmed=1e9,
                       pss_pow=0.5, ind=3, freq=-5e3, n_id_2=2)
    ext = mod_cell(fc_requested=744.3e6, fc_programmed=744.3e6,
                   pss_pow=1.5e-3, ind=1, freq=5e3, n_id_2=0, n_id_1=3,
                   cp_type=cp.EXTENDED, frame_start=123.25,
                   freq_fine=5001.5, freq_superfine=5000.75, n_ports=4,
                   n_rb_dl=100,
                   phich_duration=pd.EXTENDED, phich_resource=pr.ONE_SIXTH,
                   sfn=1023)
    return [c, partial, ext]


def test_record_round_trip():
    """Cell <-> flat record is lossless for every field
    (tests/test_multihost.py:152), with the budget's ValueError."""
    cells = _cells(Cell, CpType, PhichDuration, PhichResource)
    back = tmh.records_to_cells(tmh.cells_to_records(cells, 4))
    assert len(back) == 3
    assert back[0] == cells[0] and back[2] == cells[2]
    b = back[1]
    assert (b.n_id_1, b.n_rb_dl, b.sfn) == (-1, -1, -1)
    assert np.isnan(b.frame_start) and np.isnan(b.freq_superfine)
    assert b.cp_type is CpType.UNKNOWN
    with pytest.raises(ValueError, match="raise max_cells_per_host"):
        tmh.cells_to_records(cells, 2)


def test_records_bit_equal_to_tpu_package():
    got = tmh.cells_to_records(_cells(Cell, CpType, PhichDuration,
                                      PhichResource), 5)
    want = jmh.cells_to_records(_cells(JCell, JCpType, JPd, JPr), 5)
    assert tmh.N_REC == jmh.N_REC and tmh._FIELDS == jmh._FIELDS
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    # the gather carries the float64 records bit for bit
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        gathered = tmh._allgather(got)
    finally:
        dist.destroy_process_group()
    assert gathered.dtype == np.float64 and gathered.shape == (1, 5, tmh.N_REC)
    assert gathered[0].tobytes() == want.tobytes()
