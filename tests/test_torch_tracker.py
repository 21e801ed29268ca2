"""The port's tracker pieces (lte_cell_scanner_tpu_torch/tracker/,
io/native.py, the host decode helpers, the capture streams and
SearchConfig.skip_ids) against the TPU package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages:
- the demod program (``_get_fd_core`` and its block-gather variant, B =
  3 cells x S = 64 symbols) and one device-loop tick's packed output,
  both in float64, within 1e-12;
- the port's native runtime (built from ``native/*.cpp`` and
  ``csrc/cell_rows_tick.cpp`` into the port's own ``build/``), which the
  port's tracker requires, against the TPU package's numpy fallbacks:
  the fused cell ticks of the dense path and the device loop (the
  latter also bit for bit against the TPU package's per-port chain on
  its own native library), the symbol framing, the u8 conversion and
  the MIB re-decode's Viterbi (tolerances of
  tests/test_tracker.py:347-470 and tests/test_coding.py); and that the
  tracker and producer raise rather than fall back when the runtime
  cannot be built;
- the capture streams, bit for bit;
- ``skip_ids`` through ``cell_search`` (batched and peak by peak) and a
  three-carrier ``scan_band``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.io import capture as jcap
from lte_cell_scanner_tpu.io import native as jnative
from lte_cell_scanner_tpu.models import coding as jcoding
from lte_cell_scanner_tpu.models import modulation as jmod
from lte_cell_scanner_tpu.models import search as js
from lte_cell_scanner_tpu.parallel import carriers as jc
from lte_cell_scanner_tpu.sim import apply_freq_offset, awgn, create_dl_sig
from lte_cell_scanner_tpu.tracker import batched as jb
from lte_cell_scanner_tpu.tracker import cell_tracker as jct
from lte_cell_scanner_tpu.tracker import device_loop as jdl
from lte_cell_scanner_tpu.tracker import producer as jprod
from lte_cell_scanner_tpu.tracker import state as jstate
from lte_cell_scanner_tpu_torch.interop import (config_from_fields,
                                                global_state_from_fields,
                                                tracked_cell_from_fields)
from lte_cell_scanner_tpu_torch.io import capture as tcap
from lte_cell_scanner_tpu_torch.io import native as tnative
from lte_cell_scanner_tpu_torch.models import coding as tcoding
from lte_cell_scanner_tpu_torch.models import modulation as tmod
from lte_cell_scanner_tpu_torch.models import search as ts
from lte_cell_scanner_tpu_torch.parallel import carriers as tc
from lte_cell_scanner_tpu_torch.tracker import batched as tb
from lte_cell_scanner_tpu_torch.tracker import cell_tracker as tct
from lte_cell_scanner_tpu_torch.tracker import device_loop as tdl
from lte_cell_scanner_tpu_torch.tracker import producer as tprod
from lte_cell_scanner_tpu_torch.utils import itfile as tit

FS = 1.92e6
FC = 739e6


@pytest.fixture(scope="module")
def lib():
    """The port's native runtime, built here from native/*.cpp."""
    lib = tnative.load()
    assert tnative.LIB_PATH.parent.name == "build"
    return lib


def _jax_state(fo=0.0):
    return jstate.GlobalState(fc_requested=FC, fc_programmed=FC,
                              fs_programmed=FS, frequency_offset=fo)


def _pair(cp, n_ports, n_id=277, fo=0.0, frame_timing=0.0):
    """(TPU package's state and cell, the port's copies)."""
    st = _jax_state(fo)
    cell = jstate.TrackedCell(n_id_cell=n_id, n_id_1=n_id // 3,
                              n_id_2=n_id % 3, cp_type=JCpType(cp),
                              n_ports=n_ports, frame_timing=frame_timing)
    return (st, cell, global_state_from_fields(dataclasses.asdict(st)),
            tracked_cell_from_fields(dataclasses.asdict(cell)))


# ---------------------------------------------------------------------------
# The demod program and one device-loop tick
# ---------------------------------------------------------------------------

def _fd_inputs(rng, B=3, S=64):
    data = rng.normal(size=(B, S, 128)) + 1j * rng.normal(size=(B, S, 128))
    fo = 250.0 + rng.normal(size=(B, S)) * 40
    late = rng.uniform(-0.5, 2.0, size=(B, S))
    nse = np.where(rng.random((B, S)) < 1 / 7, 138.0, 137.0)
    valid = np.ones((B, S), bool)
    valid[1, 40:] = False
    valid[2, 7:] = False
    nse[~valid] = 0.0
    init = rng.uniform(-np.pi, np.pi, size=B)
    return data, fo, late, nse, valid, init


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_get_fd_core_matches_tpu_package():
    rng = np.random.default_rng(1)
    data, fo, late, nse, valid, init = _fd_inputs(rng)
    want_s, want_f = jb._get_fd_core_impl(data, fo, late, nse, valid, init,
                                          FC, FC, FS)
    got_s, got_f = tb._get_fd_core(_t(data), _t(fo), _t(late), _t(nse),
                                   _t(valid), _t(init), FC, FC, FS)
    assert got_s.dtype == torch.complex128
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=1e-12)


def test_get_fd_block_core_matches_tpu_package():
    rng = np.random.default_rng(2)
    _d, fo, late, nse, valid, init = _fd_inputs(rng)
    block = rng.normal(size=20000) + 1j * rng.normal(size=20000)
    starts = rng.integers(0, 20000 - 128, size=fo.shape)
    want_s, want_f = jb._get_fd_block_core_impl(
        block, starts, fo, late, nse, valid, init, FC, FC, FS)
    got_s, got_f = tb._get_fd_block_core(
        _t(block), _t(starts), _t(fo), _t(late), _t(nse), _t(valid),
        _t(init), FC, FC, FS)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0,
                               atol=1e-12)


def _tick_cells(rng, block, seq):
    """Three cells of different shapes on one producer block: each a
    (TPU package processor, port processor, PduChunk of each)."""
    out = []
    for n_id, cp, ports, n, first in ((277, "normal", 2, 40, 5),
                                      (301, "normal", 4, 29, 61),
                                      (100, "extended", 1, 33, 17)):
        st, cell, tst, tcell = _pair(cp, ports, n_id)
        jp = jct.TrackedCellProcessor(cell, st)
        tp = tct.TrackedCellProcessor(tcell, tst)
        stride = 160 if cp == "extended" else 137
        starts = first + stride * np.arange(n)
        data = np.stack([block[s: s + 128] for s in starts])
        starts = starts.astype(np.int64)
        starts[3] = -1                      # a straddler: appendix route
        kw = dict(data=data, late=rng.uniform(-0.5, 2.0, size=n),
                  fo=250.0 + np.arange(n, dtype=float),
                  ft=np.zeros(n), sym0=0, start=starts, block_seq=seq)
        for p in (jp, tp):
            p.bulk_phase_offset = 0.1 * n_id % 1.0
        out.append((jp, tp, jprod.PduChunk(**kw), tprod.PduChunk(**kw)))
    return out, st


@pytest.mark.parametrize("block_path", [True, False],
                         ids=["raw-block", "window-copies"])
def test_tick_program_matches_tpu_extract_core(monkeypatch, block_path):
    """One device-loop tick of three cells (2-port, 4-port, extended CP;
    a straddling symbol on the appendix route): the port's packed
    download against the TPU package's _extract_core output, the same
    layout (CE planes, special-row planes, final phases) within 1e-12;
    then both processors' applied state."""
    rng = np.random.default_rng(4)
    block = rng.normal(size=9000) + 1j * rng.normal(size=9000)
    cells, st = _tick_cells(rng, block, 7)
    got, want = [], []
    j_orig, t_orig = jdl._extract_core, tdl._tick_program
    monkeypatch.setattr(jdl, "_extract_core", lambda *a: want.append(
        np.asarray(j_orig(*a))) or want[-1])
    monkeypatch.setattr(tdl, "_tick_program", lambda *a: got.append(
        t_orig(*a)) or got[-1])
    raw = block if block_path else None
    jdl.batched_tick_extract([(c[0], c[2]) for c in cells], cells[0][0].state,
                             raw_block=raw, block_seq=7)
    tdl.batched_tick_extract([(c[1], c[3]) for c in cells], cells[0][1].state,
                             raw_block=raw, block_seq=7, device="cpu")
    assert len(got) == len(want) == 1
    g, w = got[0].numpy(), want[0]
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    for jp, tp, _, _ in cells:
        assert abs(tp.bulk_phase_offset - jp.bulk_phase_offset) < 1e-12
        assert (tp.slot_num, tp.sym_num) == (jp.slot_num, jp.sym_num)
        assert sorted(tp._spec_map) == sorted(jp._spec_map)
        for p in range(tp.cell.n_ports):
            a, b = tp.rs_pending[p], jp.rs_pending[p]
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-12)


def test_batched_get_fd_backends_agree():
    """The port's batched get_fd on the CPU device and its native host
    backend against the TPU package's numpy path
    (tests/test_tracker.py:193-240), the raw-block route included."""
    rng = np.random.default_rng(8)
    block = rng.normal(size=9000) + 1j * rng.normal(size=9000)
    outs = {}
    for route in ("device-block", "device", "host", "tpu"):
        cells, _st = _tick_cells(np.random.default_rng(9), block, 7)
        if route == "tpu":
            pairs = [(c[0], c[2]) for c in cells]
            res = jb.batched_get_fd(pairs, pairs[0][0].state,
                                    backend="numpy")
        else:
            pairs = [(c[1], c[3]) for c in cells]
            kw = {"backend": route.split("-")[0], "device": "cpu"}
            if route == "device-block":
                kw.update(raw_block=block, block_seq=7)
            res = tb.batched_get_fd(pairs, pairs[0][0].state, **kw)
        outs[route] = (res, [p.bulk_phase_offset for p, _ in pairs])
    ref, ref_ph = outs.pop("tpu")
    for route, (res, ph) in outs.items():
        for r, g in zip(ref, res):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-10,
                                       err_msg=route)
        np.testing.assert_allclose(ph, ref_ph, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# The native runtime against the TPU package's numpy fallbacks
# ---------------------------------------------------------------------------

# (cyclic prefix, ports, cell ID): cells 276, 277 and 278 put port 0's
# CRS at shifts {0, 3}, {1, 4} and {2, 5}
_CELLS = [pytest.param("normal", 2, 277, id="normal-2"),
          pytest.param("extended", 1, 277, id="extended-1"),
          pytest.param("normal", 4, 277, id="normal-4"),
          pytest.param("normal", 2, 276, id="normal-2-276"),
          pytest.param("normal", 2, 278, id="normal-2-278")]


@pytest.mark.parametrize("cp,n_ports,n_id", _CELLS)
def test_native_cell_tick_matches_numpy_process(lib, cp, n_ports, n_id):
    """The fused native cell tick (dense path) against the TPU package's
    all-numpy process(), fed identical fd symbols across ragged ticks
    (tests/test_tracker.py:733-815)."""
    rng = np.random.default_rng(23)
    n_symb = 7 if cp == "normal" else 6
    st_a, cell_a, st_b, cell_b = _pair(cp, n_ports, n_id, fo=50.0,
                                       frame_timing=100.0)
    ref = jct.TrackedCellProcessor(cell_a, st_a)
    ref._native = None
    got = tct.TrackedCellProcessor(cell_b, st_b)
    total = 20 * n_symb * 3 + 11
    S_all = rng.normal(size=(total, 72)) + 1j * rng.normal(size=(total, 72))
    fo_all = 50.0 + 0.05 * np.arange(total)
    ft_all = np.full(total, 100.0)
    start = 0
    for n in (31, 1, 2, 54, 97, 40):
        n = min(n, total - start)
        if n <= 0:
            break
        sl = slice(start, start + n)
        kw = dict(data=np.zeros((n, 128), np.complex128), late=np.zeros(n),
                  fo=fo_all[sl].copy(), ft=ft_all[sl].copy(), sym0=start)
        ref.process(jprod.PduChunk(**kw), fd_syms=S_all[sl].copy())
        got.process(tprod.PduChunk(**kw), fd_syms=S_all[sl].copy())
        start += n
    assert abs(st_b.frequency_offset - st_a.frequency_offset) < 1e-6
    assert abs(cell_b.frame_timing - cell_a.frame_timing) < 1e-8
    for f in ("ac_fd", "ac_td", "ce"):
        np.testing.assert_allclose(getattr(cell_b, f), getattr(cell_a, f),
                                   atol=1e-10, err_msg=f)
    for f in ("crs_tp_av", "crs_sp_raw_av", "crs_np_av", "sync_tp",
              "sync_sp", "sync_np", "sync_np_blank", "sync_tp_av",
              "sync_sp_av", "sync_np_av", "sync_np_blank_av", "sync_ce"):
        a, b = getattr(cell_b, f), getattr(cell_a, f)
        assert np.all(np.isfinite(a)), f
        np.testing.assert_allclose(a, b, atol=1e-12, err_msg=f)
    assert cell_b.mib_decode_failures == cell_a.mib_decode_failures


# Ragged device-loop ticks, in symbols: one RS row for ports 0/1 and
# fewer than 3 pending rows (1, at sym 0), a tick that gives ports 0/1
# none (1, at sym 1), one that gives no port of the normal CP a row (2,
# at syms 2-3), and one of 530 symbols, past the pending rows' first
# capacity of 512 (_grow_pending).
_ROWS_TICKS = (1, 1, 2, 54, 97, 40, 530, 31, 5)


def _rows_tick_inputs(rng, proc, n):
    """One device-loop tick of n symbols for proc: the planner's plan,
    its PduChunk and what the device would download for the cell: raw-CE
    rows [4, NR, 12] with each port's rows first, junk in the rest (rows
    past a port's count and the ports the cell lacks are never read),
    and the special rows."""
    k = proc.slot_num * proc.cell.n_symb_dl() + proc.sym_num + np.arange(n)
    chunk = tprod.PduChunk(data=np.zeros((n, 128), np.complex128),
                           late=np.zeros(n), fo=50.0 + 0.05 * k,
                           ft=100.0 + 0.01 * k, sym0=0)
    plan = tdl.stage_tick([(proc, chunk)], proc.state, device="cpu")[1][0]
    nr = max(len(sel) for sel in plan[3]) + 3
    ce_rows = rng.normal(size=(4, nr, 12)) + 1j * rng.normal(size=(4, nr, 12))
    spec = rng.normal(size=(len(plan[4]), 72)) \
        + 1j * rng.normal(size=(len(plan[4]), 72))
    return plan, chunk, ce_rows, spec


def _record_emits(proc):
    """Keep a copy of every row block proc emits into its fifos."""
    seen = []
    emit = proc._emit_rows

    def record(port, *rows_and_labels):
        seen.append((port,) + tuple(np.array(a) for a in rows_and_labels))
        emit(port, *rows_and_labels)
    proc._emit_rows = record
    return seen


@pytest.mark.parametrize("reference", ["per_port_chain", "numpy_fallback"])
@pytest.mark.parametrize("cp,n_ports,n_id", _CELLS)
def test_device_loop_cell_call_matches_per_port_chain(lib, cp, n_ports, n_id,
                                                      reference):
    """process_device's one native call per cell (cell_rows_tick) against
    the TPU package's process_device, fed the same downloaded rows and
    plans over ragged ticks: on its own native library (the runtime's
    port_tick per port, the chain cell_rows_tick calls) bit for bit, and
    on its numpy fallback within the native-vs-numpy tolerances.  Held:
    the emitted rows, the frequency-offset register, frame timing,
    ac_fd, ac_td, the ac_td history ring, the pending rows and the Phase
    C state."""
    rng = np.random.default_rng(29)
    st_a, cell_a, st_b, cell_b = _pair(cp, n_ports, n_id, fo=50.0,
                                       frame_timing=100.0)
    got = tct.TrackedCellProcessor(cell_b, st_b)
    ref = jct.TrackedCellProcessor(cell_a, st_a)
    assert got._native is lib and got._pend_cap == 512
    if reference == "per_port_chain":
        assert ref._native is not None, "the TPU package's runtime"
    else:
        ref._native = None
    emits = [_record_emits(p) for p in (got, ref)]
    for n in _ROWS_TICKS:
        plan, chunk, ce_rows, spec = _rows_tick_inputs(rng, got, n)
        slots_a, syms_a, sh_all, rs_sel, spec_sel = plan
        got.process_device(chunk, slots_a, syms_a, rs_sel, ce_rows, spec_sel,
                           spec, 0.5)
        jchunk = jprod.PduChunk(data=chunk.data, late=chunk.late,
                                fo=chunk.fo, ft=chunk.ft, sym0=chunk.sym0)
        rows = [ce_rows[p, :len(rs_sel[p])] for p in range(n_ports)]
        ref.process_device(jchunk, slots_a, syms_a, sh_all, rs_sel, rows,
                           spec_sel, spec, 0.5)
        assert (got.slot_num, got.sym_num) == (ref.slot_num, ref.sym_num)
    assert got._pend_cap > 512
    assert len(emits[0]) == len(emits[1]) > 0
    c, r = got.cell, ref.cell
    if reference == "per_port_chain":
        for a, b in zip(*emits):
            assert a[0] == b[0] and a[-2:] == b[-2:]
            for x, y in zip(a[1:-2], b[1:-2]):
                assert np.array_equal(x, y)
        assert got.state.frequency_offset == ref.state.frequency_offset
        assert c.frame_timing == r.frame_timing
        for f in ("ac_fd", "ac_td", "ce", "crs_tp_av", "crs_sp_raw_av",
                  "crs_np_av"):
            assert np.array_equal(getattr(c, f), getattr(r, f)), f
        assert np.array_equal(got._hist, ref._hist)
        assert np.array_equal(got._hist_pos, ref._hist_pos)
        for a, b in zip(got.rs_pending, ref.rs_pending):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    else:
        for a, b in zip(*emits):
            assert a[0] == b[0] and a[-2:] == b[-2:]
            for x, y in zip(a[1:-2], b[1:-2]):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-10)
        assert abs(got.state.frequency_offset
                   - ref.state.frequency_offset) < 1e-6
        assert abs(c.frame_timing - r.frame_timing) < 1e-8
        for f in ("ac_fd", "ac_td", "ce", "crs_tp_av", "crs_sp_raw_av",
                  "crs_np_av"):
            np.testing.assert_allclose(getattr(c, f), getattr(r, f),
                                       rtol=0, atol=1e-10, err_msg=f)
        for p in range(n_ports):
            np.testing.assert_allclose(got._hist[p], ref.ce_history[p][0],
                                       rtol=0, atol=1e-12)
            assert got._hist_pos[p] == ref.ce_history[p][1][0]
        for a, b in zip(got.rs_pending, ref.rs_pending):
            for x, y in zip(a, b):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
    assert all(len(a[0]) == 2 for a in got.rs_pending)
    assert c.mib_decode_failures == r.mib_decode_failures


@pytest.mark.parametrize("port,delta", [(0, 1), (0, -1), (1, 1)])
def test_device_loop_cell_call_rejects_miscounted_rows(lib, port, delta):
    """cell_rows_tick selects each port's rows itself; where its count
    and the planner's (len(rs_sel[p])) differ, the call raises instead
    of reading the wrong rows."""
    rng = np.random.default_rng(31)
    proc = tct.TrackedCellProcessor(
        *_pair("normal", 2, fo=50.0, frame_timing=100.0)[:1:-1])
    plan, chunk, ce_rows, _ = _rows_tick_inputs(rng, proc, 54)
    n_rows = np.array([len(s) for s in plan[3]], np.int64)
    n_rows[port] += delta
    with pytest.raises(RuntimeError, match="miscounted"):
        proc._cell_rows_tick(ce_rows, n_rows, *plan[:2], chunk.fo, chunk.ft)


def test_native_framing_matches_python_fallback(lib):
    """The port's native framing against the TPU package's Python loop
    across block edges, partial symbols, both CPs and moving registers:
    bit-identical PDU chunks (tests/test_tracker.py:426-472)."""
    rng = np.random.default_rng(9)
    n = int(0.12 * FS)
    sig = rng.normal(size=n) + 1j * rng.normal(size=n)
    for cp, ftiming in (("normal", 1234.5), ("extended", 0.25),
                        ("normal", 19199.0)):
        st_a, cell_a, st_b, cell_b = _pair(cp, 2, fo=3000.0,
                                           frame_timing=ftiming)
        ref = jprod.Producer(st_a)
        ref._native = None
        got = tprod.Producer(st_b)
        assert got._native is lib
        for i in range(0, n, 7777):
            ref.process(sig[i: i + 7777], [cell_a])
            got.process(sig[i: i + 7777], [cell_b])
            for st, c in ((st_a, cell_a), (st_b, cell_b)):
                st.frequency_offset += 1.0
                c.frame_timing = (c.frame_timing + 0.01) % 19200.0
        fa, fb = got.fifos[277], ref.fifos[277]
        assert len(fa) == len(fb) > 100
        ca, cb = fa.pop_upto(len(fa)), fb.pop_upto(len(fb))
        assert ca.sym0 == cb.sym0
        for f in ("data", "late", "fo", "ft"):
            np.testing.assert_array_equal(getattr(ca, f), getattr(cb, f))


def test_native_u8_conversion_matches_numpy_fallback(lib, monkeypatch):
    raw = np.random.default_rng(3).integers(0, 256, size=20000,
                                            dtype=np.uint8)
    raw[::97] = 255
    got = tnative.iq_u8_to_c64(raw)
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    want = jnative.iq_u8_to_c64(raw)
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_array_equal(got, want)


def test_mib_host_decode_chain_matches_tpu_package(lib, monkeypatch):
    """The MIB re-decode's host helpers: log-MAP demod, de-ratematch and
    the native Viterbi against the TPU package's numpy versions."""
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, size=40)
    d = jcoding.conv_encode(bits)
    e = jcoding.conv_ratematch(d, 1920)
    syms = jmod.lte_modulate(e, "qpsk") + 0.3 * (
        rng.normal(size=960) + 1j * rng.normal(size=960))
    npv = rng.uniform(0.05, 0.2, size=960)
    llr_t = tmod.lte_demodulate_host(syms, npv)
    llr_j = jmod.lte_demodulate_host(syms, npv)
    np.testing.assert_allclose(llr_t, llr_j, rtol=0, atol=1e-12)
    d_t = tcoding.conv_deratematch_host(llr_t, 40)
    d_j = jcoding.conv_deratematch_host(llr_j, 40)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-12)
    got = tcoding.conv_decode_tailbite_host(d_t)
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    want = jcoding.conv_decode_tailbite_host(d_j)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, bits)


@pytest.mark.parametrize("make", [
    lambda tst, tcell: tct.TrackedCellProcessor(tcell, tst),
    lambda tst, tcell: tprod.Producer(tst)],
    ids=["TrackedCellProcessor", "Producer"])
def test_tracker_requires_the_native_runtime(monkeypatch, make):
    """With the runtime unable to build, constructing the cell processor
    or the producer raises the compiler's RuntimeError (io/native.py::
    load) and takes no numpy path."""
    def no_compiler():
        raise RuntimeError("g++ failed: no compiler")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_stale", lambda: True)
    monkeypatch.setattr(tnative, "build", no_compiler)
    _st, _cell, tst, tcell = _pair("normal", 2)
    with pytest.raises(RuntimeError, match="no compiler"):
        make(tst, tcell)


def test_native_build_stays_out_of_native_dir(lib):
    assert tnative.LIB_PATH.is_file()
    assert tnative.LIB_PATH.parent != tnative.SOURCES[0].parent
    assert "-ffp-contract=off" in tnative.CXXFLAGS


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"freq_offset": 300.0, "snr_db": 5.0, "seed": 4},
    {"freq_offset": 2500.0, "coupled_fc": FC, "seed": 2},
], ids=["plain", "coupled"])
def test_sim_stream_is_bit_equal_to_tpu_package(kw):
    got = tcap.SimSource(**kw).stream(10000)
    want = jcap.SimSource(**kw).stream(10000)
    for _ in range(3):
        g, w = next(got), next(want)
        assert g.shape == w.shape == (10000,)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["u8", "it"])
def test_file_stream_is_bit_equal_to_tpu_package(tmp_path, kind):
    if kind == "u8":
        raw = np.random.default_rng(7).integers(0, 256, size=50000)
        path = str(tmp_path / "cap.u8")
        raw.astype(np.uint8).tofile(path)
    else:
        path = str(tmp_path / "cap.it")
        rng = np.random.default_rng(5)
        tit.write_itfile(path, {"capbuf": rng.normal(size=23000)
                                + 1j * rng.normal(size=23000),
                                "fc": np.array([int(FC)], np.int32)})
    kw = dict(drop_seconds=0.001, noise_power=0.01)
    got = list(tcap.FileSource([path, path], rng=np.random.default_rng(3),
                               **kw).stream(10000))
    want = list(jcap.FileSource([path, path], rng=np.random.default_rng(3),
                                **kw).stream(10000))
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    once = list(tcap.FileSource([path], **kw).stream(10000))
    rep = tcap.FileSource([path], repeat=True).stream(10000)
    blocks = [next(rep) for _ in range(len(once) + 1)]
    np.testing.assert_array_equal(blocks[-1], blocks[0])


# ---------------------------------------------------------------------------
# skip_ids
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_cells():
    rng = np.random.default_rng(22)
    a = create_dl_sig(JCpType.NORMAL, 80, 0, 92, 1, 0.4, rng=rng,
                      n_ports=2, sfn=4)
    b = create_dl_sig(JCpType.NORMAL, 80, 7, 90, 1, 0.4, rng=rng,
                      n_ports=2, sfn=8)
    return awgn(apply_freq_offset(a + 0.7 * b, 200.0), 12.0, rng=rng)


def _key(c):
    return (c.n_id_cell(), c.cp_type.value, c.n_rb_dl, c.n_ports, c.sfn)


@pytest.mark.parametrize("batch_peaks", [True, False],
                         ids=["batched", "peak-by-peak"])
def test_skip_ids_in_cell_search_match_tpu_package(two_cells, batch_peaks):
    """The searcher's single hypothesis (T = 3) on a two-cell capture:
    without skip_ids both cells decode; with 277 skipped only 271, as in
    the TPU package."""
    f_set = np.array([0.0])
    full = ts.cell_search(two_cells, f_set, FC, FC, FS,
                          ts.SearchConfig(batch_peaks=batch_peaks),
                          device="cpu")
    assert sorted(c.n_id_cell() for c in full) == [271, 277]
    jcfg = js.SearchConfig(skip_ids=frozenset({277}), batch_peaks=batch_peaks)
    want = js.cell_search(two_cells, f_set, FC, FC, FS, jcfg)
    got = ts.cell_search(two_cells, f_set, FC, FC, FS,
                         config_from_fields(dataclasses.asdict(jcfg)),
                         device="cpu")
    assert [_key(c) for c in got] == [_key(c) for c in want]
    assert [c.n_id_cell() for c in got] == [271]
    assert abs(got[0].freq_superfine - want[0].freq_superfine) < 1e-7


def test_skip_ids_in_scan_band_match_tpu_package():
    rng = np.random.default_rng(3)
    a = create_dl_sig(JCpType.NORMAL, 80, 0, 92, 1, 0.5, rng=rng, n_ports=2,
                      sfn=0)
    b = create_dl_sig(JCpType.NORMAL, 80, 0, 90, 1, 0.5, rng=rng, n_ports=1,
                      sfn=4)
    a = awgn(apply_freq_offset(a, 2500.0), 10.0, rng=rng)
    b = awgn(apply_freq_offset(b, -1500.0), 10.0, rng=rng)
    sigma = np.sqrt(np.mean(np.abs(a) ** 2) / 11.0 / 2.0)
    noise = (rng.normal(size=len(a)) + 1j * rng.normal(size=len(a))) * sigma
    fcs = (739.0e6, 739.1e6, 739.2e6)
    band = [(c, fc, fc) for c, fc in zip((a, noise, b), fcs)]
    f_set = np.arange(-5e3, 5e3 + 1, 5e3)
    jcfg = js.SearchConfig(skip_ids=frozenset({277}))
    want = jc.scan_band(band, f_set, FS, jcfg, mesh=jc.make_carrier_mesh(1),
                        dtype=np.complex128)
    got = tc.scan_band(band, f_set, FS,
                       config_from_fields(dataclasses.asdict(jcfg)),
                       device="cpu")
    assert [[_key(c) for c in cl] for cl in got] == \
        [[_key(c) for c in cl] for cl in want]
    assert [[c.n_id_cell() for c in cl] for cl in got] == [[], [], [271]]
