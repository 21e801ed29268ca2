"""The device loop's host staging of a tick (tracker/device_loop.py::
stage_tick over csrc/stage_tick.cpp) against the TPU package's staging,
on the CPU.

The TPU package's tick (lte_cell_scanner_tpu/tracker/device_loop.py::
batched_tick_extract) hands its staged arguments to ``_extract_core``;
the tests catch them there and rebuild the port's layout from them: the
planes from ``ext_re``/``ext_im``, ``rs_flat``/``rs_tab`` from
``rs_pack`` and ``conj_planes``, ``spec_rows``/``spec_mask`` from
``spec_idx``.  The port's staged arguments must equal them exactly, and
its wire type must be ``ops/corr_cuda.py::is_adc_grid``'s decision.
A tick's tensors and plans must stay as they were after the next tick is
staged, and the staging counters count.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lte_cell_scanner_tpu.cell import CpType as JCpType
from lte_cell_scanner_tpu.tracker import cell_tracker as jct
from lte_cell_scanner_tpu.tracker import device_loop as jdl
from lte_cell_scanner_tpu.tracker import producer as jprod
from lte_cell_scanner_tpu.tracker import state as jstate
from lte_cell_scanner_tpu_torch.interop import (global_state_from_fields,
                                                tracked_cell_from_fields)
from lte_cell_scanner_tpu_torch.ops import corr_cuda
from lte_cell_scanner_tpu_torch.tracker import cell_tracker as tct
from lte_cell_scanner_tpu_torch.tracker import device_loop as tdl
from lte_cell_scanner_tpu_torch.tracker import producer as tprod

FS = 1.92e6
FC = 739e6
SEQ = 7
L = 9003          # an odd length: the grid pass ends in its scalar tail


class _Caught(Exception):
    pass


@pytest.fixture
def fresh(monkeypatch):
    """The staging counters from zero, and no staging buffer yet."""
    counts = dict.fromkeys(tdl.tick_counts, 0)
    monkeypatch.setattr(tdl, "tick_counts", counts)
    monkeypatch.setattr(tdl, "_stagings", {})
    return counts


def _grid_block(rng, n=L):
    """A block on the dongle's 8-bit (x - 127)/128 grid."""
    z = rng.integers(-127, 129, size=(n, 2)) / 128.0
    return z[:, 0] + 1j * z[:, 1]


def _cells(rng, block, main):
    """Four cells on one block, each a (TPU package processor, port
    processor, PduChunk of each): the ``main`` cell (CP, ports) with a
    straddler and a window past the block's end, then a 2-port cell
    whose chunk is of a stale block, a 4-port cell whose chunk carries
    no starts and a 1-port extended-CP cell.  Their (slot, sym) counters
    put the sync and PBCH symbols in the tick."""
    specs = [(277,) + main + (40, 5, "block", (0, 0), 3),
             (301, "normal", 2, 29, 61, "stale", (9, 5), 0),
             (100, "normal", 4, 33, 17, "none", (19, 2), 6),
             (52, "extended", 1, 12, 300, "block", (0, 4), 2)]
    out = []
    for n_id, cp, ports, n, first, starts_kind, (slot, sym), sym0 in specs:
        st = jstate.GlobalState(fc_requested=FC, fc_programmed=FC,
                                fs_programmed=FS)
        cell = jstate.TrackedCell(n_id_cell=n_id, n_id_1=n_id // 3,
                                  n_id_2=n_id % 3, cp_type=JCpType(cp),
                                  n_ports=ports, frame_timing=0.0)
        jp = jct.TrackedCellProcessor(cell, st)
        tp = tct.TrackedCellProcessor(
            tracked_cell_from_fields(dataclasses.asdict(cell)),
            global_state_from_fields(dataclasses.asdict(st)))
        stride = 160 if cp == "extended" else 137
        starts = (first + stride * np.arange(n)).astype(np.int64)
        data = np.stack([block[s: s + 128] for s in starts])
        if starts_kind == "block":
            starts[3] = -1                   # a straddler
            data[3] = block[-1:-129:-1]      # its own window, not in block
            starts[-1] = len(block) - 100    # its window runs past the end
            data[-1] = block[-128:]
        kw = dict(data=data, late=rng.uniform(-0.5, 2.0, size=n),
                  fo=250.0 + rng.normal(size=n), ft=np.zeros(n), sym0=sym0,
                  start=None if starts_kind == "none" else starts,
                  block_seq=SEQ - 1 if starts_kind == "stale" else SEQ)
        phase = rng.uniform(-np.pi, np.pi)
        for p in (jp, tp):
            p.slot_num, p.sym_num = slot, sym
            p.bulk_phase_offset = phase
        out.append((jp, tp, jprod.PduChunk(**kw), tprod.PduChunk(**kw)))
    return out


def _tpu_staged(monkeypatch, cells, raw):
    """The TPU package's _extract_core arguments for the tick."""
    caught = []

    def catch(*args):
        caught.append(args)
        raise _Caught
    monkeypatch.setattr(jdl, "_extract_core", catch)
    with pytest.raises(_Caught):
        jdl.batched_tick_extract([(c[0], c[2]) for c in cells],
                                 cells[0][0].state, raw_block=raw,
                                 block_seq=SEQ)
    (ext_re, ext_im, data, starts, fln, init_phase, _fcr, _fcp, _fsp,
     rs_pack, spec_idx, conj_planes), = caught
    B, P, NR, _ = rs_pack.shape
    S = fln.shape[2]
    b = np.arange(B)[:, None, None]
    sym = rs_pack[..., 0].astype(np.int64)
    ok = sym >= 0
    flat = ((b * S + sym) * 72 + rs_pack[..., 1])[..., None] \
        + 6 * np.arange(12)
    tab = conj_planes[b, rs_pack[..., 2]]               # [B, P, NR, 12, 2]
    spec = spec_idx.astype(np.int64)
    want = {
        "planes": None if ext_re is None else np.stack([ext_re, ext_im], -1),
        "data": None if data is None
        else np.ascontiguousarray(data).view(np.float64).reshape(
            data.shape + (2,)),
        "starts": starts, "fln": fln, "init_phase": init_phase,
        "rs_flat": np.where(ok[..., None], flat, 0),
        "rs_tab": np.where(ok[..., None, None], tab, 0.0),
        "spec_rows": np.where(spec >= 0, np.arange(B)[:, None] * S + spec, 0),
        "spec_mask": (spec >= 0).astype(np.float64)}
    return want, rs_pack, spec_idx


NAMES = ("planes", "data", "starts", "fln", "init_phase", "fc_requested",
         "fc_programmed", "fs_programmed", "rs_flat", "rs_tab", "spec_rows",
         "spec_mask")


def _assert_staged_equal(args, plans, shape, want, rs_pack, spec_idx):
    got = dict(zip(NAMES, args))
    for k, w in want.items():
        g = got[k]
        assert (g is None) == (w is None), k
        if w is None:
            continue
        g = g.numpy()
        assert g.shape == w.shape, k
        if k == "starts":
            np.testing.assert_array_equal(g, w)
        else:
            assert g.dtype == w.dtype, k
            # bit for bit
            assert g.tobytes() == np.ascontiguousarray(w).tobytes(), k
    assert shape == rs_pack.shape[:3] + spec_idx.shape[1:]
    for b, (_slots, _syms, _sh, rs_sel, spec_sel) in enumerate(plans):
        for p, sel in enumerate(rs_sel):
            np.testing.assert_array_equal(sel, rs_pack[b, p, :len(sel), 0])
            assert len(sel) == (rs_pack[b, p, :, 0] >= 0).sum()
        np.testing.assert_array_equal(spec_sel, spec_idx[b, :len(spec_sel)])
        assert len(spec_sel) == (spec_idx[b] >= 0).sum()


@pytest.mark.parametrize("route", ["raw-block", "window-copies"])
@pytest.mark.parametrize("cp,ports", [
    ("normal", 1), ("normal", 2), ("normal", 4), ("extended", 1),
    ("extended", 2), ("extended", 4)])
def test_staged_tick_equals_tpu_package(monkeypatch, fresh, route, cp,
                                        ports):
    """Four cells of one tick (the main cell's CP and ports, a straddler,
    a window past the block's end, a stale block's chunk, a chunk without
    starts; sync and PBCH symbols in the tick) on a float block: every
    staged argument and the plans' RS and special rows equal the TPU
    package's."""
    rng = np.random.default_rng(ports + 10 * (cp == "extended"))
    block = rng.normal(size=L) + 1j * rng.normal(size=L)
    cells = _cells(rng, block, (cp, ports))
    raw = block if route == "raw-block" else None
    want = _tpu_staged(monkeypatch, cells, raw)
    args, plans, shape = tdl.stage_tick(
        [(c[1], c[3]) for c in cells], cells[0][1].state, raw_block=raw,
        block_seq=SEQ, device="cpu")
    _assert_staged_equal(args, plans, shape, *want)
    assert fresh["wire_f64"] == 1


@pytest.mark.parametrize("case,where", [
    ("on-grid", "block"), ("saturated", "block"), ("off-2e-5", "block"),
    ("off-2e-5", "block-tail"), ("off-2e-5", "appendix"),
    ("off-5e-6", "block"), ("off-5e-6", "appendix"), ("half-tie", "block")])
def test_wire_type_is_the_adc_grid_decision(monkeypatch, fresh, case,
                                            where):
    """A block on the 8-bit grid, with one sample changed: a saturated
    +128 code (on the grid), or off the grid by 2e-5 (out) or 5e-6
    (within is_adc_grid's 1e-5) of a code, in the block, in its last
    samples (the grid pass's scalar tail) or in a straddler's window
    only (the appendix), or just above half float16's least subnormal
    (on the grid; float16 of its float32 rounds the other way).  The wire
    type is is_adc_grid's decision on the extended block, the planes
    equal the TPU package's bit for bit."""
    rng = np.random.default_rng(3)
    block = _grid_block(rng)
    cells = _cells(rng, block, ("normal", 2))
    k = {"on-grid": 0.0, "saturated": 0.0, "off-2e-5": 2e-5,
         "off-5e-6": 5e-6, "half-tie": 0.0}[case]
    if case == "saturated":
        block[100] = 1.0 + 1j * block[100].imag
    elif case == "half-tie":
        block[100] = 2.0 ** -25 * (1 + 2.0 ** -30) + 1j * block[100].imag
    elif where == "block":
        block[100] += k / 128
    elif where == "block-tail":
        block[-1] += 1j * k / 128
    else:
        cells[0][2].data[3, 7] += k / 128      # the straddler's window
    ext_grid = corr_cuda.is_adc_grid(np.concatenate(
        [block] + [c[2].data.ravel() for c in cells]))
    assert ext_grid == (case != "off-2e-5")
    want = _tpu_staged(monkeypatch, cells, block)
    args, plans, shape = tdl.stage_tick(
        [(c[1], c[3]) for c in cells], cells[0][1].state, raw_block=block,
        block_seq=SEQ, device="cpu")
    assert args[0].dtype == (torch.float16 if ext_grid else torch.float64)
    _assert_staged_equal(args, plans, shape, *want)
    assert (fresh["wire_f16"], fresh["wire_f64"]) == \
        ((1, 0) if ext_grid else (0, 1))


def test_a_tick_stays_as_staged_after_the_next(fresh):
    """Each tick's tensors and plans are its own: staging the next tick
    (of the same shapes) leaves them as they were.  The wire counters
    count each tick's type; off the card no arena is allocated."""
    kept = []
    for seed, grid in ((0, True), (1, False), (2, True)):
        rng = np.random.default_rng(seed)
        block = _grid_block(rng) if grid \
            else rng.normal(size=L) + 1j * rng.normal(size=L)
        cells = _cells(rng, block, ("normal", 2))
        args, plans, _ = tdl.stage_tick(
            [(c[1], c[3]) for c in cells], cells[0][1].state,
            raw_block=block, block_seq=SEQ, device="cpu")
        snap = ([a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args],
                [tuple(np.array(x) for x in p[:3]) + (
                    [np.array(s) for s in p[3]], np.array(p[4]))
                 for p in plans])
        kept.append(((args, plans), snap))
    for (args, plans), (args0, plans0) in kept:
        for a, a0 in zip(args, args0):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, a0)
        for p, p0 in zip(plans, plans0):
            for x, x0 in zip(p[:3] + (p[4],), p0[:3] + (p0[4],)):
                np.testing.assert_array_equal(x, x0)
            for s, s0 in zip(p[3], p0[3]):
                np.testing.assert_array_equal(s, s0)
    assert {k: fresh[k] for k in ("wire_f16", "wire_f64", "arenas")} == \
        {"wire_f16": 2, "wire_f64": 1, "arenas": 0}
