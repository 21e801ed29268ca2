"""The tracker tick's device program as a CUDA graph
(tracker/device_loop.py::_tick_program): the bucket key, the eager path
off the card, the module attribute the tick goes through, and on the
card the replayed graph against the eager program, bit for bit; and on
the card the tick's staging (stage_tick) through its reused pinned
arena against the CPU's, byte for byte.

This file imports neither JAX nor the TPU package; the card test skips
without a CUDA device, and runs on the card with

    python -m pytest --noconftest tests/test_torch_tick_graph.py -q
"""

from collections import OrderedDict

import pytest
import torch

from lte_cell_scanner_tpu_torch.tracker import device_loop
from lte_cell_scanner_tpu_torch.tracker.device_loop import (_bucket_key,
                                                            _tick_math,
                                                            _tick_program)
from tools_torch.bench_tracker_device import staged_cells, staged_tick

NAMES = ("planes", "data", "starts", "fln", "init_phase", "fc_requested",
         "fc_programmed", "fs_programmed", "rs_flat", "rs_tab", "spec_rows",
         "spec_mask")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def fresh(monkeypatch):
    """No bucket seen yet, no staging buffer, and the counts from
    zero."""
    monkeypatch.setattr(device_loop, "_graphs", OrderedDict())
    monkeypatch.setattr(device_loop, "_stagings", {})
    counts = dict.fromkeys(device_loop.tick_counts, 0)
    monkeypatch.setattr(device_loop, "tick_counts", counts)
    return counts


def _changed(args, name):
    """args with one dependency of the captured program changed."""
    a = dict(zip(NAMES, args))
    if name == "data instead of planes":
        a.update(planes=None, starts=None,
                 data=torch.zeros(a["fln"].shape[0], a["fln"].shape[2], 128,
                                  2, dtype=torch.float64))
    elif name == "device":
        a["rs_tab"] = torch.empty(a["rs_tab"].shape, dtype=a["rs_tab"].dtype,
                                  device="meta")
    elif name.endswith(" dtype"):
        k = name.split()[0]
        a[k] = a[k].to(torch.float32)
    elif name.endswith(" shape"):
        k = name.split()[0]
        a[k] = torch.cat([a[k], a[k][:1]])
    else:
        a[name] = float(a[name]) + 1.0
    return tuple(a[k] for k in NAMES)


@pytest.mark.parametrize("name", [
    "planes shape", "planes dtype", "starts shape", "fln shape",
    "fln dtype", "init_phase shape", "init_phase dtype", "rs_flat shape",
    "rs_tab shape", "rs_tab dtype", "spec_rows shape", "spec_mask shape",
    "spec_mask dtype", "data instead of planes", "device", "fc_requested",
    "fc_programmed", "fs_programmed"])
def test_bucket_key_changes_with_each_dependency(name):
    args = staged_tick(2, 32, "cpu", adc_grid=True)
    assert _bucket_key(_changed(args, name)) != _bucket_key(args)


def test_bucket_key_equal_for_other_contents():
    """Other values in tensors of the same shapes, dtypes and device, and
    equal frequencies in other objects: one bucket."""
    a = staged_tick(2, 32, "cpu", adc_grid=True)
    b = staged_tick(2, 32, "cpu", adc_grid=True, seed=1)
    assert not torch.equal(a[0], b[0])
    b = b[:5] + tuple(float(str(x)) for x in b[5:8]) + b[8:]
    assert _bucket_key(a) == _bucket_key(b)
    assert _bucket_key(a) != _bucket_key(
        staged_tick(2, 32, "cpu", adc_grid=False))


def test_tick_program_runs_eagerly_on_the_cpu(fresh):
    """Off the card every tick runs _tick_math eagerly, into a fresh
    tensor each call, and nothing is captured."""
    args = staged_tick(2, 32, "cpu", adc_grid=True)
    want = _tick_math(*args)
    outs = [_tick_program(*args) for _ in range(3)]
    assert all(torch.equal(o, want) for o in outs)
    assert len({o.data_ptr() for o in outs}) == 3
    assert fresh == {"captures": 0, "replays": 0, "eager": 3,
                     "evictions": 0, "wire_f16": 1, "wire_f64": 0,
                     "arenas": 0}
    assert not device_loop._graphs


def test_batched_tick_extract_goes_through_the_module_attribute(
        monkeypatch):
    """A tick looks _tick_program up on the module at each call, so a
    patched attribute sees every tick (the benchmark's watch and its
    complex64 control patch it); on the CPU no capture span opens."""
    seen = []
    real = device_loop._tick_program

    def watch(*args):
        assert len(args) == 12
        seen.append(real(*args))
        return seen[-1]

    monkeypatch.setattr(device_loop, "_tick_program", watch)
    timings = {}
    for seed in range(3):
        pairs, state, block = staged_cells(2, 32, adc_grid=True, seed=seed)
        device_loop.batched_tick_extract(pairs, state, raw_block=block,
                                         block_seq=1, device="cpu",
                                         timings=timings)
    assert len(seen) == 3
    assert "program.launch" in timings and "program.capture" not in timings
    assert device_loop._launching.timings is None


@pytest.mark.parametrize("adc_grid,work", [
    (True, torch.float64), (False, torch.float64), (True, torch.float32)],
    ids=["float16-planes", "float64-planes", "complex64"])
def test_replayed_tick_equals_the_eager_program_bit_for_bit(
        cuda, fresh, adc_grid, work):
    """Two buckets, five ticks each with other contents every tick: the
    first runs eagerly, the second captures, the rest replay.  Each
    output equals _tick_math's on the same arguments bit for bit, and
    stays as it was returned while later ticks of its bucket replay
    (the static output is cloned)."""
    ticks = 5
    kept = []
    for B, S in ((4, 64), (2, 128)):
        for seed in range(ticks):
            args = staged_tick(B, S, cuda, adc_grid=adc_grid, seed=seed)
            if work is torch.float32:      # the benchmark's complex64 control
                args = tuple(a.float() if isinstance(a, torch.Tensor)
                             and a.dtype == torch.float64 else a
                             for a in args)
            out = _tick_program(*args)
            want = _tick_math(*args)
            assert out.dtype == work and torch.equal(out, want), (B, seed)
            kept.append((out, want.clone()))
    for out, want in kept:
        assert torch.equal(out, want)
    # the arena grows once for each bucket: (2, 128)'s block is longer
    assert fresh == {"captures": 2, "replays": 2 * (ticks - 2), "eager": 2,
                     "evictions": 0, "wire_f16": 2 * ticks * adc_grid,
                     "wire_f64": 2 * ticks * (not adc_grid), "arenas": 2}
    assert len(device_loop._graphs) == 2


def test_least_recently_used_graph_is_evicted(cuda, fresh, monkeypatch):
    """With room for one bucket, a second bucket's first tick drops the
    first's graph, which is captured anew when it comes back."""
    monkeypatch.setattr(device_loop, "_GRAPHS_MAX", 1)
    a = staged_tick(2, 64, cuda, adc_grid=True)
    b = staged_tick(2, 128, cuda, adc_grid=True)
    for args in (a, a, a, b, a, a):
        assert torch.equal(_tick_program(*args), _tick_math(*args))
    assert fresh == {"captures": 2, "replays": 1, "eager": 3,
                     "evictions": 1, "wire_f16": 2, "wire_f64": 0,
                     "arenas": 2}


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().numpy().tobytes()


@pytest.mark.parametrize("adc_grid", [True, False],
                         ids=["float16-planes", "float64-planes"])
def test_staged_tick_on_the_card_equals_the_cpu_and_stays(cuda, fresh,
                                                          adc_grid):
    """Six ticks of one bucket staged for the card, each with other
    contents, and each staged for the CPU too: every argument on the
    card equals the CPU's byte for byte, and the plans equal; the pinned
    arena, allocated at the first tick, serves every later one; and no
    tick's arguments or plans change while the later ticks are staged
    (each copy lands in a fresh device buffer; the arena is rewritten
    only once the copy from it completed)."""
    kept = []
    for seed in range(6):
        pairs, state, block = staged_cells(4, 64, adc_grid, seed)
        args, plans, shape = device_loop.stage_tick(
            pairs, state, raw_block=block, block_seq=1, device=cuda)
        want, want_plans, want_shape = device_loop.stage_tick(
            pairs, state, raw_block=block, block_seq=1, device="cpu")
        assert shape == want_shape
        for name, g, w in zip(NAMES, args, want):
            if isinstance(w, torch.Tensor):
                assert g.device.type == "cuda" and g.dtype == w.dtype \
                    and g.shape == w.shape, name
                assert _bytes(g) == _bytes(w), (seed, name)
            else:
                assert g == w, name
        for p, w in zip(plans, want_plans):
            for x, y in zip(p[:3] + (p[4],), w[:3] + (w[4],)):
                assert x.tobytes() == y.tobytes()
            assert [s.tolist() for s in p[3]] == [s.tolist() for s in w[3]]
        if seed == 0:
            arenas = fresh["arenas"]
        kept.append((args, plans, [_bytes(a) for a in args
                                   if isinstance(a, torch.Tensor)],
                     [p[0].tobytes() + p[1].tobytes() for p in plans]))
    assert fresh["arenas"] == arenas == 1
    assert fresh["wire_f16" if adc_grid else "wire_f64"] == 12
    for args, plans, arg_bytes, plan_bytes in kept:
        assert [_bytes(a) for a in args
                if isinstance(a, torch.Tensor)] == arg_bytes
        assert [p[0].tobytes() + p[1].tobytes() for p in plans] == \
            plan_bytes
