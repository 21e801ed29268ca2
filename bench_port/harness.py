"""The harness's device side: synchronising, the peak of device memory,
the device's description, and the profiled stretch of a traced run.

The profiled stretch runs after the stage-timed window, with the stage
timers off (they synchronise, which would change what the profiler
sees): ``drv.profile_steps()`` steps of the cell under torch.profiler,
inside one ``bench.window`` range whose span is ``window_s``.  From the
profiler's events: the device's busy seconds (the union of its
operations' intervals), each kernel's count and seconds by name, the
ten device operations that took most time and the ten longest idle
gaps, each named by the innermost host operation running at its middle.
"""

from __future__ import annotations

import re
from typing import Dict, List

import torch

from .frozen import trace

WINDOW = "bench.window"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def device_info(device, count: int, mem: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": count,
            "memory_peak_bytes": mem}


def _events(prof):
    """(device intervals, host intervals, window (lo, hi)) in µs."""
    from torch.autograd import DeviceType
    dev: List[trace.Interval] = []
    host: List[trace.Interval] = []
    lo = hi = None
    for e in prof.events():
        iv = (float(e.time_range.start), float(e.time_range.end), e.name)
        if e.name == WINDOW:
            # the range shows on the host and, as an annotation, on the
            # device's timeline too: neither is an operation
            if e.device_type != DeviceType.CUDA:
                lo, hi = iv[0], iv[1]
        elif e.device_type == DeviceType.CUDA:
            dev.append(iv)
        else:
            host.append(iv)
    return dev, host, (lo, hi)


def _short(name: str) -> str:
    """A kernel's name without namespaces, return type and argument
    list, at most 120 characters."""
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += (ch == "<") - (ch == ">")
        out.append(ch)
    return "".join(out).strip()[:120]


def profile(drv, device) -> Dict:
    """Profile ``drv.profile_steps()`` steps; returns busy_s, window_s,
    kernels {name: (count, seconds)}, profile_units and breakdown."""
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n = drv.profile_steps()
    sync(device)
    units = 0
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                units += drv.step(None)
            sync(device)
    dev, host, (lo, hi) = _events(prof)
    busy = trace.busy_us(dev, lo, hi)
    kernels = {k: (c, t * 1e-6) for k, (c, t) in trace.by_name(dev).items()}
    top = sorted(((_short(k), t) for k, (c, t) in kernels.items()),
                 key=lambda kv: -kv[1])[:10]
    idle = [[trace.host_label(host, 0.5 * (s + e)), (e - s) * 1e-6]
            for s, e in trace.gaps(dev, lo, hi)[:10]]
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6,
            "kernels": kernels, "profile_units": units, "profile_steps": n,
            "breakdown": {"device_ops": [list(kv) for kv in top],
                          "idle_gaps": idle}}

