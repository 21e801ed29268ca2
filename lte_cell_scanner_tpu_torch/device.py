"""Device and dtype policy of the port.

Entry points run on the card unless the caller names another device.
On CUDA the working types are complex64/float32 (the accelerator's
types); on the CPU they stay complex128/float64 so results can be held
against the reference implementation at its double-precision tolerances.

The one place where the card computes in float64/complex128 is the
tracker's tick (tracker/batched.py, tracker/device_loop.py), as the
reference implementation's tick asks for double precision: its
per-symbol phase register is a cumulative sum carried across the whole
stream, and the host's float64 control loops read its rows.  The tick
is bound by its ~50 small launches, not by arithmetic, so float64 costs
it nothing that the host's own spread does not hide (PERF.md §6).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; anything else as torch reads it."""
    return torch.device("cuda" if device is None else device)


def visible_devices(device=None) -> List[torch.device]:
    """The devices a multi-device layout of ``device``'s type may take
    (None = the card): every visible card for CUDA, the one host device
    otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def pick_devices(n: int, devices=None, what: str = "layout"
                 ) -> List[torch.device]:
    """The first ``n`` of ``devices`` (None = every visible card) as
    ``torch.device``s; a list may repeat a device.  Raises when there are
    fewer than ``n``: a layout never shrinks to the devices it finds."""
    devs = visible_devices() if devices is None \
        else [torch.device(d) for d in devices]
    if n < 1 or len(devs) < n:
        raise ValueError(f"the {what} needs {n} devices, "
                         f"{len(devs)} given or visible")
    return devs[:n]


def complex_dtype(device: torch.device) -> torch.dtype:
    return torch.complex64 if device.type == "cuda" else torch.complex128


def real_dtype(device: torch.device) -> torch.dtype:
    return torch.float32 if device.type == "cuda" else torch.float64


def to_capture(capbuf, device: torch.device) -> torch.Tensor:
    """A host capture as a complex tensor in the device's working type."""
    if isinstance(capbuf, torch.Tensor):
        return capbuf.to(device=device, dtype=complex_dtype(device))
    arr = np.asarray(capbuf).astype(
        np.complex64 if device.type == "cuda" else np.complex128)
    return torch.from_numpy(arr).to(device)


def tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """Host array -> tensor on ``device`` (float/complex follow the
    device's working precision unless ``dtype`` is given)."""
    arr = np.asarray(x)
    if dtype is None:
        if np.iscomplexobj(arr):
            dtype = complex_dtype(device)
        elif np.issubdtype(arr.dtype, np.floating):
            dtype = real_dtype(device)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype) if dtype is not None \
        else t.to(device)
