"""Pure-Python reader/writer for the IT++ ``.it`` container (version 3).

The reference stores captures and golden test vectors in this format
(written via itpp ``it_file``; loaded at reference src/capbuf.cpp:98-115).
Layout (little-endian):

    magic "IT++", uint8 version (=3), then per variable:
      uint64 hdr_bytes | uint64 data_bytes | uint64 block_bytes
      name cstring | type cstring   # dvec,ivec,bvec,dcvec,dmat,imat,dcmat,...
      payload @ offset hdr_bytes, length data_bytes:
        vectors: uint64 n, then n elements; mats: uint64 rows, uint64 cols,
        elements column-major
      elements: d*=float64, dc*=interleaved float64 re/im, i*=int32,
        b*=1 byte per bit

No IT++ dependency is needed; this loader was validated against the three
shipped reference files (capbuf_0000.it, test_peak_search.it,
test_sss_detect.it).
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

_MAGIC = b"IT++"

_VEC_DTYPES = {
    "dvec": (np.float64, 8, False),
    "ivec": (np.int32, 4, False),
    "bvec": (np.uint8, 1, False),
    "dcvec": (np.complex128, 16, False),
    "fvec": (np.float32, 4, False),
    "fcvec": (np.complex64, 8, False),
    "dmat": (np.float64, 8, True),
    "imat": (np.int32, 4, True),
    "bmat": (np.uint8, 1, True),
    "dcmat": (np.complex128, 16, True),
    "fmat": (np.float32, 4, True),
    "fcmat": (np.complex64, 8, True),
    "float64": (np.float64, 8, None),   # scalar
    "int32": (np.int32, 4, None),
    "bin": (np.uint8, 1, None),
}


def _read_cstring(buf: bytes, off: int):
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("ascii"), end + 1


def read_itfile(path: str) -> Dict[str, np.ndarray]:
    """Read every variable in an .it file into a dict of numpy arrays."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != _MAGIC:
        raise ValueError(f"{path}: not an IT++ file")
    version = raw[4]
    if version != 3:
        raise ValueError(f"{path}: unsupported .it version {version}")

    out: Dict[str, np.ndarray] = {}
    pos = 5
    n = len(raw)
    while pos + 24 <= n:
        hdr_bytes, data_bytes, block_bytes = struct.unpack_from("<QQQ", raw, pos)
        if block_bytes == 0 or pos + block_bytes > n:
            break
        name, off = _read_cstring(raw, pos + 24)
        typ, _ = _read_cstring(raw, off)
        payload = raw[pos + hdr_bytes: pos + hdr_bytes + data_bytes]
        if typ in _VEC_DTYPES:
            dtype, esize, is_mat = _VEC_DTYPES[typ]
            if is_mat is None:  # scalar
                out[name] = np.frombuffer(payload[:esize], dtype=dtype)[0]
            elif is_mat:
                rows, cols = struct.unpack_from("<QQ", payload, 0)
                data = np.frombuffer(payload, dtype=dtype, count=rows * cols,
                                     offset=16)
                # stored column-major
                out[name] = data.reshape(cols, rows).T.copy()
            else:
                (cnt,) = struct.unpack_from("<Q", payload, 0)
                out[name] = np.frombuffer(payload, dtype=dtype, count=cnt,
                                          offset=8).copy()
        # unknown types are skipped silently
        pos += block_bytes
    return out


def _pack_var(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.ndim == 0:
        arr = arr.reshape(1)
    if arr.ndim == 1:
        if np.iscomplexobj(arr):
            typ, data_arr = "dcvec", arr.astype(np.complex128)
        elif arr.dtype.kind in "iub":
            typ, data_arr = "ivec", arr.astype(np.int32)
        else:
            typ, data_arr = "dvec", arr.astype(np.float64)
        body = struct.pack("<Q", arr.shape[0]) + data_arr.tobytes()
    elif arr.ndim == 2:
        if np.iscomplexobj(arr):
            typ, data_arr = "dcmat", arr.astype(np.complex128)
        elif arr.dtype.kind in "iub":
            typ, data_arr = "imat", arr.astype(np.int32)
        else:
            typ, data_arr = "dmat", arr.astype(np.float64)
        body = (struct.pack("<QQ", arr.shape[0], arr.shape[1])
                + data_arr.T.copy().tobytes())  # column-major
    else:
        raise ValueError("only 1-D/2-D arrays supported")

    name_b = name.encode("ascii") + b"\x00"
    typ_b = typ.encode("ascii") + b"\x00"
    hdr_bytes = 24 + len(name_b) + len(typ_b)
    data_bytes = len(body)
    block_bytes = hdr_bytes + data_bytes
    return (struct.pack("<QQQ", hdr_bytes, data_bytes, block_bytes)
            + name_b + typ_b + body)


def write_itfile(path: str, variables: Dict[str, np.ndarray]) -> None:
    """Write a dict of numpy arrays as an IT++ v3 .it file."""
    with open(path, "wb") as f:
        f.write(_MAGIC + bytes([3]))
        for name, arr in variables.items():
            f.write(_pack_var(name, arr))
