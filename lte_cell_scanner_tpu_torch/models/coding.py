"""Channel coding: tail-biting convolutional code, rate matching, CRC.

Behavioral contracts (reference src/lte_lib.cpp):

- lte_conv_encode / lte_conv_decode (:520-551): K=7 tail-biting
  convolutional code, generators (133,171,165) octal, soft-input decode.
- lte_conv_ratematch / lte_conv_deratematch (:409-518): PBCH sub-block
  interleaver (32-column permutation) + circular-buffer bit selection; the
  de-ratematcher averages repeated LLR observations.
- lte_calc_crc (:637-663): CRC8/16/24A/24B as polynomial division parity.

The encoder, rate matcher and CRC are host numpy (the simulator's
transmitter and the decoder's tables); the de-ratematcher and the
tail-biting Viterbi decoder run on tensors with a leading batch axis,
and again on the host for one codeword (``*_host``: the tracker's MIB
re-decode, whose Viterbi is the native runtime's).
The decoder runs all 64 start-state hypotheses at once (the IT++
decode_tailbite contract: best metric among start==end constrained
paths) as a Python loop over the trellis steps.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# Generators (133,171,165) octal, MSB = current input bit (g[0] = D^0 tap).
_GENS = (0o133, 0o171, 0o165)
_K = 7


def _gen_taps() -> np.ndarray:
    """[3, 7] 0/1 taps: g[i, j] = coefficient of D^j in generator i."""
    taps = np.zeros((3, _K), dtype=np.uint8)
    for i, g in enumerate(_GENS):
        for j in range(_K):
            taps[i, j] = (g >> (_K - 1 - j)) & 1
    return taps


def conv_encode(c: np.ndarray) -> np.ndarray:
    """Tail-biting convolutional encode: bits [n] -> [3, n].

    d[i, k] = sum_j g_i[j] * c[(k - j) mod n]  (state preloaded with the
    last K-1 input bits, reference lte_lib.cpp:520-533).
    """
    c = np.asarray(c, dtype=np.uint8)
    n = c.shape[0]
    taps = _gen_taps()
    d = np.zeros((3, n), dtype=np.uint8)
    for j in range(_K):
        shifted = np.roll(c, j)
        for i in range(3):
            if taps[i, j]:
                d[i] ^= shifted
    return d


@lru_cache(maxsize=None)
def _trellis(n_states: int = 64):
    """Trellis tables: next_state[state, bit], out_bits[state, bit, 3].

    State = (c_{k-1} ... c_{k-6}) packed with c_{k-1} as the MSB.
    """
    taps = _gen_taps()
    next_state = np.zeros((n_states, 2), dtype=np.int32)
    out_bits = np.zeros((n_states, 2, 3), dtype=np.int8)
    for s in range(n_states):
        past = [(s >> (5 - i)) & 1 for i in range(6)]  # c_{k-1}..c_{k-6}
        for b in range(2):
            window = [b] + past  # c_k, c_{k-1}, ..., c_{k-6}
            for i in range(3):
                out_bits[s, b, i] = int(np.bitwise_xor.reduce(
                    [window[j] & taps[i, j] for j in range(_K)]))
            next_state[s, b] = (b << 5) | (s >> 1)
    return next_state, out_bits


@lru_cache(maxsize=None)
def _predecessors() -> np.ndarray:
    """[64, 2] flat (old_state * 2 + bit) edge index of each new state's
    two predecessors."""
    next_state, _ = _trellis()
    flat_target = next_state.reshape(-1)
    preds = np.zeros((64, 2), dtype=np.int64)
    for t in range(64):
        preds[t] = np.nonzero(flat_target == t)[0]
    return preds


def conv_decode_tailbite(d_llr: torch.Tensor) -> torch.Tensor:
    """Soft tail-biting Viterbi decode: LLRs [N, 3, n] -> bits [N, n]
    (int64), d_llr[.., i, k] = ln(P(d==0)/P(d==1)).  The winner of each
    row is the best path with start == end state."""
    dev = d_llr.device
    rdt = d_llr.dtype
    n_cw, _, n = d_llr.shape
    _next_state, out_bits = _trellis()
    preds_np = _predecessors()
    preds = torch.from_numpy(preds_np).to(dev)
    # branch "gain": sum_i llr_i * (+1 if out bit 0 else -1) / 2
    signs = torch.from_numpy(1 - 2 * out_bits.astype(np.int64)).to(dev, rdt)
    eye = torch.eye(64, dtype=torch.bool, device=dev)
    pm = torch.where(eye, torch.zeros((), dtype=rdt, device=dev),
                     torch.full((), -1e30, dtype=rdt, device=dev))
    pm = pm.expand(n_cw, 64, 64)                       # [N, start, state]

    choices = []
    for k in range(n):
        gain = torch.einsum("sbi,ni->nsb", signs, d_llr[:, :, k]) * 0.5
        cand = (pm[:, :, :, None] + gain[:, None]).reshape(n_cw, 64, 128)
        c2 = cand[:, :, preds]                          # [N, start, new, 2]
        choice = torch.argmax(c2, dim=-1)               # first max wins
        pm = torch.gather(c2, 3, choice[..., None])[..., 0]
        choices.append(choice)

    # enforce start == end, pick the best start-state hypothesis
    rows = torch.arange(n_cw, device=dev)
    best_start = torch.argmax(torch.diagonal(pm, dim1=1, dim2=2), dim=1)
    pred_state = torch.from_numpy(preds_np // 2).to(dev)
    pred_bit = torch.from_numpy(preds_np % 2).to(dev)
    bits = [None] * n
    state = best_start
    for k in range(n - 1, -1, -1):
        b = choices[k][rows, best_start, state]
        bits[k] = pred_bit[state, b]
        state = pred_state[state, b]
    return torch.stack(bits, dim=1)


def conv_decode_tailbite_host(d_llr: np.ndarray) -> np.ndarray:
    """Host tail-biting Viterbi with conv_decode_tailbite's contract for
    one codeword, LLRs [3, n] -> bits [n] (int32), in the native runtime
    (native/tracker_math.cpp viterbi_tailbite; io/native.py::load
    builds it, and raises without a compiler).  The tracker's MIB
    re-decode runs it every 40 ms per cell, where per-step tensor
    dispatch would cost more than the trellis."""
    from ..io.native import load

    d_llr = np.ascontiguousarray(d_llr, dtype=np.float64)
    n = d_llr.shape[1]
    bits = np.empty(n, dtype=np.int32)
    load().viterbi_tailbite(d_llr.ctypes.data, n, bits.ctypes.data)
    return bits


# ---------------------------------------------------------------------------
# Rate matching
# ---------------------------------------------------------------------------

_PERM = np.array([1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
                  0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30])


@lru_cache(maxsize=None)
def ratematch_map(n_c: int, n_e: int) -> np.ndarray:
    """[n_e, 2] map: e-bit index -> (stream r in 0..2, coded-bit col c).

    Derived by running the reference's sub-block interleave + circular
    selection on coordinates (the probe trick, lte_lib.cpp:469-478).
    """
    n_cols = 32
    n_r = int(np.ceil(n_c / n_cols))
    pad = n_r * n_cols - n_c
    w = []
    for r in range(3):
        row = np.concatenate([np.full(pad, -1, dtype=np.int64),
                              np.arange(n_c, dtype=np.int64)])
        y = row.reshape(n_r, n_cols)
        y_perm = y[:, _PERM]
        # column-major readout: the block interleaver is read out down the
        # permuted columns (itpp cvectorize semantics, lte_lib.cpp:441-445)
        w.append(y_perm.T.reshape(-1))
    w = np.concatenate(w)  # stream-major circular buffer, -1 = pad
    out = np.zeros((n_e, 2), dtype=np.int64)
    k = 0
    j = 0
    total = 3 * n_r * n_cols
    while k < n_e:
        if w[j] >= 0:
            out[k, 0] = j // (n_r * n_cols)
            out[k, 1] = w[j]
            k += 1
        j = (j + 1) % total
    return out


def conv_ratematch(d: np.ndarray, n_e: int) -> np.ndarray:
    """Rate-match coded bits/symbols d [3, n_c] to length n_e."""
    d = np.asarray(d)
    m = ratematch_map(d.shape[1], n_e)
    return d[m[:, 0], m[:, 1]]


def conv_deratematch(e_llr: torch.Tensor, n_c: int) -> torch.Tensor:
    """Invert rate matching, averaging repeated LLR observations:
    e_llr [N, n_e] -> d_llr [N, 3, n_c] (reference lte_lib.cpp:493-509:
    positions seen more than once are averaged; unseen positions are
    0 = erasure)."""
    n_cw, n_e = e_llr.shape
    m = ratematch_map(n_c, n_e)
    flat = torch.from_numpy(m[:, 0] * n_c + m[:, 1]).to(e_llr.device)
    sums = torch.zeros((n_cw, 3 * n_c), dtype=e_llr.dtype,
                       device=e_llr.device).index_add_(1, flat, e_llr)
    counts = torch.zeros(3 * n_c, dtype=e_llr.dtype,
                         device=e_llr.device).index_add_(
        0, flat, torch.ones(n_e, dtype=e_llr.dtype, device=e_llr.device))
    avg = torch.where(counts > 1, sums / torch.clamp(counts, min=1), sums)
    return avg.reshape(n_cw, 3, n_c)


@lru_cache(maxsize=None)
def _ratematch_flat_idx(n_c: int, n_e: int) -> np.ndarray:
    m = ratematch_map(n_c, n_e)
    return np.ascontiguousarray(m[:, 0] * n_c + m[:, 1])


@lru_cache(maxsize=None)
def _deratematch_counts(n_c: int, n_e: int) -> np.ndarray:
    return np.bincount(_ratematch_flat_idx(n_c, n_e),
                       minlength=3 * n_c).astype(np.float64)


def conv_deratematch_host(e_llr: np.ndarray, n_c: int) -> np.ndarray:
    """Numpy conv_deratematch of one codeword, e_llr [n_e] -> [3, n_c]
    (the same averaging contract): one bincount against the cached
    index plan."""
    e_llr = np.asarray(e_llr, dtype=np.float64)
    idx = _ratematch_flat_idx(n_c, len(e_llr))
    counts = _deratematch_counts(n_c, len(e_llr))
    sums = np.bincount(idx, weights=e_llr, minlength=3 * n_c)
    avg = np.where(counts > 1, sums / np.maximum(counts, 1.0), sums)
    return avg.reshape(3, n_c)


# ---------------------------------------------------------------------------
# CRC
# ---------------------------------------------------------------------------

_CRC_POLYS = {
    "crc8": [1, 1, 0, 0, 1, 1, 0, 1, 1],
    "crc16": [1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1],
    "crc24a": [1, 1, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1,
               1, 1, 0, 1, 1],
    "crc24b": [1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
               0, 0, 0, 1, 1],
}


def crc_parity(a: np.ndarray, crc: str) -> np.ndarray:
    """Parity bits: remainder of a(x)*x^L / g(x) over GF(2)."""
    poly = np.array(_CRC_POLYS[crc], dtype=np.uint8)
    L = len(poly) - 1
    reg = np.concatenate([np.asarray(a, dtype=np.uint8),
                          np.zeros(L, dtype=np.uint8)])
    for i in range(len(a)):
        if reg[i]:
            reg[i: i + L + 1] ^= poly
    return reg[-L:]


@lru_cache(maxsize=None)
def crc_matrix(n_in: int, crc: str) -> np.ndarray:
    """[n_in, L] GF(2) matrix M with parity(a) = a @ M mod 2."""
    L = len(_CRC_POLYS[crc]) - 1
    m = np.zeros((n_in, L), dtype=np.uint8)
    for i in range(n_in):
        unit = np.zeros(n_in, dtype=np.uint8)
        unit[i] = 1
        m[i] = crc_parity(unit, crc)
    return m
