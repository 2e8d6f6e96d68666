"""Chunk-parallel MTF and vectorized RLE2 (host/NumPy production path).

The reference MTF is a byte-serial 256-entry recency shuffle
(lib/mtf.rs:69-104) — the one truly sequential stage.  The array-first
re-formulation exploits a structural fact: the recency list at any position
is *exactly* the present symbols sorted by last-occurrence (descending),
followed by the never-seen symbols in initial order.  So:

1. split the input into C chunks;
2. compute each chunk's starting recency list *in closed form* from a
   per-chunk last-occurrence table (scatter-max + exclusive cummax) — no
   sequential scan across chunks;
3. run the 256-entry shuffle *inside* each chunk only, vectorized **across**
   all chunks: the loop is over the chunk length K, each step operating on a
   [C, 256] state matrix.  Sequential depth drops from n to K.

RLE2 (zero-run bijective-base-2 coding, lib/mtf.rs:46-65) is then a pure
prefix-sum/scatter pass over the full MTF index stream.

The same formulation is implemented with jax.lax in ops/mtf.py; this NumPy
version doubles as its differential oracle and as the host backend.
"""

from __future__ import annotations

import numpy as np


def mtf_indices(bwt: np.ndarray, present: np.ndarray, chunk: int = 512) -> np.ndarray:
    """MTF indices (0..num_names-1) of the dense-renamed BWT column.

    ``present``: bool[256].  Returns int32[n] of MTF list positions.
    """
    bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
    n = len(bwt)
    names_map = (np.cumsum(present) - 1).astype(np.int32)
    num_names = int(present.sum())
    syms = names_map[bwt]
    if n == 0:
        return np.zeros(0, np.int32)

    C = (n + chunk - 1) // chunk
    pad = C * chunk - n
    syms_p = np.concatenate((syms, np.full(pad, -1, np.int32))).reshape(C, chunk)

    # Last occurrence of each symbol within each chunk (global position).
    occ = np.full((C, num_names), -1, np.int64)
    pos = np.arange(n, dtype=np.int64)
    np.maximum.at(occ, (pos // chunk, syms), pos)
    # Exclusive cummax over chunks -> last occurrence before chunk start.
    before = np.full((C, num_names), -1, np.int64)
    if C > 1:
        np.maximum.accumulate(occ[:-1], axis=0, out=occ[:-1])
        before[1:] = occ[:-1]
    # Starting recency list per chunk: seen symbols by recency desc, then
    # unseen in initial (identity) order.
    sym_ids = np.arange(num_names, dtype=np.int32)
    state = np.lexsort(
        (np.broadcast_to(sym_ids, (C, num_names)), -before), axis=1
    ).astype(np.int32)

    # Vectorized-across-chunks sequential shuffle within chunks.
    out = np.empty((C, chunk), dtype=np.int32)
    col = np.arange(num_names, dtype=np.int32)
    for t in range(chunk):
        s = syms_p[:, t]                                  # [C]
        hit = state == s[:, None]                         # [C, S]
        idx = hit.argmax(axis=1).astype(np.int32)         # [C]
        out[:, t] = idx
        # state' = [s, state[0..idx-1], state[idx+1..]]
        shifted = np.empty_like(state)
        shifted[:, 0] = s
        shifted[:, 1:] = state[:, :-1]
        keep = (col[None, :] > idx[:, None]) | (s < 0)[:, None]
        state = np.where(keep, state, shifted)
        # Padding rows (s < 0) keep their state; their out is sliced away.
    return out.reshape(-1)[:n]


def rle2_encode(
    mtf_idx: np.ndarray, num_names: int
) -> tuple[np.ndarray, np.ndarray]:
    """RLE2: encode zero runs in bijective base 2 (RUNA=0/RUNB=1), shift
    nonzero MTF indices to symbols idx+1, append EOB.

    Returns (symbol stream uint16 incl. EOB, freqs int64[num_syms]).
    """
    mtf_idx = np.asarray(mtf_idx, dtype=np.int64)
    eob = num_names + 1
    num_syms = num_names + 2
    nz = np.flatnonzero(mtf_idx)
    # Zero-run length before each nonzero symbol, plus the trailing run.
    prev_nz = np.empty_like(nz)
    prev_nz[0:1] = -1
    prev_nz[1:] = nz[:-1]
    zruns_before = nz - prev_nz - 1
    trailing = len(mtf_idx) - (nz[-1] + 1 if len(nz) else 0)

    def run_digit_count(z: np.ndarray) -> np.ndarray:
        # Number of bijective-base-2 digits of z (0 -> 0 digits):
        # floor(log2(z+1)) via an exact integer bit-length ladder — same
        # construction as the device twin (ops/rle2.py), no float anywhere
        # in the bit-exact path.
        v = (np.asarray(z, np.int64) + 1).astype(np.uint64)
        d = np.zeros(v.shape, np.int64)
        for s in (32, 16, 8, 4, 2, 1):
            big = v >= (np.uint64(1) << np.uint64(s))
            d += big.astype(np.int64) * s
            v = np.where(big, v >> np.uint64(s), v)
        return d

    zr = zruns_before
    nd = run_digit_count(zr)
    nd_trail = int(run_digit_count(np.array([trailing]))[0])
    out_len = int(nd.sum()) + len(nz) + nd_trail + 1       # + EOB
    out = np.zeros(out_len, dtype=np.uint16)

    # Offsets: for each nonzero symbol i, its run digits occupy
    # [off[i], off[i]+nd[i]) and the symbol sits at off[i]+nd[i].
    off = np.cumsum(nd + 1) - (nd + 1)
    # Scatter run digits (LSB-first digits of z+1, minus implicit MSB).
    max_d = int(nd.max()) if len(nd) else 0
    for j in range(max_d):
        mask = nd > j
        if not mask.any():
            break
        digits = ((zr[mask] + 1) >> j) & 1
        out[off[mask] + j] = digits.astype(np.uint16)
    if len(nz):
        out[off + nd] = (mtf_idx[nz] + 1).astype(np.uint16)
    # Trailing zero run + EOB.
    tail_off = int(off[-1] + nd[-1] + 1) if len(nz) else 0
    for j in range(nd_trail):
        out[tail_off + j] = ((trailing + 1) >> j) & 1
    out[-1] = eob
    freqs = np.bincount(out, minlength=num_syms).astype(np.int64)
    return out, freqs
