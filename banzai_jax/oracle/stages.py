"""Naive oracle implementations of the per-block pipeline stages.

These mirror the reference's executable specs (debug/bwt.py, debug/rle1.py)
and the stage semantics documented in SURVEY.md §2.3-2.4; they are used for
differential testing of the device ops, never on the production path.
"""

from __future__ import annotations

import numpy as np


def naive_bwt(block: bytes) -> tuple[bytes, int]:
    """Wrap-around BWT by literally sorting all rotations (debug/bwt.py:5-27
    semantics): sort suffixes of block+block, keep those starting in the
    first copy, emit the preceding character; ptr = rank of rotation 0.

    O(n^2 log n) worst case — small inputs only.
    """
    n = len(block)
    if n == 0:
        return b"", 0
    doubled = block + block
    order = sorted(range(n), key=lambda i: doubled[i : i + n])
    out = bytes(block[(i + n - 1) % n] for i in order)
    ptr = order.index(0)
    return out, ptr


def numpy_bwt(block: np.ndarray | bytes) -> tuple[np.ndarray, int]:
    """Wrap-around BWT via cyclic prefix doubling with numpy sorts.

    Independent of the JAX implementation (numpy lexsort vs. lax.sort), but
    shares the same rotation-sort semantics; end-to-end validity is anchored
    separately by the ``bzip2 -d`` round-trip oracle.
    """
    data = np.frombuffer(bytes(block), dtype=np.uint8) if not isinstance(
        block, np.ndarray
    ) else np.ascontiguousarray(block, dtype=np.uint8)
    n = len(data)
    if n == 0:
        return np.zeros(0, np.uint8), 0
    if n == 1:
        return data.copy(), 0
    idx = np.arange(n, dtype=np.int64)
    rank = data.astype(np.int64)
    k = 1
    while k < n:
        key2 = rank[(idx + k) % n]
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        changed = np.empty(n, dtype=np.int64)
        changed[0] = 0
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank = np.cumsum(changed)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank
        if new_rank[-1] == n - 1:
            break
        k <<= 1
    # Ties (identical rotations on periodic input) are harmless: any order
    # of equal rotations yields the same BWT column (SURVEY.md §2.3).
    order = np.argsort(rank, kind="stable")
    bwt = data[(order + n - 1) % n]
    ptr = int(np.flatnonzero(order == 0)[0])
    return bwt, ptr


def naive_mtf_rle2(
    bwt: np.ndarray | bytes, present: np.ndarray
) -> tuple[list[int], int, np.ndarray]:
    """MTF + RLE2 exactly per lib/mtf.rs:7-121 semantics.

    ``present``: bool[256], which byte values occur in the block.
    Returns (symbol stream incl. EOB, num_syms, freqs[num_syms]).
    """
    data = np.frombuffer(bytes(bwt), dtype=np.uint8) if not isinstance(
        bwt, np.ndarray
    ) else bwt
    names = np.cumsum(present) - 1          # dense rename of present bytes
    num_names = int(present.sum())
    eob = num_names + 1
    num_syms = num_names + 2
    stack = list(range(num_names))
    out: list[int] = []
    freqs = np.zeros(num_syms, dtype=np.int64)
    zero_run = 0

    def flush_zero_run(count: int) -> None:
        # Bijective base 2 over RUNA(0)/RUNB(1): code = count + 1, emit
        # low bits, drop the implicit leading 1 (lib/mtf.rs:46-65).
        code = count + 1
        while code > 1:
            bit = code & 1
            out.append(bit)          # RUNA=0, RUNB=1
            freqs[bit] += 1
            code >>= 1

    for b in data:
        s = int(names[b])
        i = stack.index(s)
        if i == 0:
            zero_run += 1
            continue
        if zero_run:
            flush_zero_run(zero_run)
            zero_run = 0
        stack.pop(i)
        stack.insert(0, s)
        sym = i + 1
        out.append(sym)
        freqs[sym] += 1
    if zero_run:
        flush_zero_run(zero_run)
    out.append(eob)
    freqs[eob] += 1
    return out, num_syms, freqs
