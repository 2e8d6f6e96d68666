"""Native host runtime: C implementations of the byte-serial hot loops.

Compiled on demand with the system C compiler (cc -O3 -shared -fPIC) into a
per-user cache directory and loaded through ctypes — no pybind11/pip
dependency.  Falls back cleanly to the NumPy implementations when no
toolchain is available (the two are differentially tested against each
other)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

from ..utils import env_setting

_DIR = os.path.dirname(os.path.abspath(__file__))
_CACHE = env_setting(
    "BANZAI_NATIVE_CACHE",
    os.path.expanduser("~/.cache/banzai_jax/native"),
)

_lib = None
_tried = False


def _build() -> ctypes.CDLL | None:
    src = os.path.join(_DIR, "rle1.c")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_CACHE, f"rle1-{tag}.so")
    if not os.path.exists(so):
        os.makedirs(_CACHE, exist_ok=True)
        tmp = so + ".tmp"
        for cc in ("cc", "gcc", "clang"):
            try:
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", "-o", tmp, src],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)
                break
            except Exception:
                continue
        else:
            return None
    lib = ctypes.CDLL(so)
    lib.rle1_block.restype = ctypes.c_int64
    lib.rle1_block.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def get_rle1() -> ctypes.CDLL | None:
    """The native RLE1 library, or None if unavailable."""
    global _lib, _tried
    if not _tried:
        _tried = True
        try:
            _lib = _build()
        except Exception:
            _lib = None
    return _lib


def rle1_block_native(
    lib, data: bytes, offset: int, bound: int
) -> tuple[bytes, int]:
    """Run the native machine for one block; returns (output, consumed)."""
    out = ctypes.create_string_buffer(bound + 8)
    out_len = ctypes.c_int64(0)
    new_i = lib.rle1_block(
        data, len(data), offset, bound, out, ctypes.byref(out_len)
    )
    return out.raw[: out_len.value], int(new_i) - offset

# ---------------------------------------------------------------------------
# SA-IS host BWT (native/sais.c)
# ---------------------------------------------------------------------------

_sais_lib = None
_sais_tried = False


def _build_sais() -> ctypes.CDLL | None:
    src = os.path.join(_DIR, "sais.c")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_CACHE, f"sais-{tag}.so")
    if not os.path.exists(so):
        os.makedirs(_CACHE, exist_ok=True)
        tmp = so + f".{os.getpid()}.tmp"
        for cc in ("cc", "gcc", "clang"):
            try:
                subprocess.run(
                    [cc, "-O3", "-shared", "-fPIC", "-o", tmp, src],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)
                break
            except Exception:
                continue
        else:
            return None
    lib = ctypes.CDLL(so)
    lib.bwt_doubled_sa.restype = ctypes.c_int
    lib.bwt_doubled_sa.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.mtf_encode.restype = None
    lib.mtf_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.selector_mtf.restype = None
    lib.selector_mtf.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
    ]
    return lib


def get_sais() -> ctypes.CDLL | None:
    """The native SA-IS library, or None if unavailable."""
    global _sais_lib, _sais_tried
    if not _sais_tried:
        _sais_tried = True
        try:
            _sais_lib = _build_sais()
        except Exception:
            _sais_lib = None
    return _sais_lib


def _cyclic_period(arr) -> int:
    """Fundamental period p (p | n) of the cyclic string, vectorized: test
    each divisor d of n ascending with one O(n) compare."""
    import numpy as np

    n = len(arr)
    for d in range(1, n):
        if d * d > n:
            break
        if n % d == 0:
            if np.array_equal(arr, np.roll(arr, d)):
                return d
    # check large divisors (n/d for the small d's, descending size)
    divs = sorted(
        {n // d for d in range(1, int(n ** 0.5) + 1) if n % d == 0}
    )
    for d in divs:
        if d < n and np.array_equal(arr, np.roll(arr, d)):
            return d
    return n


def host_bwt_native(rle1_out) -> "tuple | None":
    """Cyclic BWT of a block via native SA-IS; None if unavailable.

    Returns (bwt uint8[n], ptr int) with the same ptr convention as the
    device path (oracle/stages.numpy_bwt): ptr is the FIRST sorted row
    whose rotation equals rotation 0.  Tie groups exist only for periodic
    blocks; the group head falls out of the fundamental cyclic period
    (rotation i == rotation 0 iff p | i), no tie logic needed in C.
    """
    import numpy as np

    lib = get_sais()
    if lib is None:
        return None
    arr = np.ascontiguousarray(rle1_out, dtype=np.uint8)
    n = len(arr)
    if n == 0:
        return np.zeros(0, np.uint8), 0
    sa = np.empty(2 * n + 1, np.int32)
    rc = lib.bwt_doubled_sa(
        arr.tobytes(), n, sa.ctypes.data_as(ctypes.c_void_p)
    )
    if rc != 0:
        return None
    rows = sa[sa < n]                      # rotation order (ties by tail)
    bwt = arr[(rows - 1) % n]
    p = _cyclic_period(arr)
    if p == n:
        ptr = int(np.nonzero(rows == 0)[0][0])
    else:
        rank = np.empty(n, np.int64)
        rank[rows] = np.arange(n)
        ptr = int(rank[::p].min())         # group head of {0, p, 2p, ...}
    return bwt, ptr


def mtf_native(bwt, present) -> "object | None":
    """Dense-renamed MTF indices via the native serial shuffle; None when
    the toolchain is unavailable.  Same contract as mtf_rle2.mtf_indices."""
    import numpy as np

    lib = get_sais()
    if lib is None:
        return None
    arr = np.ascontiguousarray(bwt, dtype=np.uint8)
    init = np.flatnonzero(present).astype(np.uint8)
    out = np.empty(len(arr), np.uint8)
    lib.mtf_encode(
        arr.tobytes(), len(arr), init.tobytes(), len(init),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out.astype(np.int32)


def selector_mtf_native(selectors, nt: int) -> "object | None":
    """MTF stack indices per selector via the native walk; None without a
    toolchain.  Exact twin of huffman_host.iter_selector_mtf."""
    import numpy as np

    lib = get_sais()
    if lib is None:
        return None
    sel = np.ascontiguousarray(selectors, dtype=np.uint8)
    out = np.empty(len(sel), np.uint8)
    lib.selector_mtf(
        sel.tobytes(), len(sel), nt, out.ctypes.data_as(ctypes.c_void_p)
    )
    return out
