"""Differential tests: the stream-shaped device ops that run on the card
(ops/rle2.rle2_device, ops/bitpack.pack_entries, ops/mtf at the
production chunk) against the NumPy host twin (mtf_rle2, bitio.BitWriter)
on adversarial inputs: one huge zero run, alternation, long runs, dense
symbols, tiny lengths, straddling and exactly word-wide entries.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from banzai_jax.bitio import BitWriter
from banzai_jax.mtf_rle2 import mtf_indices, rle2_encode
from banzai_jax.ops.bitpack import pack_entries
from banzai_jax.ops.mtf import mtf_indices_device
from banzai_jax.ops.rle2 import rle2_device
from banzai_jax.pipeline import _CHUNK

_rle2 = jax.jit(rle2_device)


def _mtf_case(rng, N, kind, names):
    """MTF indices in [0, names) shaped like ``kind``."""
    if kind == "mixed":
        raw = np.where(rng.random(N) < 0.6, 0, rng.integers(1, 200, N))
    elif kind == "zeros":
        raw = np.zeros(N, np.int64)          # one huge run -> many digits
    elif kind == "alternating":
        raw = np.tile([0, 3], N // 2 + 1)[:N]
    elif kind == "runs":
        parts = []
        while sum(len(p) for p in parts) < N:
            parts += [np.zeros(rng.integers(1, 300)),
                      np.array([rng.integers(1, 255)])]
        raw = np.concatenate(parts)[:N]
    else:
        raw = rng.integers(0, 255, N)
    raw = raw.astype(np.int64)
    return np.where(raw == 0, 0, 1 + (raw - 1) % (names - 1)).astype(np.int32)


def _check_rle2(idx, n, names):
    syms_d, len_d, freqs_d = _rle2(
        jnp.asarray(idx), jnp.int32(n), jnp.int32(names)
    )
    syms_h, freqs_h = rle2_encode(idx[:n], names)
    assert int(len_d) == len(syms_h)
    np.testing.assert_array_equal(
        np.asarray(syms_d)[: len(syms_h)], syms_h.astype(np.int32)
    )
    np.testing.assert_array_equal(np.asarray(freqs_d)[: names + 2], freqs_h)


@pytest.mark.parametrize(
    "kind", ["mixed", "zeros", "alternating", "runs", "dense"]
)
def test_rle2_device_matches_host(kind):
    rng = np.random.default_rng(sum(kind.encode()))
    N = 1024
    for n, names in ((N, 200), (N - 1, 254), (263, 31)):
        _check_rle2(_mtf_case(rng, N, kind, names), n, names)


def test_rle2_device_tiny_n():
    # n of one and three symbols, plus the n == N edge (EOB at the last
    # position) at the smallest alphabet.
    rng = np.random.default_rng(7)
    N = 512
    for n, names in ((3, 5), (1, 2), (N, 2)):
        _check_rle2(rng.integers(0, names, N).astype(np.int32), n, names)


def _entry_case(rng, E, kind):
    if kind == "mixed":
        lens = rng.integers(0, 18, E)
    elif kind == "wide":
        lens = rng.integers(24, 33, E)       # force straddles
    elif kind == "sparse":
        lens = np.where(rng.random(E) < 0.9, 0, rng.integers(1, 16, E))
    else:  # boundary: many exact-32-bit entries
        lens = np.where(rng.random(E) < 0.5, 32, 16)
    vals = rng.integers(0, 1 << 32, E, dtype=np.uint64) & (
        (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    )
    return vals.astype(np.uint32), lens.astype(np.int32)


def _bitwriter_words(vals, lens, nwords):
    bw = BitWriter()
    for v, n in zip(vals.tolist(), lens.tolist()):
        bw.write_bits(v, n)
    nbits = bw.bit_length
    raw = bw.close()
    raw += b"\x00" * (4 * nwords - len(raw))
    return np.frombuffer(raw, ">u4").astype(np.uint32), nbits


def _check_pack(vals, lens, nwords):
    words_d, tot_d = jax.jit(pack_entries, static_argnums=2)(
        jnp.asarray(vals), jnp.asarray(lens), nwords
    )
    words_h, tot_h = _bitwriter_words(vals, lens, nwords)
    assert int(tot_d) == tot_h
    k = (tot_h + 31) // 32
    np.testing.assert_array_equal(np.asarray(words_d)[:k], words_h[:k])


@pytest.mark.parametrize("kind", ["mixed", "wide", "sparse", "boundary"])
def test_pack_entries_matches_bitwriter(kind):
    rng = np.random.default_rng(sum(kind.encode()))
    E = 1015                # not a power of two
    for _ in range(3):
        vals, lens = _entry_case(rng, E, kind)
        _check_pack(vals, lens, int(lens.sum()) // 32 + 3)


def test_pack_entries_single_word_pileup():
    # Hundreds of zero-length entries sharing one word: offsets stay put
    # across the whole run and only the two real entries land.
    E = 768
    lens = np.zeros(E, np.int32)
    lens[0] = 7
    lens[-1] = 13
    vals = np.full(E, 0x5A, np.uint32)
    _check_pack(vals, lens, 4)


@pytest.mark.parametrize("seed,n,alpha", [
    (10, 64, 7),        # exactly one chunk
    (11, 65, 256),      # one symbol into the second chunk
    (12, 3000, 4),
    (13, 8192, 256),    # n == N: every chunk full
    (14, 6000, 1),      # a single symbol: all indices 0
])
def test_mtf_device_production_chunk_matches_host(seed, n, alpha):
    assert _CHUNK == 64
    rng = random.Random(seed)
    arr = np.frombuffer(
        bytes(rng.randrange(alpha) for _ in range(n)), np.uint8
    )
    present = np.zeros(256, bool)
    present[arr] = True
    N = 8192
    block = np.zeros(N, np.uint8)
    block[:n] = arr
    idx = np.asarray(mtf_indices_device(
        jnp.asarray(block), jnp.int32(n), jnp.asarray(present), chunk=_CHUNK
    ))
    np.testing.assert_array_equal(idx[:n], mtf_indices(arr, present))
