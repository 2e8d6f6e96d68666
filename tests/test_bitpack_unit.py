"""Unit oracle for the device bit-pack kernel and canonical code words."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from banzai_jax.bitio import BitWriter, pack_bits_numpy
from banzai_jax.huffman_host import canonical_codes
from banzai_jax.ops.bitpack import canonical_words, pack_entries


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_entries_matches_numpy_oracle(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(10, 2000))
    lens = rng.integers(0, 25, size=m).astype(np.int32)
    vals = np.array(
        [rng.integers(0, 1 << max(l, 1)) for l in lens], np.uint32
    )
    nbits = int(lens.sum())
    nwords = (nbits + 31) // 32 + 2
    words_d, total_d = jax.jit(
        lambda v, l: pack_entries(v, l, nwords)
    )(jnp.asarray(vals), jnp.asarray(lens))
    ref_words, ref_bits = pack_bits_numpy(
        vals.astype(np.uint64), lens.astype(np.uint64)
    )
    assert int(total_d) == ref_bits
    k = (ref_bits + 31) // 32
    assert np.array_equal(np.asarray(words_d)[:k], ref_words)


def test_canonical_words_device_matches_host():
    rng = np.random.default_rng(3)
    for ns in (3, 17, 258):
        lens = rng.integers(1, 18, size=258).astype(np.int32)
        lens[ns:] = 0
        tables = np.tile(lens, (6, 1))
        wd = np.asarray(
            jax.jit(canonical_words)(jnp.asarray(tables), jnp.int32(ns))
        )[0, :ns]
        wh = canonical_codes(lens[:ns])
        assert np.array_equal(wd, wh.astype(wd.dtype))
