import random

import numpy as np
import pytest

from banzai_jax.mtf_rle2 import mtf_indices, rle2_encode
from banzai_jax.oracle.stages import naive_mtf_rle2


def _present(block: np.ndarray) -> np.ndarray:
    p = np.zeros(256, dtype=bool)
    p[block] = True
    return p


@pytest.mark.parametrize("seed,n,alpha", [
    (0, 1, 1), (1, 7, 2), (2, 100, 3), (3, 1000, 5),
    (4, 5000, 256), (5, 10_000, 2), (6, 3000, 250),
])
def test_fused_matches_naive(seed, n, alpha):
    rng = random.Random(seed)
    block = np.frombuffer(
        bytes(rng.randrange(alpha) for _ in range(n)), dtype=np.uint8
    )
    present = _present(block)
    num_names = int(present.sum())
    idx = mtf_indices(block, present)
    syms, freqs = rle2_encode(idx, num_names)
    ref_syms, ref_num_syms, ref_freqs = naive_mtf_rle2(block, present)
    assert ref_num_syms == num_names + 2
    assert syms.tolist() == ref_syms
    assert freqs.tolist() == ref_freqs.tolist()


def test_all_zero_mtf_stream():
    block = np.full(1000, 7, dtype=np.uint8)
    present = _present(block)
    idx = mtf_indices(block, present)
    assert (idx == 0).all()
    syms, freqs = rle2_encode(idx, 1)
    ref_syms, _, ref_freqs = naive_mtf_rle2(block, present)
    assert syms.tolist() == ref_syms
    assert freqs.tolist() == ref_freqs.tolist()


def test_chunk_sizes_agree():
    rng = random.Random(9)
    block = np.frombuffer(rng.randbytes(4097), dtype=np.uint8)
    present = _present(block)
    base = mtf_indices(block, present, chunk=512)
    for chunk in (1, 3, 64, 511, 4096, 8192):
        assert np.array_equal(mtf_indices(block, present, chunk=chunk), base)
