import random

import numpy as np
import pytest

from banzai_jax import rle1


def _assert_same(data: bytes, level: int) -> None:
    fast = rle1.split_blocks(data, level)
    slow = rle1.machine_split_blocks(data, level)
    assert len(fast) == len(slow)
    for f, s in zip(fast, slow):
        assert f.consumed == s.consumed
        assert f.crc == s.crc
        assert np.array_equal(f.output, s.output)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 17, 100, 1000])
def test_small_random_vs_machine(n):
    rng = random.Random(n)
    for alpha in (1, 2, 4, 256):
        _assert_same(bytes(rng.randrange(alpha) for _ in range(n)), 1)


@pytest.mark.parametrize("L", [4, 5, 251, 254, 255, 256, 258, 259, 260, 511])
def test_run_boundaries(L):
    _assert_same(b"x" * L, 1)
    _assert_same(b"ab" + b"x" * L + b"yz", 1)


def test_multiblock_boundary_cases():
    rng = random.Random(42)
    _assert_same(rng.randbytes(250_000), 1)           # literal multi-block
    parts, tot = [], 0
    while tot < 300_000:                              # run-heavy multi-block
        L = rng.choice([1, 2, 3, 4, 5, 250, 255, 256, 259])
        parts.append(bytes([rng.randrange(4)]) * L)
        tot += L
    _assert_same(b"".join(parts), 1)
    _assert_same(b"abc" * 100_000, 1)                 # periodic
    _assert_same(bytes(1) * 300_000, 1)               # one giant run


def test_block_capacity_respected():
    data = random.Random(0).randbytes(350_000)
    for blk in rle1.split_blocks(data, 1):
        assert len(blk.output) <= 99_999
