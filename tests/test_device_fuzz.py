"""Randomized device-vs-host equivalence fuzz (CPU mesh, small shapes).

Every case must produce a byte-identical stream on the device pipeline and
the NumPy twin, and decode through bzip2 -d — the strongest invariant the
framework maintains.
"""

import random

import pytest

from banzai_jax.encoder_host import compress as host_compress
from banzai_jax.pipeline import compress as device_compress


def _gen(rng: random.Random) -> bytes:
    kind = rng.randrange(5)
    n = rng.choice([1, 3, 50, 1000, 30_000, 130_000])
    if kind == 0:
        return rng.randbytes(n)
    if kind == 1:
        return bytes(rng.randrange(rng.choice([1, 2, 5])) for _ in range(n))
    if kind == 2:
        period = rng.randrange(1, 9)
        return (rng.randbytes(period) * (n // period + 1))[:n]
    if kind == 3:
        parts, tot = [], 0
        while tot < n:
            ln = rng.choice([1, 2, 4, 251, 255, 259])
            parts.append(bytes([rng.randrange(6)]) * ln)
            tot += ln
        return b"".join(parts)
    return bytes([rng.randrange(256)]) * n


@pytest.mark.parametrize("seed", range(8))
def test_device_equals_host_random(seed, bunzip):
    rng = random.Random(1000 + seed)
    data = _gen(rng)
    dev = device_compress(data, 1, sharded=False)
    host = host_compress(data, 1)
    assert dev == host, f"divergence on seed {seed} ({len(data)} bytes)"
    assert bunzip(dev) == data


@pytest.mark.parametrize("seed,level", [(0, 2), (1, 3), (2, 9), (3, 9)])
def test_device_equals_host_levels(seed, level, bunzip):
    """Levels > 1: bigger block shapes, level-dependent split boundaries."""
    rng = random.Random(7000 + seed)
    data = _gen(rng)
    dev = device_compress(data, level, sharded=False)
    host = host_compress(data, level)
    assert dev == host, f"divergence on seed {seed} level {level}"
    assert bunzip(dev) == data


@pytest.mark.parametrize("seed", range(2))
def test_device_batch_tail_paths(seed, bunzip):
    """Multi-batch streams at level 1: full batches + every pow-2 tail
    shape (the pipeline's batch padding ladder), with mixed content so
    dummy-lane masking in tail slots is exercised."""
    rng = random.Random(8800 + seed)
    # ~11 blocks of level-1 data: one full batch of 8 + a 3-block tail
    # (pads to 4 with one dummy slot).
    parts = [_gen(rng) for _ in range(40)]
    data = b"".join(parts)[: 11 * 99_900]
    dev = device_compress(data, 1, sharded=False, batch=8)
    host = host_compress(data, 1)
    assert dev == host
    assert bunzip(dev) == data
