"""End-to-end: host production encoder vs the system bzip2 decoder and the
banzai size oracle — the reference's differential fuzz pattern
(fuzz/fuzz_targets/round_trip.rs) as a deterministic battery."""

import os
import random

import jax
import pytest

from banzai_jax import compress
from banzai_jax.oracle import banzai_compress

# Real-world text that every machine with JAX has: jax's own lax.py.
_LAX_PY = os.path.join(os.path.dirname(jax.__file__), "_src", "lax", "lax.py")

ADVERSARIAL = [
    b"",
    b"A",
    b"AB",
    b"a" * 4,
    b"a" * 255,
    b"a" * 256,
    b"a" * 259,
    b"a" * 260,
    b"hello, hello, hello world! " * 5,
    b"z" * 1_000_000,
    b"abc" * 100_000,
    bytes(range(256)) * 4,
]


@pytest.mark.parametrize("i", range(len(ADVERSARIAL)))
def test_adversarial_roundtrip_and_size(i, bunzip):
    data = ADVERSARIAL[i]
    ours = compress(data, 1, backend="numpy")
    assert bunzip(ours) == data
    assert len(ours) <= len(banzai_compress(data, 1))


def test_sample_blob_beats_banzai_and_bzip2(bunzip, sample_blob):
    ours = compress(sample_blob, 1, backend="numpy")
    assert bunzip(ours) == sample_blob
    assert len(ours) <= 17_730     # banzai anchor (BASELINE.md)
    assert len(ours) <= 17_372     # real bzip2 -1 anchor


def test_multiblock_random(bunzip):
    data = random.Random(7).randbytes(250_000)
    ours = compress(data, 1, backend="numpy")
    assert bunzip(ours) == data
    assert len(ours) <= len(banzai_compress(data, 1))


@pytest.mark.parametrize("level", [1, 2, 9])
def test_levels(level, bunzip, repo_blob):
    data = repo_blob * (1 if level == 1 else 3)
    ours = compress(data, level, backend="numpy")
    assert bunzip(ours) == data


def test_pool_jobs_byte_identical(bunzip):
    """Block-parallel host encode must equal the sequential encode bit for
    bit at any job count (ordered stitch is the only shared state)."""
    data = (
        open(_LAX_PY, "rb").read()[:250_000]
        + b"\x00" * 60_000
        + b"abcde" * 12_000
    )
    seq = compress(data, 1, backend="numpy")
    from banzai_jax.encoder_host import compress as host_compress

    pooled = host_compress(data, 1, jobs=3)
    assert pooled == seq
    assert bunzip(pooled) == data
