"""North-star size contract: output <= the banzai model at EVERY level 1-9.

The quirk-exact banzai oracle (oracle/banzai_model.py, matches all
BASELINE.md anchors byte-for-byte) supplies the reference's compressed
sizes; the host encoder (byte-identical to the device pipeline, proven in
test_device_pipeline) supplies ours.  A mixed battery — text, random,
runs, periodic — sweeps all nine levels (VERDICT r1 item 4).
"""

import numpy as np
import pytest

from banzai_jax.encoder_host import compress as host_compress
from banzai_jax.oracle import banzai_compress


def _battery() -> dict[str, bytes]:
    rng = np.random.default_rng(7)
    text = (
        b"It was the best of times, it was the worst of times, it was the "
        b"age of wisdom, it was the age of foolishness, it was the epoch "
        b"of belief, it was the epoch of incredulity.\n"
    ) * 900                                   # ~150 KB: multi-block at lvl 1
    rand = rng.integers(0, 256, size=120_000, dtype=np.uint8).tobytes()
    runs = b"".join(
        bytes([b]) * ln
        for b, ln in zip(rng.integers(0, 4, 400), rng.integers(1, 900, 400))
    )
    periodic = b"abc" * 50_000
    walk = (rng.integers(-2, 3, size=150_000).cumsum() % 256).astype(
        np.uint8
    ).tobytes()
    return {
        "text": text,
        "random": rand,
        "runs": runs,
        "periodic": periodic,
        "walk": walk,
    }


def _corpus_case(name: str) -> bytes:
    import os

    return open(
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "corpus", name), "rb"
    ).read()


def test_fuzz_201_degenerate_dummy_table(bunzip):
    """Fuzz regression (seed 0, iter 201, level 3): banzai's quirky 2-table
    refinement collapses to a single used table whose unused twin is cheap
    to delta-code; our degenerate candidate must use a constant dummy
    table to stay <= banzai (huffman_host.plan_entropy)."""
    data = _corpus_case("fail_s0_i201_l3.bin")
    ours = host_compress(data, 3)
    assert bunzip(ours) == data
    assert len(ours) <= len(banzai_compress(data, 3))


@pytest.mark.parametrize("level", range(1, 10))
def test_size_le_banzai_all_levels(level, bunzip):
    for name, data in _battery().items():
        ours = host_compress(data, level)
        theirs = banzai_compress(data, level)
        assert bunzip(ours) == data, (name, level)
        assert len(ours) <= len(theirs), (
            f"{name} level {level}: ours {len(ours)} > banzai {len(theirs)}"
        )


def test_fuzz_s33_145_tiny_block_heap_tree(bunzip):
    """fuzz seed 33 iter 145: on a 29-RLE1-byte block, banzai's heap tree
    beat the payload-optimal package-merge tree by 1 byte via cheaper
    delta coding (Huffman trees are not unique).  Since round 4 the
    quirk-exact banzai plan is a candidate on EVERY block (host
    plan_entropy + ops/banzai_plan on device), so the contract holds by
    construction."""
    data = _corpus_case("fail_s33_i145_l1.bin")
    assert len(data) == 1028
    ours = host_compress(data, 1)
    assert bunzip(ours) == data
    assert len(ours) <= len(banzai_compress(data, 1))


def test_tiny_block_guard_device_matches_host(bunzip):
    """Tiny blocks are routed to the host path on the jax backend, so
    jax-backend output == numpy-backend output byte-for-byte."""
    from banzai_jax import compress as be_compress

    data = _corpus_case("fail_s33_i145_l1.bin")
    a = be_compress(data, 1, backend="numpy")
    b = be_compress(data, 1, backend="jax")
    assert a == b
    assert bunzip(a) == data
