import random

import jax
import numpy as np
import pytest

from banzai_jax.bitio import BitWriter
from banzai_jax.parallel.multihost import encode_multihost, plan_spans
from banzai_jax.parallel.serial import BlockPayload
from banzai_jax.rle1 import split_blocks


def test_block_payload_serialization_roundtrip():
    rng = np.random.default_rng(0)
    payloads = []
    for i in range(3):
        nbits = int(rng.integers(1, 1000))
        words = rng.integers(0, 2**32, size=(nbits + 31) // 32 + 4).astype(
            np.uint32
        )
        present = rng.random(256) < 0.5
        payloads.append(
            BlockPayload(
                crc=int(rng.integers(0, 2**32)),
                ptr=int(rng.integers(0, 2**24)),
                present=present,
                words=words,
                nbits=nbits,
            )
        )
    blob = b"".join(p.to_bytes() for p in payloads)
    out = list(BlockPayload.iter_from_bytes(blob))
    assert len(out) == 3
    for a, b in zip(payloads, out):
        assert a.crc == b.crc and a.ptr == b.ptr and a.nbits == b.nbits
        assert np.array_equal(a.present, b.present)
        k = (a.nbits + 31) // 32
        assert np.array_equal(a.words[:k], b.words[:k])


def test_plan_spans_cover_exactly():
    data = random.Random(0).randbytes(500_000)
    for n_hosts in (1, 2, 3, 5):
        spans = plan_spans(data, 1, n_hosts)
        assert spans[0].offset == 0
        total = sum(s.length for s in spans)
        assert total == len(data)
        # Span boundaries are exact RLE1 block boundaries.
        blocks = split_blocks(data, 1)
        starts = np.cumsum([0] + [b.consumed for b in blocks])
        for s in spans[1:]:
            assert s.offset in starts


def test_encode_multihost_single_process(bunzip):
    data = random.Random(1).randbytes(150_000)
    out = encode_multihost(data, 1)
    assert bunzip(out) == data


def test_spanwise_encode_matches_single(bunzip):
    """Encoding spans independently and stitching payloads reproduces the
    single-host stream (the multi-host composition invariant)."""
    from banzai_jax.container import write_stream_footer, write_stream_header
    from banzai_jax.crc32 import combine_stream_crc
    from banzai_jax.pipeline import compress, compress_blocks_payloads

    data = random.Random(2).randbytes(260_000)
    level = 1
    single = compress(data, level)
    spans = plan_spans(data, level, 2)
    bw = BitWriter()
    write_stream_header(bw, level)
    stream_crc = 0
    for s in spans:
        for p in compress_blocks_payloads(
            data[s.offset : s.offset + s.length], level
        ):
            stream_crc = combine_stream_crc(stream_crc, p.crc)
            p.write(bw)
    write_stream_footer(bw, stream_crc)
    stitched = bw.close()
    assert stitched == single
    assert bunzip(stitched) == data


def test_hybrid_host_device_byte_identical(bunzip):
    """Hybrid scheduling (spawn-pool host workers stealing blocks from the
    device stream) must produce the exact same .bz2 stream as pure-device
    encode — the ordered stitch is the only shared state."""
    from banzai_jax.pipeline import compress

    rng = random.Random(7)
    data = bytes(
        rng.choice(b"abcdefgh \n") for _ in range(300_000)
    ) + b"run" * 40_000 + bytes(rng.randrange(256) for _ in range(120_000))
    pure = compress(data, 1)
    hybrid = compress(data, 1, hybrid_jobs=2)
    assert hybrid == pure
    assert bunzip(hybrid) == data
