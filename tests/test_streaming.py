import io
import random

import banzai_jax
from banzai_jax.profiling import encode_report


def test_streaming_matches_batch_and_roundtrips(bunzip):
    data = random.Random(3).randbytes(350_000)
    r, w = io.BytesIO(data), io.BytesIO()
    n = banzai_jax.encode(r, w, level=1, backend="numpy", span_bytes=120_000)
    out = w.getvalue()
    assert n == len(out)
    assert bunzip(out) == data
    assert out == banzai_jax.compress(data, 1, backend="numpy")


def test_streaming_empty_input():
    r, w = io.BytesIO(b""), io.BytesIO()
    banzai_jax.encode(r, w, level=1, backend="numpy")
    assert len(w.getvalue()) == 14


def test_streaming_single_span(bunzip):
    data = b"span " * 1000
    r, w = io.BytesIO(data), io.BytesIO()
    banzai_jax.encode(r, w, level=1, backend="numpy", span_bytes=1 << 26)
    assert bunzip(w.getvalue()) == data


def test_encode_report_stats():
    data = random.Random(5).randbytes(150_000)
    rep = encode_report(data, 1)
    assert len(rep.blocks) == 2
    assert sum(b.consumed for b in rep.blocks) == len(data)
    assert all(b.payload_bits > 0 for b in rep.blocks)
    assert "rle1+split" in rep.stage_seconds
    assert rep.summary()


def test_streaming_hybrid_byte_identical(bunzip, monkeypatch):
    """Streaming encode with hybrid workers enabled (env knob) emits the
    same stream as without: stealing + sequence-id stitch are invisible."""
    data = (b"streaming hybrid " * 20_000) + bytes(range(256)) * 400
    r, w = io.BytesIO(data), io.BytesIO()
    banzai_jax.encode(r, w, level=1, backend="jax", span_bytes=300_000)
    base = w.getvalue()
    monkeypatch.setenv("BANZAI_HYBRID_JOBS", "2")
    r, w = io.BytesIO(data), io.BytesIO()
    banzai_jax.encode(r, w, level=1, backend="jax", span_bytes=300_000)
    assert w.getvalue() == base
    assert bunzip(base) == data
