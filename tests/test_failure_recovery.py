"""Device-batch failure recovery: a lost batch falls back to the host twin
and the stream stays byte-identical (blocks are independent; SURVEY §5)."""

import random
import warnings

import pytest

import banzai_jax.pipeline as pipeline
from banzai_jax.encoder_host import compress as host_compress


class Poisoned:
    """Fails at drain-time materialization, like a lost device."""

    shape = (0,)
    calls = 0

    def copy_to_host_async(self):
        pass

    def __array__(self, *a, **kw):
        Poisoned.calls += 1
        raise RuntimeError("injected device loss")


def test_host_fallback_produces_identical_stream(monkeypatch, bunzip):
    data = random.Random(11).randbytes(150_000)
    expected = host_compress(data, 1)

    Poisoned.calls = 0
    monkeypatch.setattr(
        pipeline, "_pack_out", lambda *a, **kw: Poisoned()
    )
    out = pipeline.compress(data, 1, sharded=False)
    assert Poisoned.calls >= 1
    assert out == expected
    assert bunzip(out) == data


def test_device_batch_failure_is_an_error_under_the_smoke_filter(
    monkeypatch,
):
    """chip_smoke.py turns the quiet host re-encode of a lost device batch
    into a failure of the run."""
    monkeypatch.setattr(pipeline, "_pack_out", lambda *a, **kw: Poisoned())
    data = random.Random(3).randbytes(40_000)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message="device batch failed")
        with pytest.raises(UserWarning, match="device batch failed"):
            pipeline.compress(data, 1, sharded=False)
