"""Environment settings are read under one name each; a value that names
nothing, or the setting under another spelling, fails instead of being
ignored."""

import pytest

import banzai_jax
from banzai_jax.encoder_host import compress as host_compress
from banzai_jax.utils import env_setting

DATA = b"environment settings " * 50


def test_backend_env_selects_numpy(monkeypatch):
    monkeypatch.setenv("BANZAI_BACKEND", "numpy")
    assert banzai_jax._auto_backend() == "numpy"
    assert banzai_jax.compress(DATA, 1) == host_compress(DATA, 1)


def test_backend_env_value_must_name_a_backend(monkeypatch):
    monkeypatch.setenv("BANZAI_BACKEND", "gpu")
    with pytest.raises(ValueError, match="BANZAI_BACKEND must be one of"):
        banzai_jax.compress(DATA, 1)


@pytest.mark.parametrize("entry", ["compress", "encode"])
def test_backend_env_under_another_name_fails(monkeypatch, entry):
    monkeypatch.delenv("BANZAI_BACKEND", raising=False)
    monkeypatch.setenv("BANZAI_OLD_BACKEND", "numpy")
    with pytest.raises(RuntimeError, match="BANZAI_OLD_BACKEND is not read"):
        if entry == "compress":
            banzai_jax.compress(DATA, 1)
        else:
            import io

            banzai_jax.encode(io.BytesIO(DATA), io.BytesIO(), 1)


def test_explicit_backend_ignores_the_env(monkeypatch):
    monkeypatch.setenv("BANZAI_BACKEND", "gpu")
    assert banzai_jax.compress(DATA, 1, backend="numpy") == host_compress(
        DATA, 1
    )


def test_native_cache_setting(monkeypatch, tmp_path):
    monkeypatch.delenv("BANZAI_NATIVE_CACHE", raising=False)
    assert env_setting("BANZAI_NATIVE_CACHE", "dflt") == "dflt"
    monkeypatch.setenv("BANZAI_NATIVE_CACHE", str(tmp_path))
    assert env_setting("BANZAI_NATIVE_CACHE", "dflt") == str(tmp_path)
    monkeypatch.setenv("BANZAI_X_NATIVE_CACHE", str(tmp_path))
    with pytest.raises(RuntimeError, match="set BANZAI_NATIVE_CACHE"):
        env_setting("BANZAI_NATIVE_CACHE", "dflt")
