"""The single XLA device path: what it compiles to, where its compile cache
lives, and the smoke script that proves it on the card (chip_smoke.py),
checked here without one."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import banzai_jax.pipeline as pipeline
from banzai_jax.constants import SEGMENT_WIDTH
from banzai_jax.parallel.dp import block_mesh, encode_blocks_sharded
from banzai_jax.utils import cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def test_cache_dir_is_exactly_the_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_ignored_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache_dir() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_pipeline_import_applies_the_cache_dir():
    assert jax.config.jax_compilation_cache_dir == cache_dir()


def _small_shape(B):
    N = 1024                                   # multiple of pipeline._CHUNK
    nseg = (N + 1 + SEGMENT_WIDTH - 1) // SEGMENT_WIDTH
    spec = jax.ShapeDtypeStruct((B, N + pipeline._ROW_EXTRA), np.uint8)
    return spec, nseg, pipeline._nwords(N, nseg)


def _assert_plain_xla(hlo: str) -> None:
    # Every hand-written kernel (Pallas on any route, or a foreign
    # function) lowers to a custom call; the plain path has none.
    assert "custom_call" not in hlo


def test_fused_jit_lowers_to_plain_xla():
    spec, nseg, nwords = _small_shape(2)
    hlo = pipeline._encode_blocks.lower(
        spec, nseg=nseg, nwords=nwords
    ).as_text()
    assert "stablehlo.sort" in hlo
    _assert_plain_xla(hlo)


def test_sharded_jit_lowers_to_plain_xla():
    mesh = block_mesh()
    spec, nseg, nwords = _small_shape(len(mesh.devices))
    hlo = encode_blocks_sharded.lower(
        spec, nseg=nseg, nwords=nwords, mesh=mesh, chunk=pipeline._CHUNK
    ).as_text()
    _assert_plain_xla(hlo)


def _import_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_chip_smoke_refuses_a_cpu_backend(monkeypatch, capsys):
    smoke = _import_smoke()
    # init_jax sets both; monkeypatch puts them back afterwards.
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    with pytest.raises(RuntimeError, match="backend is cpu, not gpu"):
        smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("chips", [1, 4])
def test_chip_smoke_refuses_the_wrong_card_count(monkeypatch, chips):
    smoke = _import_smoke()
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert len(jax.devices()) not in (1, 4)     # the 8-device CPU mesh
    with pytest.raises(RuntimeError, match=f"need {chips} GPU"):
        smoke.init_jax(chips)


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    # With the card check stubbed out, the lone copy must still stop at
    # the missing package, before any phase runs (exit 99 would mean a
    # phase was reached).
    code = (
        "import sys, jax, chip_smoke\n"
        "chip_smoke.init_jax = lambda chips: jax\n"
        "chip_smoke.phase_identity = lambda jax: sys.exit(99)\n"
        "sys.exit(chip_smoke.main([]))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert p.returncode not in (0, 99)
    assert "No module named 'banzai_jax'" in p.stderr
    assert '"ok"' not in p.stdout


def test_smoke_sources_need_the_package(monkeypatch, tmp_path):
    smoke = _import_smoke()
    monkeypatch.setattr(smoke, "_REPO", str(tmp_path))
    with pytest.raises(RuntimeError, match="no package sources"):
        smoke._sources(1000)


def test_smoke_corpus_is_seeded_and_sized():
    smoke = _import_smoke()
    a, spans = smoke.build_corpus(5, 0.4)
    b, _ = smoke.build_corpus(5, 0.4)
    c, _ = smoke.build_corpus(6, 0.4)
    assert a == b and a != c
    assert len(a) == 400_000
    assert [s[0] for s in spans] == [
        "text", "walk", "source", "runs", "periodic"
    ]
    assert spans[0][1] == 0 and spans[-1][2] == len(a)
    assert all(lo < hi for _n, lo, hi in spans)
