"""Test harness config: unless the card-only tests are selected
(``-m gpu``), pin JAX to a virtual 8-device CPU mesh so the sharded
pipeline is exercised without an accelerator (SURVEY.md §4)."""

import os
import subprocess
import sys

import pytest


def _gpu_selected(argv) -> bool:
    """True when the ``-m`` expression asks for the ``gpu`` marker (and
    does not negate it).  Decided from the command line alone, so every
    xdist worker pins the same platform."""
    for i, arg in enumerate(argv):
        expr = None
        if arg == "-m" and i + 1 < len(argv):
            expr = argv[i + 1]
        elif arg.startswith("-m") and len(arg) > 2:
            expr = arg[2:]
        if expr is not None and "gpu" in expr and "not gpu" not in expr:
            return True
    return False


flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not _gpu_selected(sys.argv):
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (card-only tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest tests -m gpu` on the card")


@pytest.fixture(scope="session")
def bunzip():
    """Independent decode oracle: system bzip2 1.0.8 (the reference fuzz
    harness's differential pattern, fuzz/fuzz_targets/round_trip.rs)."""

    def _bunzip(data: bytes) -> bytes:
        p = subprocess.run(["bzip2", "-d"], input=data, capture_output=True)
        if p.returncode != 0:
            raise AssertionError(f"bzip2 -d failed: {p.stderr[:300]!r}")
        return p.stdout

    return _bunzip


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def repo_blob():
    """~72 KB of mixed text from the checkout's own tracked sources (the
    package's host modules and README): an in-repo stand-in for the
    reference's text sample, same size class."""
    names = ["README.md", "banzai_jax/rle1.py", "banzai_jax/huffman_host.py"]
    blob = b"".join(open(os.path.join(_REPO, n), "rb").read() for n in names)
    return blob[:72_133]


@pytest.fixture(scope="session")
def sample_blob():
    """The 72,133-byte mixed text sample anchored in BASELINE.md: the
    reference's lib/*.rs + README.md + bnz/src/main.rs, read from the
    checkout of jgbyrne/banzai that ``BANZAI_REFERENCE`` names."""
    import glob

    root = os.environ.get("BANZAI_REFERENCE", "")
    if not root or not os.path.isdir(os.path.join(root, "lib")):
        pytest.skip(
            "BASELINE anchor needs a jgbyrne/banzai checkout named by "
            "BANZAI_REFERENCE"
        )
    files = sorted(glob.glob(os.path.join(root, "lib", "*.rs"))) + [
        os.path.join(root, "README.md"),
        os.path.join(root, "bnz", "src", "main.rs"),
    ]
    return b"".join(open(f, "rb").read() for f in files)
