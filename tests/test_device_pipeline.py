"""Device (JAX) pipeline: stage-level twins + end-to-end vs bzip2 -d.

Runs on the virtual CPU mesh (conftest).  The device pipeline must produce
byte-identical streams to the host NumPy twin and decode via bzip2 -d.
"""

import os
import random
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from banzai_jax.encoder_host import compress as host_compress
from banzai_jax.huffman_host import plan_entropy, pm_code_lengths
from banzai_jax.mtf_rle2 import mtf_indices, rle2_encode
from banzai_jax.ops.bwt import bwt_rotations
from banzai_jax.ops.huffman import plan_entropy_device, pm_lengths
from banzai_jax.ops.mtf import mtf_indices_device
from banzai_jax.ops.rle2 import rle2_device
from banzai_jax.oracle.stages import numpy_bwt
from banzai_jax.pipeline import compress as device_compress

# Real-world text that every machine with JAX has: jax's own lax.py.
_LAX_PY = os.path.join(os.path.dirname(jax.__file__), "_src", "lax", "lax.py")


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 6), (2, 500), (3, 5000)])
def test_bwt_device_vs_oracle(seed, n):
    rng = random.Random(seed)
    data = bytes(rng.randrange(4) for _ in range(n))
    N = 8192
    block = np.zeros(N, np.uint8)
    block[:n] = np.frombuffer(data, np.uint8)
    bwt_d, ptr_d = bwt_rotations(jnp.asarray(block), jnp.int32(n))
    bwt_h, ptr_h = numpy_bwt(data)
    assert np.array_equal(np.asarray(bwt_d)[:n], bwt_h)
    assert int(ptr_d) == ptr_h


@pytest.mark.parametrize("seed,n,alpha", [(0, 100, 3), (1, 4000, 256), (2, 8000, 2)])
def test_mtf_rle2_device_vs_host(seed, n, alpha):
    rng = random.Random(seed)
    data = np.frombuffer(
        bytes(rng.randrange(alpha) for _ in range(n)), np.uint8
    )
    present = np.zeros(256, bool)
    present[data] = True
    num_names = int(present.sum())
    N = 8192
    block = np.zeros(N, np.uint8)
    block[:n] = data
    idx_d = np.asarray(
        mtf_indices_device(jnp.asarray(block), jnp.int32(n), jnp.asarray(present))
    )[:n]
    idx_h = mtf_indices(data, present)
    assert np.array_equal(idx_d, idx_h)
    pad = np.zeros(N, np.int32)
    pad[:n] = idx_h
    syms_d, len_d, freqs_d = jax.jit(rle2_device)(
        jnp.asarray(pad), jnp.int32(n), jnp.int32(num_names)
    )
    syms_h, freqs_h = rle2_encode(idx_h, num_names)
    assert int(len_d) == len(syms_h)
    assert np.array_equal(np.asarray(syms_d)[: len(syms_h)], syms_h.astype(np.int32))
    assert np.array_equal(np.asarray(freqs_d)[: num_names + 2], freqs_h)


def test_pm_lengths_device_matches_host_cost():
    rng = np.random.default_rng(0)
    for _ in range(4):
        ns = int(rng.integers(3, 259))
        freqs = np.zeros(258, np.int64)
        freqs[:ns] = rng.integers(0, 5000, ns)
        dl = np.asarray(pm_lengths(jnp.asarray(freqs, jnp.int32), jnp.int32(ns)))
        hl = pm_code_lengths(freqs[:ns])
        w = np.maximum(freqs[:ns], 1)
        assert int((w * dl[:ns]).sum()) == int((w * hl).sum())
        assert (dl[ns:] == 0).all()


def test_plan_device_matches_host_bits():
    rng = np.random.default_rng(1)
    n, ns = 2500, 24
    syms = rng.integers(0, ns, n).astype(np.int32)
    syms[-1] = ns - 1
    freqs = np.bincount(syms, minlength=258).astype(np.int64)
    M, NSEG = 4096, 80
    pad = np.zeros(M, np.int32)
    pad[:n] = syms
    plan_d = jax.jit(partial(plan_entropy_device, nseg=NSEG))(
        jnp.asarray(pad), jnp.int32(n), jnp.int32(ns)
    )
    plan_h = plan_entropy(syms, ns, freqs[:ns])
    assert int(plan_d["total_bits"]) == plan_h.total_bits


DEVICE_CASES = [
    b"A",
    b"hello, hello, hello world! " * 5,
    b"a" * 260,
    random.Random(5).randbytes(10_000),
    b"z" * 1_000_000,
]


@pytest.mark.parametrize("i", range(len(DEVICE_CASES)))
def test_end_to_end_identical_to_host(i, bunzip):
    data = DEVICE_CASES[i]
    dev = device_compress(data, 1)
    assert dev == host_compress(data, 1)
    assert bunzip(dev) == data


def test_end_to_end_multiblock(bunzip):
    data = random.Random(6).randbytes(250_000)
    dev = device_compress(data, 1)
    assert dev == host_compress(data, 1)
    assert bunzip(dev) == data


def test_hardness_sorted_out_of_order_stitch(bunzip):
    """Mixed-hardness corpus with batch=1 and a 4-batch sort window: blocks
    are encoded out of input order (periodic blocks group together), but
    the payload stitch by sequence id must reproduce the exact host
    stream."""
    from banzai_jax.pipeline import _hardness, compress as pipe_compress

    rng = random.Random(9)
    data = (
        rng.randbytes(120_000)              # hard-ish (random)
        + b"ab" * 60_000                    # periodic
        + open(_LAX_PY, "rb").read()[:120_000]  # text
        + b"\x07" * 120_000                 # run-heavy
    )
    # Sanity: the predictor separates periodic from text.
    assert _hardness(np.frombuffer(b"ab" * 8192, np.uint8)) > 0.9
    assert (
        _hardness(np.frombuffer(rng.randbytes(16384), np.uint8)) < 0.2
    )
    dev = pipe_compress(data, 1, batch=1)
    assert dev == host_compress(data, 1)
    assert bunzip(dev) == data


@pytest.mark.gpu
def test_bwt_device_full_shape_vs_oracle(gpu, repo_blob):
    """BWT at the real level-9 block shape (CI-shaped unit tests run at
    N=8192; this one needs the card's memory and speed).  Mixed text + a
    long run + a periodic tail stresses every code path (round-1 prefix,
    chain resolution, full rounds, all three tiers)."""
    from banzai_jax.pipeline import _padded_len
    from banzai_jax.rle1 import iter_blocks

    data = (
        repo_blob * 6 + b"\x00" * 40_000 + b"abcde" * 9_000
    ) * 3
    blk = next(iter_blocks(data, 9))
    rle1 = np.asarray(blk.output)
    n = len(rle1)
    assert n > 890_000  # a genuinely full level-9 block
    N = _padded_len(9)
    block = np.zeros(N, np.uint8)
    block[:n] = rle1
    bwt_d, ptr_d = bwt_rotations(jnp.asarray(block), jnp.int32(n))
    bwt_h, ptr_h = numpy_bwt(rle1.tobytes())
    assert np.array_equal(np.asarray(bwt_d)[:n], bwt_h)
    assert int(ptr_d) == ptr_h
