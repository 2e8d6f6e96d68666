"""Within-block sharded BWT (parallel/spbwt.py) vs the single-chip path.

Runs on the virtual 8-device CPU mesh (conftest forces the CPU platform
and 8 host devices).  The sharded rotation sort must be byte-identical to
ops.bwt.bwt_rotations for every input class the format produces: text,
RLE1-coded runs (periodic), random, and degenerate tiny blocks.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest

import jax.numpy as jnp

# Real-world text that every machine with JAX has: jax's own lax.py.
_LAX_PY = os.path.join(os.path.dirname(jax.__file__), "_src", "lax", "lax.py")


def _cases():
    rng = np.random.default_rng(7)
    text = (
        open(_LAX_PY, "rb")
        .read()[:6000]
    )
    return {
        "text": np.frombuffer(text, np.uint8),
        "random": rng.integers(0, 256, 5000, dtype=np.uint8),
        "periodic3": np.frombuffer(b"abc" * 2000, np.uint8),
        "run": np.full(4000, 122, np.uint8),
        "run_rle1": np.frombuffer((b"zzzz\x05" * 800), np.uint8),
        "two": np.frombuffer(b"ba", np.uint8),
        "one": np.frombuffer(b"q", np.uint8),
        "alt": np.frombuffer(b"ab" * 3000, np.uint8),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_sharded_matches_single_chip(name):
    from banzai_jax.ops.bwt import bwt_rotations
    from banzai_jax.parallel.spbwt import bwt_rotations_sharded, lane_mesh

    data = _cases()[name]
    N = 8192
    assert len(data) <= N
    block = np.zeros(N, np.uint8)
    block[: len(data)] = data
    n = jnp.int32(len(data))

    ref_bwt, ref_ptr = bwt_rotations(jnp.asarray(block), n)
    mesh = lane_mesh()
    got_bwt, got_ptr = bwt_rotations_sharded(
        jnp.asarray(block), n, mesh=mesh
    )

    nn = len(data)
    assert int(got_ptr) == int(ref_ptr), name
    np.testing.assert_array_equal(
        np.asarray(got_bwt)[:nn], np.asarray(ref_bwt)[:nn], err_msg=name
    )


@pytest.mark.parametrize("seed", range(6))
def test_sharded_matches_single_chip_random(seed):
    """Randomized content + lengths straddling shard boundaries (N/8
    multiples +/- 1) — the relabel carry and merge-split edges."""
    from banzai_jax.ops.bwt import bwt_rotations
    from banzai_jax.parallel.spbwt import bwt_rotations_sharded, lane_mesh

    rng = np.random.default_rng(100 + seed)
    N = 4096
    n = int(rng.choice([N, N - 1, N // 2, N // 2 + 1, 3 * N // 8 - 1,
                        N // 8 + 1]))
    kind = seed % 3
    if kind == 0:
        data = rng.integers(0, 256, n, dtype=np.uint8)
    elif kind == 1:
        data = rng.integers(0, 3, n, dtype=np.uint8)        # heavy ties
    else:
        p = rng.integers(2, 9)
        data = np.resize(rng.integers(0, 256, p, dtype=np.uint8), n)

    block = np.zeros(N, np.uint8)
    block[:n] = data
    ref_bwt, ref_ptr = bwt_rotations(jnp.asarray(block), jnp.int32(n))
    got_bwt, got_ptr = bwt_rotations_sharded(
        jnp.asarray(block), jnp.int32(n), mesh=lane_mesh()
    )
    assert int(got_ptr) == int(ref_ptr)
    np.testing.assert_array_equal(
        np.asarray(got_bwt)[:n], np.asarray(ref_bwt)[:n]
    )


def test_sharded_stall_group_split_regression():
    """A doubling round can split a tie group into smaller multi-groups
    without resolving any lane; the stall rule must compare group counts,
    not lane counts (review finding, verified counterexample)."""
    from banzai_jax.oracle.stages import naive_bwt
    from banzai_jax.parallel.spbwt import bwt_rotations_sharded, lane_mesh

    data = b"\x00" * 7 + b"\x01" + b"\x00" * 5 + b"\x01"
    N = 16
    block = np.zeros(N, np.uint8)
    block[: len(data)] = np.frombuffer(data, np.uint8)
    got_bwt, got_ptr = bwt_rotations_sharded(
        jnp.asarray(block), jnp.int32(len(data)), mesh=lane_mesh()
    )
    ref_bwt, ref_ptr = naive_bwt(data)
    assert int(got_ptr) == ref_ptr
    assert bytes(np.asarray(got_bwt)[: len(data)]) == bytes(ref_bwt)


def test_exhaustive_tiny_binary_vs_naive():
    """Exhaustive binary strings n<=8 on BOTH paths vs the naive oracle
    (also covers the tiny-N static-slice extension in ops/bwt.py)."""
    import itertools

    from banzai_jax.oracle.stages import naive_bwt
    from banzai_jax.ops.bwt import bwt_rotations
    from banzai_jax.parallel.spbwt import bwt_rotations_sharded, lane_mesh

    mesh = lane_mesh()
    N = 16
    for n in range(1, 9):
        for bits in itertools.product([0, 1], repeat=n):
            data = bytes(bits)
            block = np.zeros(N, np.uint8)
            block[:n] = np.frombuffer(data, np.uint8)
            nb, npk = naive_bwt(data)
            rb, rp = bwt_rotations(jnp.asarray(block), jnp.int32(n))
            assert (bytes(np.asarray(rb)[:n]), int(rp)) == (nb, npk), bits
            gb, gp = bwt_rotations_sharded(
                jnp.asarray(block), jnp.int32(n), mesh=mesh
            )
            assert (bytes(np.asarray(gb)[:n]), int(gp)) == (nb, npk), bits


def test_sharded_oracle_roundtrip():
    """Independent check against the naive rotation-sort oracle."""
    from banzai_jax.oracle.stages import naive_bwt
    from banzai_jax.parallel.spbwt import bwt_rotations_sharded, lane_mesh

    data = b"the quick brown fox jumps over the lazy dog" * 40
    N = 2048
    block = np.zeros(N, np.uint8)
    block[: len(data)] = np.frombuffer(data, np.uint8)
    got_bwt, got_ptr = bwt_rotations_sharded(
        jnp.asarray(block), jnp.int32(len(data)), mesh=lane_mesh()
    )
    ref_bwt, ref_ptr = naive_bwt(data)
    assert int(got_ptr) == ref_ptr
    assert bytes(np.asarray(got_bwt)[: len(data)]) == bytes(ref_bwt)


def test_sharded_million_lanes_and_memory_scaling():
    """The long-context claims, measured (VERDICT r3 item 6):

    1. correctness at 1M lanes (beyond any bzip2 block size) against the
       independent numpy prefix-doubling oracle;
    2. per-device memory ∝ N/D: the compiled TOTAL temp footprint must
       stay ~flat when the same N is spread over twice the devices (the
       old replicated-input design doubled it — every device held O(N)).
    """
    from functools import partial

    import jax

    from banzai_jax.oracle.stages import numpy_bwt
    from banzai_jax.parallel.spbwt import bwt_rotations_sharded, lane_mesh

    N = 1 << 20
    rng = np.random.default_rng(11)
    n = N - 777
    block = np.zeros(N, np.uint8)
    # Mixed content: text-ish low entropy + a periodic stretch.
    block[: n // 2] = rng.integers(32, 90, n // 2, dtype=np.uint8)
    per = np.frombuffer(b"ripple" * (n // 12), np.uint8)
    block[n // 2 : n // 2 + len(per)] = per
    block[n // 2 + len(per) : n] = rng.integers(0, 256, n - n // 2 - len(per), dtype=np.uint8)

    mesh8 = lane_mesh(jax.devices()[:8])
    got_b, got_p = bwt_rotations_sharded(
        jnp.asarray(block), jnp.int32(n), mesh=mesh8
    )
    ref_b, ref_p = numpy_bwt(block[:n])
    assert int(got_p) == int(ref_p)
    assert bytes(np.asarray(got_b)[:n]) == bytes(ref_b)

    def temp_bytes(ndev: int) -> int:
        mesh = lane_mesh(jax.devices()[:ndev])
        f = jax.jit(partial(bwt_rotations_sharded, mesh=mesh))
        c = f.lower(
            jax.ShapeDtypeStruct((N,), jnp.uint8),
            jax.ShapeDtypeStruct((), jnp.int32),
        ).compile()
        return int(c.memory_analysis().temp_size_in_bytes)

    t4, t8 = temp_bytes(4), temp_bytes(8)
    # Flat total (= per-device ∝ N/D).  Replicated designs give t8 ≈ 2*t4.
    assert t8 < 1.5 * t4, (t4, t8)
    # Absolute sanity: a handful of int32 arrays over the whole problem,
    # not D copies of them.
    assert t8 < 40 * N, (t8, N)


def test_chain_resolution_round_count_periodic():
    """VERDICT r4 #9: the sharded path's tandem-chain pass must resolve
    periodic regions analytically instead of paying plain-doubling round
    counts.  A 256K-lane block dominated by the RLE1 period-5 pattern
    ("aaaaC" repeats) plus a random tail must exit the doubling loop with
    k still small (chains fire at k0=7; without them k doubled to the
    region length, ~2^17)."""
    from banzai_jax.oracle.stages import numpy_bwt
    from banzai_jax.parallel.spbwt import bwt_rotations_sharded, lane_mesh

    rng = np.random.default_rng(11)
    periodic = (b"aaaa\xfb" * 45_000)          # 225_000 bytes, period 5
    tail = rng.integers(0, 256, 36_000).astype(np.uint8).tobytes()
    data = periodic + tail
    N = 1 << 18
    block = np.zeros(N, np.uint8)
    block[: len(data)] = np.frombuffer(data, np.uint8)
    bwt, ptr, kf = bwt_rotations_sharded(
        jnp.asarray(block), jnp.int32(len(data)), mesh=lane_mesh(),
        debug_rounds=True,
    )
    # Correctness first: byte-identical to the oracle.
    exp_bwt, exp_ptr = numpy_bwt(np.frombuffer(data, np.uint8))
    assert int(ptr) == exp_ptr
    np.testing.assert_array_equal(
        np.asarray(bwt[: len(data)]), exp_bwt
    )
    # Round count: chains resolved the periodic mass at k0 = 7; the
    # random tail needs at most a couple of doubling rounds.  Plain
    # doubling would have pushed k past the periodic region length.
    assert int(kf) <= 28, int(kf)
