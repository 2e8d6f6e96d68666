import numpy as np
import pytest

from banzai_jax.constants import CODEWORD_MAX_LEN
from banzai_jax.huffman_host import (
    canonical_codes,
    plan_entropy,
    pm_code_lengths,
    segment_histogram,
)
from banzai_jax.oracle.banzai_model import banzai_code_lengths


@pytest.mark.parametrize("seed,n", [(0, 3), (1, 10), (2, 258), (3, 100)])
def test_pm_lengths_valid_and_not_worse_than_banzai(seed, n):
    rng = np.random.default_rng(seed)
    freqs = rng.integers(0, 10_000, size=n)
    freqs[rng.integers(0, n)] = 0
    lens = pm_code_lengths(freqs)
    assert lens.min() >= 1 and lens.max() <= CODEWORD_MAX_LEN
    # Kraft equality: package-merge produces a complete code.
    assert np.isclose(np.sum(2.0 ** -lens.astype(float)), 1.0)
    # Optimality: expected length <= the reference heap+rescale heuristic.
    ref = np.array(banzai_code_lengths(n, freqs.tolist()))
    assert int((freqs * lens).sum()) <= int((freqs * ref).sum())


def test_pm_skewed_distribution_hits_cap():
    # 2^k-ish weights force the 17-bit cap to bind.
    freqs = np.array([2 ** min(i, 40) for i in range(30)])
    lens = pm_code_lengths(freqs)
    assert lens.max() <= CODEWORD_MAX_LEN
    assert np.isclose(np.sum(2.0 ** -lens.astype(float)), 1.0)


def test_canonical_codes_prefix_free():
    lengths = np.array([3, 3, 2, 4, 4, 2, 3])
    words = canonical_codes(lengths)
    codes = [format(w, f"0{l}b") for w, l in zip(words, lengths)]
    for i, a in enumerate(codes):
        for j, b in enumerate(codes):
            if i != j:
                assert not b.startswith(a)


def test_plan_entropy_picks_min_candidate():
    rng = np.random.default_rng(0)
    syms = rng.integers(0, 20, size=5000)
    freqs = np.bincount(syms, minlength=20)
    plan = plan_entropy(syms, 20, freqs)
    assert 2 <= plan.num_tables <= 6
    hist = segment_histogram(syms, 20)
    # Reported cost == recomputed cost.
    lens = plan.tables.astype(np.int64)
    payload = int((hist * lens[plan.selectors]).sum())
    assert plan.total_bits >= payload


# ---------------------------------------------------------------------------
# Device twin of banzai's quirk-exact plan (the <=-banzai contract closure)
# ---------------------------------------------------------------------------

def _device_banzai(syms, num_syms):
    import jax
    import jax.numpy as jnp

    from banzai_jax.constants import SEGMENT_WIDTH, MAX_SYMS
    from banzai_jax.ops.banzai_plan import banzai_plan_device
    from banzai_jax.ops.huffman import segment_hist

    n = len(syms)
    nseg = (n + SEGMENT_WIDTH - 1) // SEGMENT_WIDTH
    pad = np.zeros(max(n, 1), np.int32)
    pad[:n] = syms
    hist = segment_hist(jnp.asarray(pad), jnp.int32(n), nseg)
    freqs = jnp.sum(hist, axis=0).astype(jnp.int32)
    nt, tables, bits = jax.jit(banzai_plan_device)(
        hist, freqs, jnp.int32(n), jnp.int32(num_syms), jnp.int32(nseg)
    )
    return int(nt), np.asarray(tables), int(bits)


@pytest.mark.parametrize("seed,n,ns", [
    (0, 120, 5),        # tiny, nt=2
    (1, 3000, 30),      # nt=2
    (2, 5000, 258),     # full alphabet, nt=3 (ns >= 200)
    (3, 2000, 200),     # nt=3 boundary
    (4, 999, 199),      # nt=2 boundary
    (5, 4000, 3),       # minimal alphabet, heavy ties
])
def test_banzai_plan_device_matches_oracle(seed, n, ns):
    """The jit heap + closed-form accumulators must reproduce the oracle's
    4-iteration quirky refinement bit for bit (tables, nt, total bits)."""
    from banzai_jax.oracle.banzai_model import banzai_entropy_plan
    from banzai_jax.huffman_host import (
        selector_bits, table_delta_bits, payload_bits, segment_histogram,
    )

    rng = np.random.default_rng(seed)
    # Skewed symbol stream: low symbols dominate (like real MTF output).
    syms = np.minimum(
        rng.geometric(0.3, size=n) - 1, ns - 1
    ).astype(np.int64)
    syms[-1] = ns - 1                          # EOB
    freqs = np.bincount(syms, minlength=ns).astype(np.int64)

    o_nt, o_tables, o_sel = banzai_entropy_plan(syms, ns, freqs)
    d_nt, d_tables, d_bits = _device_banzai(syms, ns)

    assert d_nt == o_nt
    ot = np.asarray(o_tables, dtype=np.int64)
    assert np.array_equal(d_tables[:o_nt, :ns], ot)
    hist = segment_histogram(syms, ns)
    o_bits = (
        selector_bits(np.asarray(o_sel), o_nt)
        + table_delta_bits(ot)
        + payload_bits(hist, ot, np.asarray(o_sel))
    )
    assert d_bits == o_bits
    assert all(s == 0 for s in o_sel)          # quirk #3 holds


def test_banzai_lengths_device_rescale_path():
    """Extreme skew (Fibonacci-ish weights) forces max length > 17, so the
    device build must walk the same scaling<<=1 rescale loop."""
    import jax.numpy as jnp

    from banzai_jax.ops.banzai_plan import banzai_lengths_device

    ns = 40
    freqs = np.zeros(258, np.int64)
    a, b = 1, 1
    for s in range(ns):
        freqs[s] = a
        a, b = b, min(a + b, 400_000)
    o = banzai_code_lengths(ns, freqs.tolist())
    d = np.asarray(
        banzai_lengths_device(
            jnp.asarray(freqs, jnp.int32), jnp.int32(ns)
        )
    )
    assert max(o) <= CODEWORD_MAX_LEN
    assert np.array_equal(d[:ns], np.asarray(o))
    assert (d[ns:] == 0).all()


@pytest.mark.parametrize("seed", range(8))
def test_banzai_lengths_device_random(seed):
    """Heap tie mechanics: random small weights produce many equal
    (weight, depth) priorities; per-symbol lengths must still match the
    oracle heap exactly."""
    import jax.numpy as jnp

    from banzai_jax.ops.banzai_plan import banzai_lengths_device

    rng = np.random.default_rng(seed)
    ns = int(rng.integers(2, 259))
    freqs = np.zeros(258, np.int64)
    freqs[:ns] = rng.integers(0, 8, ns)        # heavy tie territory
    o = banzai_code_lengths(ns, freqs.tolist())
    d = np.asarray(
        banzai_lengths_device(
            jnp.asarray(freqs, jnp.int32), jnp.int32(ns)
        )
    )
    assert np.array_equal(d[:ns], np.asarray(o))


@pytest.mark.parametrize("seed,n,ns", [
    (0, 120, 5),
    (2, 5000, 258),
    (3, 2000, 200),
    (5, 4000, 3),
])
def test_banzai_bits_from_split_matches_device_plan(seed, n, ns):
    """The production path: the device ships only the cheap matmul split
    (ops/banzai_plan.banzai_split_device) and the host finishes the exact
    plan bits (huffman_host.banzai_bits_from_split).  split -> bits must
    equal the full device twin's total, and banzai_wins must agree with
    the exact comparison at thresholds around it (the pm lower bound may
    only ever *skip* when banzai provably loses)."""
    import jax
    import jax.numpy as jnp

    from banzai_jax.constants import SEGMENT_WIDTH
    from banzai_jax.huffman_host import banzai_bits_from_split, banzai_wins
    from banzai_jax.ops.banzai_plan import banzai_split_device
    from banzai_jax.ops.huffman import segment_hist

    rng = np.random.default_rng(seed)
    syms = np.minimum(
        rng.geometric(0.3, size=n) - 1, ns - 1
    ).astype(np.int64)
    syms[-1] = ns - 1
    _nt, _tables, d_bits = _device_banzai(syms, ns)

    nseg = (n + SEGMENT_WIDTH - 1) // SEGMENT_WIDTH
    hist = segment_hist(jnp.asarray(syms.astype(np.int32)),
                        jnp.int32(n), nseg)
    freqs = jnp.sum(hist, axis=0).astype(jnp.int32)
    split = np.asarray(jax.jit(banzai_split_device)(
        hist, freqs, jnp.int32(n), jnp.int32(ns)
    ))
    h_bits = banzai_bits_from_split(split, ns, n)
    assert h_bits == d_bits
    # Strict-win semantics at the boundary (exercises both the lower-bound
    # skip and the exact fallback).
    assert not banzai_wins(split, ns, n, h_bits)
    assert banzai_wins(split, ns, n, h_bits + 1)
    assert not banzai_wins(split, ns, n, h_bits - 10_000)


@pytest.mark.parametrize("seed", range(6))
def test_pm_lengths_device_packed_key_matches_host(seed):
    """Device pm_lengths (single packed-key level sorts) vs host oracle.

    The packed key ((w << 1) | is_package) must reproduce the
    lexicographic (weight, tag) order bit-for-bit; the adversarial
    classes here are the ones that stress tie order: all-equal weights
    (every merge slot ties), near-capacity totals (weights close to the
    2^29 sentinel headroom), minimal alphabets, and zipf skew hitting
    the 17-bit cap."""
    import jax
    import jax.numpy as jnp

    from banzai_jax.ops.huffman import pm_lengths

    rng = np.random.default_rng(seed)
    ns = int(rng.integers(3, 259))
    kind = seed % 5
    f = np.zeros(258, np.int64)
    if kind == 0:
        f[:ns] = rng.integers(0, 5, ns)          # tiny counts, dense ties
    elif kind == 1:
        f[:ns] = rng.integers(0, 900_001, ns)    # production magnitudes
    elif kind == 2:
        f[:ns] = 1                               # all ties
    elif kind == 3:
        f[:ns] = rng.zipf(1.5, ns).clip(0, 10**5)  # cap-binding skew
    else:
        f[:ns] = rng.integers(1, 3, ns)          # two-value ties
    dev = np.asarray(
        jax.jit(pm_lengths)(jnp.asarray(f, jnp.int32), jnp.int32(ns))
    )
    host = pm_code_lengths(f[:ns])
    assert (dev[:ns] == host).all()
    assert (dev[ns:] == 0).all()
