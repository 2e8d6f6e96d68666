"""The reference's quirk-exact entropy plan as a device (jit) candidate.

North-star contract: our stream is never larger than banzai's on ANY
input.  Banzai's heap-built trees can occasionally beat a payload-optimal
package-merge tree on *total* bits through cheaper delta coding (Huffman
length assignments are not unique; first seen at fuzz seed 33 iter 145).
The only airtight closure is construction: include banzai's exact plan in
the candidate set, so ``min(candidates) <= banzai`` holds by definition.
This module is the device twin of ``oracle.banzai_model.banzai_entropy_plan``
(which models lib/huffman.rs:313-575 with all three verified quirks) —
both must produce bit-identical plans; tests/test_huffman.py checks that
differentially.

The 4-iteration refinement loop collapses in closed form.  QUIRK #3
(lib/huffman.rs:402-409) zeroes the *length* tables at the top of
iterations 1..3 while the per-table frequency accumulators are never
reset, so:

  * iterations 1..3 cost-sweep all-zero tables -> every segment picks
    table 0 (strict <, first wins) -> selectors are all zeros and the
    table-0 accumulator gains the full histogram three times;
  * the tables built at the end of iterations 0..2 are never read (the
    next iteration zeroes them), so only the FINAL heap build matters.

Hence the whole plan is: the initial-partition cost sweep (one matmul +
argmin), closed-form accumulated frequencies, and one exact heap build
per table — 2..3 sequential 258-leaf heaps, trivial next to the
sort-dominated stages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import CODEWORD_MAX_LEN, MAX_SYMS as S

_BIG = 1e9
# Banzai never uses more than 3 tables (QUIRK #1: num_tables is keyed on
# the alphabet size <= 258, so the 600/1200/2400 thresholds of
# lib/huffman.rs:319-326 are unreachable).
_BNT = 3


# ---------------------------------------------------------------------------
# Exact replica of the reference's 1-indexed binary min-heap
# (lib/huffman.rs:161-268 semantics, via oracle.banzai_model._Heap).
# Priorities (weight, max-leaf-depth) are packed ``weight << 9 | depth``:
# weights sum to <= 4*900_001 + 258 < 2**22 (table 0 accumulates the full
# histogram four times) and depth < 2**9, so packed priorities stay below
# 2**31 and int32 comparison equals tuple comparison.
# ---------------------------------------------------------------------------

def _heap_insert(hp, hs, size, sym, prio):
    """Sift-up insert; strict ``<`` against ancestors (equal keys stay
    below — the exact tie mechanics of the reference's insert)."""

    def cond(st):
        hp_, _hs_, this = st
        return (this > 1) & (prio < hp_[(this >> 1) - 1])

    def body(st):
        hp_, hs_, this = st
        above = this >> 1
        hp_ = hp_.at[this - 1].set(hp_[above - 1])
        hs_ = hs_.at[this - 1].set(hs_[above - 1])
        return hp_, hs_, above

    hp, hs, this = jax.lax.while_loop(cond, body, (hp, hs, size + 1))
    return hp.at[this - 1].set(prio), hs.at[this - 1].set(sym), size + 1


def _heap_extract(hp, hs, size):
    """Pop the min; the last element sifts down from the root.  Equal-key
    order follows the reference's exact ``<`` placement."""
    last_p = hp[size - 1]
    last_s = hs[size - 1]
    root_p = hp[0]
    root_s = hs[0]
    nsize = jnp.maximum(size - 1, 0)

    def below(hp_, this):
        left = this << 1
        right = left + 1
        use_r = (right <= nsize) & (hp_[right - 1] < hp_[left - 1])
        return jnp.where(use_r, right, left)

    def cond(st):
        hp_, _hs_, this = st
        b = below(hp_, this)
        return ((this << 1) <= nsize) & (last_p >= hp_[b - 1])

    def body(st):
        hp_, hs_, this = st
        b = below(hp_, this)
        hp_ = hp_.at[this - 1].set(hp_[b - 1])
        hs_ = hs_.at[this - 1].set(hs_[b - 1])
        return hp_, hs_, b

    hp, hs, this = jax.lax.while_loop(
        cond, body, (hp, hs, jnp.int32(1))
    )
    hp = hp.at[this - 1].set(last_p)
    hs = hs.at[this - 1].set(last_s)
    out_s = jnp.where(size == 1, last_s, root_s)
    out_p = jnp.where(size == 1, last_p, root_p)
    return hp, hs, nsize, out_s, out_p


def _build_lengths(freqs, ns, scaling):
    """One tree build (lib/huffman.rs:271-298 inner body): heap of
    ``freq // scaling + 1`` leaf weights, ns-1 merges into an arena
    (leaves 1..ns, inner nodes ns+1.., root at 0), then a top-down depth
    pass.  Returns (lengths int32[S] — 0 beyond ns, max_len)."""

    def ins_body(s, st):
        hp, hs, size = st
        prio = ((freqs[s] // scaling + 1) << 9).astype(jnp.int32)
        hp2, hs2, size2 = _heap_insert(hp, hs, size, s + 1, prio)
        live = s < ns
        return (
            jnp.where(live, hp2, hp),
            jnp.where(live, hs2, hs),
            jnp.where(live, size2, size),
        )

    hp = jnp.zeros(S, jnp.int32)
    hs = jnp.zeros(S, jnp.int32)
    hp, hs, size = jax.lax.fori_loop(
        0, S, ins_body, (hp, hs, jnp.int32(0))
    )

    def mrg_body(m, st):
        hp, hs, size, cl, cr = st
        hp1, hs1, size1, one, p1 = _heap_extract(hp, hs, size)
        hp2, hs2, size2, two, p2 = _heap_extract(hp1, hs1, size1)
        is_last = m == ns - 2
        node = jnp.where(is_last, 0, ns + 1 + m)
        cl2 = cl.at[node].set(one)
        cr2 = cr.at[node].set(two)
        w = (p1 >> 9) + (p2 >> 9)
        dep = jnp.maximum(p1 & 511, p2 & 511) + 1
        hp3, hs3, size3 = _heap_insert(
            hp2, hs2, size2, node, (w << 9) | dep
        )
        live = m < ns - 1
        keep = live & ~is_last
        return (
            jnp.where(keep, hp3, jnp.where(live, hp2, hp)),
            jnp.where(keep, hs3, jnp.where(live, hs2, hs)),
            jnp.where(keep, size3, jnp.where(live, size2, size)),
            jnp.where(live, cl2, cl),
            jnp.where(live, cr2, cr),
        )

    cl = jnp.zeros(2 * S, jnp.int32)
    cr = jnp.zeros(2 * S, jnp.int32)
    _hp, _hs, _size, cl, cr = jax.lax.fori_loop(
        0, S - 1, mrg_body, (hp, hs, size, cl, cr)
    )

    # Depths top-down.  A node's parent always has a HIGHER arena index
    # (or is the root), so processing root first and then arena indices
    # 2ns-2 down to ns+1 sees every node's depth before its children's.
    def dep_body(i, depth):
        node = jnp.where(i == 0, 0, 2 * ns - 2 - (i - 1))
        live = (i == 0) | (node >= ns + 1)
        d = depth[node] + 1
        depth2 = depth.at[cl[node]].set(d).at[cr[node]].set(d)
        return jnp.where(live, depth2, depth)

    depth = jax.lax.fori_loop(
        0, S - 1, dep_body, jnp.zeros(2 * S, jnp.int32)
    )
    sym_ids = jnp.arange(S, dtype=jnp.int32)
    lengths = jnp.where(
        sym_ids < ns, depth[1 : S + 1], 0
    )
    return lengths, jnp.max(lengths)


def banzai_lengths_device(freqs: jax.Array, ns: jax.Array) -> jax.Array:
    """build_table_from_freqs twin: rebuild with doubled scaling while the
    max length exceeds the 17-bit cap (lib/huffman.rs:272-297)."""
    lens, ml = _build_lengths(freqs, ns, jnp.int32(1))

    def body(st):
        scaling = st[0] * 2
        l2, m2 = _build_lengths(freqs, ns, scaling)
        return scaling, l2, m2

    _, lens, _ = jax.lax.while_loop(
        lambda st: st[2] > CODEWORD_MAX_LEN, body, (jnp.int32(1), lens, ml)
    )
    return lens


# ---------------------------------------------------------------------------
# The closed-form plan
# ---------------------------------------------------------------------------

def _initial_partition(freqs, ns, input_size, nt):
    """QUIRK #2 pseudo tables: contiguous ~equal-frequency ranges, 15
    in-range / 0 out (inverted vs real bzip2), with the odd-interior
    backtrack (lib/huffman.rs:333-376).  Returns int32 [_BNT, S]."""
    sym_ids = jnp.arange(S, dtype=jnp.int32)
    cum = jnp.cumsum(jnp.where(sym_ids < ns, freqs, 0))
    sym_left = jnp.int32(0)
    freq_remaining = input_size.astype(jnp.int32)
    rows = []
    for t in range(_BNT):
        empty = sym_left >= ns
        target = freq_remaining // jnp.maximum(nt - t, 1)
        base = jnp.where(sym_left > 0, cum[jnp.maximum(sym_left - 1, 0)], 0)
        acc_s = cum - base
        hit = (sym_ids >= sym_left) & (acc_s >= target) & (sym_ids < ns)
        sym_right = jnp.where(
            jnp.any(hit),
            jnp.minimum(jnp.argmax(hit).astype(jnp.int32), ns - 1),
            ns - 1,
        )
        # Backtrack: only an interior odd table can shrink by one symbol;
        # with nt <= 3 that is exactly t == 1 under nt == 3.
        do_bt = (
            (t == 1) & (nt == 3) & (sym_right > sym_left)
        )
        sym_right = jnp.where(do_bt, sym_right - 1, sym_right)
        acc = cum[sym_right] - base
        row = jnp.where(
            (sym_ids >= sym_left) & (sym_ids <= sym_right) & ~empty, 15, 0
        )
        rows.append(row.astype(jnp.int32))
        sym_left = jnp.where(empty, sym_left, sym_right + 1)
        freq_remaining = jnp.where(empty, freq_remaining, freq_remaining - acc)
    return jnp.stack(rows)


def banzai_split_device(
    hist: jax.Array,       # [NSEG, S] float32 segment histogram
    freqs: jax.Array,      # [S] int32 global frequencies (hist column sums)
    out_len: jax.Array,    # int32 number of MTF symbols
    num_syms: jax.Array,   # int32 alphabet size
) -> jax.Array:
    """The cheap (matmul-shaped) half of banzai's plan: the QUIRK-exact
    initial-partition cost sweep and the per-table segment-frequency
    split.  Returns int32 [_BNT, S] — iteration-0 table frequencies,
    BEFORE the table-0 ``+ 3 * freqs`` accumulation of iterations 1..3
    (so its column sums recover ``freqs`` exactly on the host).

    This is all that runs on the device hot path: the exact heap builds
    that turn the split into banzai's total bits are sequential
    (lib/huffman.rs:161-268 tie mechanics) and would be a long vmapped
    device while_loop — they run on the HOST drain thread instead
    (huffman_host.banzai_bits_from_split), which re-encodes the
    vanishingly rare blocks banzai wins via the byte-identical host path.
    """
    ns = num_syms
    nt = jnp.where(ns < 200, 2, 3).astype(jnp.int32)   # QUIRK #1

    pseudo = _initial_partition(freqs, ns, out_len, nt)     # [_BNT, S]
    t_ids = jnp.arange(_BNT, dtype=jnp.int32)
    costs = hist @ pseudo.astype(jnp.float32).T             # [NSEG, _BNT]
    costs = costs + jnp.where(t_ids[None, :] < nt, 0.0, _BIG)
    sel0 = jnp.argmin(costs, axis=1).astype(jnp.int32)      # first-wins

    onehot = (sel0[:, None] == t_ids[None, :]).astype(jnp.float32)
    return (onehot.T @ hist).astype(jnp.int32)              # [_BNT, S]


def banzai_plan_device(
    hist: jax.Array,       # [NSEG, S] float32 segment histogram
    freqs: jax.Array,      # [S] int32 global frequencies (hist column sums)
    out_len: jax.Array,    # int32 number of MTF symbols
    num_syms: jax.Array,   # int32 alphabet size
    nseg_used: jax.Array,  # int32 live segments
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Banzai's exact plan: (num_tables, tables int32 [_BNT, S], total_bits).

    Selectors are all zeros by QUIRK #3 (their unary-MTF cost is exactly
    ``nseg_used`` bits), so they are not returned.  Complete on-device
    twin of the oracle, kept for differential tests and offline use; the
    production pipeline runs only ``banzai_split_device`` on device and
    finishes the plan on the host (see that docstring for why).
    """
    ns = num_syms
    nt = jnp.where(ns < 200, 2, 3).astype(jnp.int32)   # QUIRK #1
    t_ids = jnp.arange(_BNT, dtype=jnp.int32)

    split = banzai_split_device(hist, freqs, out_len, num_syms)
    tf = split.at[0].add(3 * freqs)                         # iterations 1..3

    tables = jax.vmap(banzai_lengths_device, in_axes=(0, None))(tf, ns)

    sym_ids = jnp.arange(1, S, dtype=jnp.int32)
    d = jnp.abs(tables[:, 1:] - tables[:, :-1])
    d = jnp.where(sym_ids[None, :] < ns, d, 0)
    per_table = 5 + ns + 2 * jnp.sum(d, axis=-1)            # [_BNT]
    delta_bits = jnp.sum(jnp.where(t_ids < nt, per_table, 0))
    payload = jnp.sum(freqs * tables[0])
    total_bits = nseg_used + delta_bits + payload
    return nt, tables, total_bits
