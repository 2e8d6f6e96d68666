"""Device bitstream assembly: prefix-sum bit packing.

The reference writes its payload through a byte-serial bit splicer
(lib/out.rs).  On device the entire entropy payload of a block — the 3-bit
table count, 15-bit selector count, unary-MTF selectors, delta-coded length
tables, and every canonical codeword — is modeled as one array of
(value, bit-length) entries; an exclusive prefix sum of lengths gives each
entry's bit offset, and each entry scatter-ORs its <=32 bits into (at most)
two uint32 lanes of the output word array.  Zero-length entries encode
masked-out lanes, so every shape is static.

The host splices the resulting words after the block header + symbol map
(bitio.BitWriter.splice_words).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import (
    CODEWORD_MAX_LEN, MAX_SYMS as S, MAX_TABLES as T, SEGMENT_WIDTH,
)


def canonical_words(tables: jax.Array, num_syms: jax.Array) -> jax.Array:
    """Canonical codewords per (table, symbol): int32 [T, S].

    Assignment order (length asc, symbol asc) per the bzip2 format
    (lib/huffman.rs:547-561), computed in closed form: word(s) =
    first_code[len(s)] + rank(s among same-length symbols).
    """
    sym_ids = jnp.arange(S, dtype=jnp.int32)
    lens = jnp.where(sym_ids < num_syms, tables, 0)         # [T, S]
    counts = []
    ranks = jnp.zeros_like(lens)
    for l in range(1, CODEWORD_MAX_LEN + 1):
        is_l = (lens == l).astype(jnp.int32)
        counts.append(jnp.sum(is_l, axis=-1))
        c = jnp.cumsum(is_l, axis=-1)
        ranks = ranks + jnp.where(lens == l, c - 1, 0)
    fc = jnp.zeros_like(counts[0])
    first_codes = [jnp.zeros_like(counts[0])]               # for length 1
    for l in range(1, CODEWORD_MAX_LEN):
        fc = (first_codes[-1] + counts[l - 1]) << 1
        first_codes.append(fc)
    fc_table = jnp.stack(first_codes, axis=-1)              # [T, 17]
    fci = jnp.take_along_axis(
        fc_table, jnp.maximum(lens - 1, 0), axis=-1
    )
    return fci + ranks


def splice_entries(
    vals: jax.Array, lens: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Per-entry word contributions, shared by both packing back ends.

    Returns (w, hi2, total): entry i contributes the 32-bit field
    ``hi2[i]`` to word ``w[i]`` (disjoint bit fields per word, so OR ==
    ADD), plus the scalar total bit count.  Arrays carry one appended
    sentinel entry that catches the last real entry's spill.
    """
    # Sentinel entry: receives the last real entry's spill (see hi2).
    lens = jnp.concatenate([lens.astype(jnp.int32), jnp.zeros(1, jnp.int32)])
    vals = jnp.concatenate([vals.astype(jnp.uint32), jnp.zeros(1, jnp.uint32)])
    lens_u = lens.astype(jnp.uint32)
    v = vals.astype(jnp.uint32) & jnp.where(
        lens >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << lens_u) - 1
    )
    off = jnp.cumsum(lens) - lens
    total = jnp.sum(lens)
    w = off >> 5
    b = off & 31
    space = 32 - b
    fits = lens <= space
    hi = jnp.where(
        fits,
        # & 31: a zero-length entry at a word boundary gives space-lens
        # == 32, and shl-by-width is undefined in XLA (v is 0 there, so
        # any defined shift result is correct).
        v << ((jnp.where(fits, space - lens, 0) & 31).astype(jnp.uint32)),
        v >> jnp.where(fits, 0, lens - space).astype(jnp.uint32),
    )
    lo = jnp.where(
        fits,
        jnp.uint32(0),
        v << (((64 - b - lens) & 31).astype(jnp.uint32)),
    )
    # An entry's spill (lo) lands in word w+1 — and the NEXT entry always
    # starts in exactly that word (off is contiguous: b+len > 32 implies
    # w_next == w+1 even for zero-length followers), occupying bits
    # strictly below the spill.  So each lo OR-folds into the successor's
    # hi (disjoint fields; the appended sentinel catches the last spill),
    # and the whole word assembly needs ONE contribution stream.
    hi2 = hi | jnp.concatenate([jnp.zeros(1, jnp.uint32), lo[:-1]])
    return w, hi2, total


def pack_entries(
    vals: jax.Array, lens: jax.Array, nwords: int
) -> tuple[jax.Array, jax.Array]:
    """Scatter (value, bit-length) entries MSB-first into uint32 words."""
    w, hi2, total = splice_entries(vals, lens)
    # Word assembly without scatters: contributions to a word are a
    # contiguous run of entries (w is sorted), and OR == ADD for disjoint
    # bit fields, so word x is a difference of wrapping prefix sums over
    # "entries with w <= x".  Those prefixes fall out of a *merge*: one
    # sort interleaves entries (key 2w) with word queries (key 2x+1), a
    # cumsum over the merged hi2 lands each query lane exactly on its
    # prefix, and a second sort compacts the query lanes back out: two
    # 2-op sorts + one cumsum in place of a scatter-max + cummax +
    # gathers.
    E = lens.shape[0]
    Q = nwords + 1
    e_key = 2 * jnp.minimum(w, nwords)
    q_key = 2 * jnp.arange(Q, dtype=jnp.int32) + 1
    keys = jnp.concatenate([e_key, q_key])
    his = jnp.concatenate(
        [jax.lax.bitcast_convert_type(hi2, jnp.int32), jnp.zeros(Q, jnp.int32)]
    )
    k_s, hi_s = jax.lax.sort((keys, his), num_keys=1, is_stable=False)
    s_hi = jnp.cumsum(hi_s)     # int32 wrap == mod-2^32, exact for OR==ADD
    is_q = (k_s & 1) == 1
    qx = jnp.where(is_q, k_s >> 1, jnp.int32(2 * nwords + 4))
    _, g_hi = jax.lax.sort((qx, s_hi), num_keys=1, is_stable=False)
    g_hi = g_hi[:Q]
    g_hi_prev = jnp.concatenate([jnp.zeros(1, jnp.int32), g_hi[:-1]])
    words = g_hi - g_hi_prev
    return (
        jax.lax.bitcast_convert_type(words[:nwords], jnp.uint32),
        total,
    )


def block_payload_entries(
    syms: jax.Array,
    out_len: jax.Array,
    num_syms: jax.Array,
    num_tables: jax.Array,
    tables: jax.Array,
    selectors: jax.Array,
    sel_mtf_idx: jax.Array,
    nseg_used: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Build the (vals, lens) entry arrays for one block's entropy payload."""
    M = syms.shape[0]
    nseg = selectors.shape[0]
    # num_selectors is a 15-bit format field (lib/huffman.rs:470): the
    # static segment capacity bounds nseg_used, so guard it at trace time
    # — a future block-capacity change past 32767*50 symbols would wrap
    # the field and corrupt the stream silently (the bzip2 -d oracle
    # would only catch it after the fact).
    assert nseg < (1 << 15), f"num_selectors capacity {nseg} overflows 15 bits"

    # -- header: num_tables (3), num_selectors (15) -------------------------
    h_vals = jnp.stack([num_tables, nseg_used]).astype(jnp.uint32)
    h_lens = jnp.array([3, 15], jnp.int32)

    # -- selectors: unary MTF codes ----------------------------------------
    seg_pos = jnp.arange(nseg, dtype=jnp.int32)
    live_seg = seg_pos < nseg_used
    s_vals = (
        (jnp.uint32(1) << (sel_mtf_idx + 1).astype(jnp.uint32)) - 2
    ).astype(jnp.uint32)
    s_lens = jnp.where(live_seg, sel_mtf_idx + 1, 0)

    # -- tables: 5-bit initial + per symbol delta groups + terminator ------
    sym_ids = jnp.arange(S, dtype=jnp.int32)
    t_ids = jnp.arange(T, dtype=jnp.int32)
    t_live = t_ids < num_tables                             # [T]
    s_live = sym_ids < num_syms                             # [S]
    lens_tab = tables.astype(jnp.int32)                     # [T, S]
    prev = jnp.concatenate([lens_tab[:, :1], lens_tab[:, :-1]], axis=1)
    d = lens_tab - prev
    dabs = jnp.abs(d)
    inc = d > 0
    ga = jnp.minimum(dabs, 8)
    gb = dabs - ga

    def group_pattern(g, is_inc):
        base = (
            (jnp.uint32(1) << (2 * g).astype(jnp.uint32)) - 1
        ) // 3                                              # 0b0101..
        return jnp.where(is_inc, base * 2, base * 3)

    emit = (t_live[:, None] & s_live[None, :])
    a_vals = group_pattern(ga, inc)
    a_lens = jnp.where(emit, 2 * ga, 0)
    b_vals = group_pattern(gb, inc)
    b_lens = jnp.where(emit, 2 * gb, 0)
    z_vals = jnp.zeros((T, S), jnp.uint32)
    z_lens = jnp.where(emit, 1, 0)
    init_vals = lens_tab[:, 0].astype(jnp.uint32)
    init_lens = jnp.where(t_live, 5, 0)
    # interleave per table: init, then (A,B,term) per symbol
    per_sym = jnp.stack([a_vals, b_vals, z_vals], axis=2)   # [T, S, 3]
    per_sym_l = jnp.stack([a_lens, b_lens, z_lens], axis=2)
    t_vals = jnp.concatenate(
        [init_vals[:, None], per_sym.reshape(T, S * 3)], axis=1
    ).reshape(-1)
    t_lens = jnp.concatenate(
        [init_lens[:, None], per_sym_l.reshape(T, S * 3)], axis=1
    ).reshape(-1)

    # -- payload codewords --------------------------------------------------
    # Per-segment table rows by a T-way integer select, then the per-symbol
    # lookup as a segment-blocked one-hot compare + int32 sum-reduce — XLA
    # fuses the compare into the reduction, so no full-width gather runs.
    words_tab = canonical_words(lens_tab, num_syms)         # [T, S]
    packed_tab = (words_tab << 5) | lens_tab                # word<2^17,len<32
    pos = jnp.arange(M, dtype=jnp.int32)
    live = pos < out_len
    sym_c = jnp.where(live, jnp.minimum(syms, S - 1), 0)
    # T-way integer select (NOT a float one-hot matmul: a default-
    # precision matmul may run in reduced precision (TF32 on the GPU),
    # which cannot carry 22-bit packed codeword values exactly).
    tab_seg = jnp.zeros((nseg, S), jnp.int32)                # [nseg, S]
    for t in range(T):
        tab_seg = jnp.where(
            selectors[:, None] == t, packed_tab[t][None, :], tab_seg
        )
    from .huffman import segment_view

    sym_p = segment_view(sym_c, nseg, 0)
    sym_ids_s = jnp.arange(S, dtype=jnp.int32)
    packed = jnp.sum(
        jnp.where(
            sym_p[:, :, None] == sym_ids_s[None, None, :],
            tab_seg[:, None, :],
            0,
        ),
        axis=2,
    ).reshape(-1)
    L = nseg * SEGMENT_WIDTH
    packed = packed[:M] if L >= M else jnp.concatenate(
        [packed, jnp.zeros(M - L, jnp.int32)]
    )
    p_vals = (packed >> 5).astype(jnp.uint32)
    p_lens = jnp.where(live, packed & 31, 0)

    vals = jnp.concatenate([h_vals, s_vals, t_vals, p_vals])
    lens = jnp.concatenate([h_lens, s_lens, t_lens, p_lens])
    return vals, lens
