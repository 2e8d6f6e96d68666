"""Entropy planning on device: batched package-merge + group refinement.

Everything here is statically shaped and jit/vmap-safe; the hot ops are
matrix products ([NSEG, 258] segment histograms against length tables),
batched sorts, and small scans — no data-dependent Python.

Algorithm (mirrors huffman_host.py, its differential oracle):
  * optimal 17-bit-limited code lengths by boundary package-merge, batched
    over (candidate, table);
  * 4 refinement sweeps with correct bzip2 semantics (fresh accumulators);
  * candidates: num_tables 2..6 plus a degenerate single-table plan; exact
    bit-cost accounting (selector unary-MTF, table deltas, payload) picks
    the winner on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    CODEWORD_MAX_LEN, MAX_SYMS as S, MAX_TABLES as T, SEGMENT_WIDTH,
)
# Candidate table counts: the full bzip2 range — the sweep is cheap
# relative to the sort-dominated stages and every fraction of a percent of
# compressed size counts against the bzip2 -9 baseline.
NT_CANDIDATES = (2, 3, 4, 5, 6)
_INF_W = np.int32(1 << 29)    # > any finite package weight (sum of freqs)
_BIG = np.float32(1e9)  # np scalars: no device put at import


def segment_view(x: jax.Array, nseg: int, fill) -> jax.Array:
    """Pad (with ``fill``) or truncate a [M] stream to [nseg, SEGMENT_WIDTH]
    segment slots — the one shared segmentation of the symbol stream used
    by both the planner's histogram and the bit packer's codeword lookup
    (they must agree or selectors and payload would silently diverge)."""
    L = nseg * SEGMENT_WIDTH
    M = x.shape[0]
    xp = x[:L] if M >= L else jnp.concatenate(
        [x, jnp.full(L - M, fill, x.dtype)]
    )
    return xp.reshape(nseg, SEGMENT_WIDTH)


def segment_hist(syms: jax.Array, out_len: jax.Array, nseg: int) -> jax.Array:
    """[nseg, S] float32 histogram of 50-symbol segments.

    Formulated as a one-hot compare + sum-reduce over [nseg, 50, S]: XLA
    fuses the iota-compare into the reduction loop (no materialization, no
    scatter).  Counts <= 50 are exact in f32.
    """
    M = syms.shape[0]
    pos = jnp.arange(M, dtype=jnp.int32)
    live = pos < out_len
    sym = jnp.where(live, syms, S)
    # Pad or truncate to nseg*50 slots; out_len <= nseg*50 by contract, so
    # truncated slots are always dead padding.
    sym_p = segment_view(sym, nseg, S)
    onehot = (
        sym_p[:, :, None] == jnp.arange(S, dtype=jnp.int32)[None, None, :]
    )
    return jnp.sum(onehot, axis=1, dtype=jnp.float32)


def pm_lengths(freqs: jax.Array, num_syms: jax.Array) -> jax.Array:
    """Batched package-merge code lengths (weights-only formulation).

    Forward: 17 levels of merged (weight, is-package) lists — batched tiny
    sorts, no per-leaf count matrices.  Backward: the chosen-count
    recurrence ``c_{l-1} = 2 * #packages-among-first-c_l``; a leaf's code
    length is the number of levels at which it is chosen, i.e.
    ``#{l : leaf_rank < x_l}``.  Ties order leaves before packages,
    matching huffman_host.pm_code_lengths bit-for-bit.

    Args:
      freqs: int32 [..., S], total sum < 2**29 (block symbol counts sum
        to <= 900_001, far below the INF sentinel; larger totals would
        tie finite packages with the absent-symbol padding).
      num_syms: int32 true alphabet size (3..258).
    Returns:
      int32 [..., S] lengths: in [1, 17] for s < num_syms, else 0.
    """
    L = CODEWORD_MAX_LEN
    sym_ids = jnp.arange(S, dtype=jnp.int32)
    w = jnp.where(sym_ids < num_syms, jnp.maximum(freqs, 1), _INF_W)
    iota = jnp.broadcast_to(sym_ids, w.shape)
    ws, worder = jax.lax.sort((w, iota), num_keys=1, dimension=w.ndim - 1)

    # Each level used to sort (weight, tag) as a 2-operand [.., 2S] sort
    # — a large fixed per-block cost at level 1.  Weights are
    # < _INF_W = 2^29, so the lexicographic
    # (weight, tag) key packs losslessly into ONE int32,
    # (w << 1) | tag < 2^31: integer order == the old 2-key order
    # bit-for-bit (ties order leaves, tag 0, before packages), the sort
    # carries one operand instead of two, and the tags come back as the
    # low bit.  (A rank-counting merge removes the sort entirely at the
    # price of two take_along_axis reads per level; it is the variant to
    # re-measure against this one on the GPU.)
    leaf_k = (ws << 1)                               # tag 0: leaves
    pair_w = jnp.full(ws.shape, _INF_W, jnp.int32)   # level-1 "pairs": none
    tag_cum_levels = []
    for _ in range(L):
        mk = jax.lax.sort(
            jnp.concatenate([leaf_k, (pair_w << 1) | 1], axis=-1),
            dimension=ws.ndim - 1,
            is_stable=False,
        )                                                    # [..., 2S]
        tag_cum_levels.append(jnp.cumsum(mk & 1, axis=-1))
        mw = mk >> 1
        pair_w = jnp.minimum(
            mw[..., 0::2] + mw[..., 1::2], _INF_W
        )                                                    # [..., S]
    tag_cum = jnp.stack(tag_cum_levels, axis=-2)             # [..., L, 2S]

    # Backward chosen-count recurrence (tiny, per level).
    def back(l_rev, carry):
        c, x = carry
        l = L - 1 - l_rev
        cum = jnp.take_along_axis(
            tag_cum[..., l, :],
            jnp.maximum(c - 1, 0)[..., None],
            axis=-1,
        )[..., 0]
        p = jnp.where(c > 0, cum, 0)                 # chosen packages
        x = x.at[..., l].set(c - p)
        return 2 * p, x

    c0 = jnp.broadcast_to(
        2 * num_syms - 2, ws.shape[:-1]
    ).astype(jnp.int32)
    x0 = jnp.zeros(ws.shape[:-1] + (L,), jnp.int32)
    _, x = jax.lax.fori_loop(0, L, back, (c0, x0), unroll=True)

    # lengths in sorted-leaf order, then undo the sort permutation.
    ranks = jnp.broadcast_to(sym_ids, ws.shape)
    lens_sorted = jnp.sum(
        (ranks[..., None] < x[..., None, :]).astype(jnp.int32), axis=-1
    )
    _, lens = jax.lax.sort((worder, lens_sorted), num_keys=1,
                           dimension=w.ndim - 1)
    return jnp.where(sym_ids < num_syms, lens, 0)


# Ragged candidate-table packing: the 2..6-table candidates' LIVE tables
# flatten onto one [_K] axis (col k belongs to candidate _COL_CAND[k],
# table _COL_TABLE[k]; candidate c owns cols [_COL_LO[c], _COL_LO[c+1])).
# The old [NC, T] = [5, 6] batch carried 10 dead tables through every
# package-merge level sort, and pm is a large fixed per-block cost.
_K = sum(NT_CANDIDATES)                                       # 20
_COL_CAND = np.concatenate(
    [np.full(nt, ci) for ci, nt in enumerate(NT_CANDIDATES)]
)
_COL_TABLE = np.concatenate([np.arange(nt) for nt in NT_CANDIDATES])
_COL_LO = np.concatenate([[0], np.cumsum(NT_CANDIDATES)])


def initial_tables(freqs: jax.Array, num_syms: jax.Array) -> jax.Array:
    """Initial partition lengths, ragged-packed: int32 [_K, S].

    Symbol s goes to table floor(cumfreq_incl(s)-1) * nt / total; in-range
    symbols cost 0, others 15 (the cheap-in-range variant; shared rule with
    huffman_host._initial_tables so host/device twins match exactly).
    """
    sym_ids = jnp.arange(S, dtype=jnp.int32)
    f = jnp.where(sym_ids < num_syms, jnp.maximum(freqs, 0), 0)
    cum = jnp.cumsum(f)
    total = jnp.maximum(cum[-1], 1)
    out = []
    for nt in NT_CANDIDATES:
        owner = jnp.clip(
            (jnp.maximum(cum - 1, 0) * nt) // total, 0, nt - 1
        )
        tbl = jnp.where(
            owner[None, :] == jnp.arange(nt, dtype=jnp.int32)[:, None],
            0, 15,
        )
        out.append(tbl)
    return jnp.concatenate(out).astype(jnp.int32)            # [_K, S]


def selector_mtf(sel: jax.Array, nseg_used: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Unary-MTF indices and total bits of a selector sequence.

    sel: int32 [..., NSEG]; returns (idx int32 [..., NSEG], bits int32).
    Closed form via per-table last-occurrence (no sequential scan).
    """
    nseg = sel.shape[-1]
    seg_pos = jnp.arange(nseg, dtype=jnp.int32)
    t_ids = jnp.arange(T, dtype=jnp.int32)
    marked = jnp.where(
        sel[..., :, None] == t_ids, seg_pos[:, None], -1
    )                                                   # [..., NSEG, T]
    last_incl = jax.lax.cummax(marked, axis=marked.ndim - 2)
    last = jnp.concatenate(
        [
            jnp.full(last_incl.shape[:-2] + (1, T), -1, jnp.int32),
            last_incl[..., :-1, :],
        ],
        axis=-2,
    )                                                   # exclusive
    # last[..., seg, sel[seg]] — a one-hot contraction over the tiny T
    # axis, not take_along_axis: the select+sum fuses into its neighbours
    # where a per-lane gather would not.
    sel_onehot = sel[..., :, None] == t_ids
    prev = jnp.sum(jnp.where(sel_onehot, last, 0), axis=-1)
    seen = last >= 0
    idx_seen = jnp.sum(
        (last > prev[..., None]).astype(jnp.int32), axis=-1
    )
    n_seen = jnp.sum(seen.astype(jnp.int32), axis=-1)
    n_seen_lt = jnp.sum(
        (seen & (t_ids < sel[..., :, None])).astype(jnp.int32), axis=-1
    )
    idx = jnp.where(prev >= 0, idx_seen, n_seen + sel - n_seen_lt)
    live = (seg_pos < nseg_used).astype(jnp.int32)
    bits = jnp.sum((idx + 1) * live, axis=-1)
    return idx, bits


def table_delta_bits(tables: jax.Array, num_syms: jax.Array) -> jax.Array:
    """Delta-coding cost per table set: int32 [...] summed over the last two
    axes (T tables x S symbols); only s < num_syms emit."""
    t = tables
    d = jnp.abs(t[..., 1:] - t[..., :-1])
    col = jnp.arange(1, S, dtype=jnp.int32)
    d = jnp.where(col < num_syms, d, 0)
    per_table = 5 + num_syms + 2 * jnp.sum(d, axis=-1)
    return jnp.sum(per_table, axis=-1)


def plan_entropy_device(
    syms: jax.Array, out_len: jax.Array,
    num_syms: jax.Array, nseg: int,
) -> dict:
    """Full candidate search; returns the winning plan (padded shapes)."""
    hist = segment_hist(syms, out_len, nseg)           # [NSEG, S] f32
    # Global frequencies fall out of the histogram column sums (exact in
    # f32: counts < 2**24), so the RLE2 stage's histogram is dead code.
    freqs = jnp.sum(hist, axis=0).astype(jnp.int32)
    nseg_used = (out_len + SEGMENT_WIDTH - 1) // SEGMENT_WIDTH

    # --- refinement for the candidate table counts, ragged-batched --------
    # All candidates' live tables share one [_K, S] axis; the final
    # iteration's pm batch carries the single-table plan's optimal table
    # as row _K, so the whole search runs 3x[_K] + 1x[_K+1] pm instances
    # instead of the old 4x[NC*T] + 1 (44% fewer pm lanes — pm is the
    # plan stage's dominant cost).  Per-candidate argmins are static
    # column slices: identical tie semantics to the old masked argmin
    # (first-wins within the candidate's own columns).
    tables = initial_tables(freqs, num_syms).astype(jnp.float32)  # [K,S]
    col_cand = jnp.asarray(_COL_CAND, dtype=jnp.int32)
    col_table = jnp.asarray(_COL_TABLE, dtype=jnp.int32)
    NC = len(NT_CANDIDATES)
    sel = tf = single = None
    for it in range(4):
        costs = hist @ tables.T                                   # [NSEG,K]
        sel = jnp.stack([
            jnp.argmin(
                jax.lax.slice(
                    costs, (0, int(_COL_LO[ci])),
                    (costs.shape[0], int(_COL_LO[ci + 1])),
                ),
                axis=-1,
            ).astype(jnp.int32)
            for ci in range(NC)
        ])                                                        # [NC,NSEG]
        onehot = (
            sel[col_cand] == col_table[:, None]
        ).astype(jnp.float32)                                     # [K,NSEG]
        tf = onehot @ hist                                        # [K,S]
        pm_in = tf.astype(jnp.int32)
        if it == 3:
            pm_in = jnp.concatenate([pm_in, freqs[None]])         # + single
        lens = pm_lengths(pm_in, num_syms)
        tables = lens[:_K].astype(jnp.float32)
        if it == 3:
            single = lens[_K]                                     # [S]
    tables_i = tables.astype(jnp.int32)                           # [K,S]

    sel_idx, sel_bits = selector_mtf(sel, nseg_used)              # [NC,...]
    # Table-def cost per column, summed per candidate.
    d = jnp.abs(tables_i[:, 1:] - tables_i[:, :-1])
    d = jnp.where(
        jnp.arange(1, S, dtype=jnp.int32)[None, :] < num_syms, d, 0
    )
    per_col = 5 + num_syms + 2 * jnp.sum(d, axis=-1)              # [K]
    # Payload per column: sum(tf * lens) — tf IS the final selection's
    # per-table histogram, so no [NSEG]-wide einsum is needed.
    pay_col = jnp.sum(tf * tables, axis=-1)                       # [K]
    delta_bits = jnp.stack([
        jnp.sum(
            jax.lax.slice(per_col, (int(_COL_LO[ci]),),
                          (int(_COL_LO[ci + 1]),))
        )
        for ci in range(NC)
    ])
    payload = jnp.stack([
        jnp.sum(
            jax.lax.slice(pay_col, (int(_COL_LO[ci]),),
                          (int(_COL_LO[ci + 1]),))
        )
        for ci in range(NC)
    ]).astype(jnp.int32)
    bits_multi = sel_bits + delta_bits + payload                  # [NC]

    # --- single-table candidate -------------------------------------------
    # Selectors never leave table 0; the mandatory second table is a
    # constant all-15s dummy (cheapest delta coding: 5 + num_syms bits),
    # matching huffman_host.plan_entropy bit-for-bit.  Its optimal table
    # rode the final pm batch above as row _K.
    sym_ids2 = jnp.arange(S, dtype=jnp.int32)
    dummy = jnp.where(sym_ids2 < num_syms, 15, 0).astype(jnp.int32)
    stables = jnp.concatenate(
        [single[None], jnp.broadcast_to(dummy, (T - 1, S))]
    ).astype(jnp.int32)
    s_sel = jnp.zeros((hist.shape[0],), jnp.int32)
    s_idx, s_selbits = selector_mtf(s_sel, nseg_used)
    sd = jnp.abs(single[1:] - single[:-1])
    sd = jnp.where(jnp.arange(1, S, dtype=jnp.int32) < num_syms, sd, 0)
    s_delta = (5 + num_syms + 2 * jnp.sum(sd)) + (5 + num_syms)
    s_payload = jnp.sum(hist * single[None, :].astype(jnp.float32))
    bits_single = s_selbits + s_delta + s_payload.astype(jnp.int32)

    # --- banzai's exact-plan split (the unconditional <=-banzai contract) --
    # Only the matmul half runs here; the sequential heap builds that turn
    # the split into banzai's exact total bits would be a long vmapped
    # device while_loop — they run on the HOST drain thread from
    # this split (huffman_host.banzai_bits_from_split), and the host
    # re-encodes the (vanishingly rare: banzai wins only via cheaper
    # delta coding on degenerate blocks) blocks where banzai's plan is
    # strictly smaller, via the byte-identical host backend whose
    # candidate set includes banzai's plan.  min(emitted) <= banzai still
    # holds by construction; the device hot path pays one matmul.
    from .banzai_plan import banzai_split_device

    b_split = banzai_split_device(hist, freqs, out_len, num_syms)

    # --- pick the winner ---------------------------------------------------
    all_bits = jnp.concatenate([bits_single[None], bits_multi])  # [NC+1]
    win = jnp.argmin(all_bits)
    all_nt = jnp.concatenate([
        jnp.array([2], jnp.int32),
        jnp.asarray(NT_CANDIDATES, dtype=jnp.int32),
    ])
    # Un-flatten each candidate's rows back to a padded [T, S] block for
    # the bit packer (tiny static slices; only the winner is read).
    cand_tables = jnp.stack([
        jnp.concatenate([
            jax.lax.slice(
                tables_i, (int(_COL_LO[ci]), 0),
                (int(_COL_LO[ci + 1]), S),
            ),
            jnp.zeros((T - nt, S), jnp.int32),
        ])
        for ci, nt in enumerate(NT_CANDIDATES)
    ])                                                           # [NC,T,S]
    all_tables = jnp.concatenate([stables[None], cand_tables])
    all_sel = jnp.concatenate([s_sel[None], sel])                # [.,NSEG]
    all_idx = jnp.concatenate([s_idx[None], sel_idx])
    return {
        "num_tables": all_nt[win],
        "tables": all_tables[win],
        "selectors": all_sel[win],
        "sel_mtf_idx": all_idx[win],
        "total_bits": all_bits[win],
        "nseg_used": nseg_used,
        "banzai_split": b_split,
    }
