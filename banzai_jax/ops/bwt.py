"""Wrap-around BWT on device: cyclic prefix-doubling rotation sort.

The reference computes the cyclic BWT by running sequential SA-IS over the
doubled input (lib/bwt.rs:526-756) — pointer-chasing induced sorting that
does not map onto batched array transforms.  This design sorts the n
*rotations* directly by prefix doubling (Manber–Myers): O(log n) rounds of
sort-by-shifted-ranks + rank relabeling, where every round is a batched XLA
sort plus elementwise scans — exactly the shape XLA compiles well.  No
doubled input is needed: the cyclic shift ``(i + k) mod n`` realizes
rotation comparison exactly.

Engineering choices (each trades gathers and scatters for sorts and
contiguous slices; their cost on the GPU is yet to be re-measured):
  * the ``(i+k) mod n`` access is two contiguous dynamic slices, not a
    gather;
  * inverse permutations are key-sorts, not scatters;
  * round 1 sorts a _R1_LEN-byte packed prefix (one 3-byte lane with
    headroom for the pad sentinel + _R1_WORDS full 4-byte lanes) in a
    single multi-key sort, so octupling starts at k = _R1_LEN;
  * later full-width rounds sort ranks at offsets (0, k, ..., 7k) —
    octupling coverage per round (_FMULT = 8) — and run only while the
    unresolved lane count is too large for the compact buffer (full-width
    rounds need no gathers; compact rounds cost ~gathers x width);
  * ranks are *positional* (Larsson–Sadakane style: a rank is the SA slot
    of its group head), so refinement touches only unresolved lanes;
  * refinement runs over a cascade of compact buffers (N/8 → N/32 →
    N/128): resolved lanes are killed each round and sort to the back, so
    the live prefix shrinks and each tier's sorts/gathers/scatters get
    proportionally cheaper;
  * a round that splits no group is a fixpoint (remaining ties are
    identical rotations — periodic input), so every loop exits early
    instead of doubling k all the way to n;
  * all sorts are unstable (is_stable=False): positional ranks depend
    only on key-equality patterns, never on tie order, and unstable
    bitonic sorts skip XLA's implicit index tiebreaker key.

Shapes are static: blocks are padded to capacity N; padded positions get
rank +inf so they sort behind every real rotation and never disturb them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_PAD_RANK = np.int32(2**30)  # numpy scalar: no device put at import


def _sort(ops, num_keys):
    return jax.lax.sort(ops, num_keys=num_keys, is_stable=False)


@jax.jit
def bwt_rotations(block: jax.Array, n: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Compute the wrap-around BWT of ``block[:n]``.

    Args:
      block: uint8[N] padded block (N static).
      n: int32 true length (1 <= n <= N).
    Returns:
      (bwt uint8[N] — first ``n`` entries valid, ptr int32).
    """
    N = block.shape[0]
    assert N < (1 << 20), "position+cmp key packing assumes N < 2^20"
    # Tier widths.  A tier round pays random gathers + a scatter-back per
    # lane touched, a full-width round only sorts, so full-width
    # octupling rounds burn down the dense phase and tiers take the
    # sparse tail.  W1 sizing: the post-full-round live count on text is
    # 5.8-6.7% of n (a count of lanes, not a time), so N/14 fits it with
    # margin; a corpus that lands in (N/14, N/8] just runs one more
    # octupling full round.
    W1 = min(max(N // 14, 1024), N)
    W3 = min(max(N // 128, 256), W1)
    idx = jnp.arange(N, dtype=jnp.int32)
    valid = idx < n
    zeros = jnp.zeros(N, jnp.int32)

    b = jnp.where(valid, block.astype(jnp.int32), 0)

    # Cyclic extension of the block: dbl[j] = b[j mod n] for every j the
    # prefix keys read (j <= (n-1) + QMAX + 14).  Built by log-doubling the
    # covered prefix — ~20 cheap dynamic-update-slices — so that every
    # byte(off) below is a *static* slice that fuses into its consumers
    # (the old per-offset dynamic-slice pairs were ~230 separate thunks).
    # Extension length: must cover BOTH the static byte() reach
    # (_QMAX + _R1_LEN past position N-1) and the largest doubling write —
    # cov can reach need-1 = n + _QMAX + _R1_LEN - 1 <= N + 28 before the
    # final extension write of N lanes, so anything shorter lets
    # dynamic_update_slice clamp the start and corrupt the extension
    # (observed: wrong BWT for N in [24,40), n in [15,20]).
    extn = N + _QMAX + _R1_LEN + 8
    dbl0 = jax.lax.dynamic_update_slice(
        jnp.zeros(N + extn, jnp.int32), b, (0,)
    )
    need = n + _QMAX + _R1_LEN

    # cov = n * 2^t >= need: ONE doubling suffices for n >= 36 (every
    # production block — the pipeline diverts blocks <= 16 KiB to the
    # host), and a fixed chain of 6 MASKED doublings covers any n >= 0
    # (64 * max(n,1) >= n + 36).  The chain replaces a vmapped while_loop,
    # whose shell costs dispatch overhead even at zero trips.  A step
    # whose cov already
    # reaches ``need`` writes the first N lanes onto themselves at offset
    # 0 — the safe no-op; writing past the buffer would CLAMP the start
    # and corrupt the extension (see the extn sizing note above).  Steps
    # with cov < need write garbage into [2*cov, cov+N), exactly like the
    # old loop did; the next step overwrites it, and the final garbage
    # tail lives beyond ``need`` where only PAD-lane keys (masked by
    # key0 = _PAD_RANK) ever read.
    with jax.named_scope("bwt_extend"):
        dbl, cov = dbl0, jnp.maximum(n, 1)
        # Step 1 always runs for real (cov = n < need).
        dbl = jax.lax.dynamic_update_slice(
            dbl, jax.lax.slice(dbl, (0,), (N,)), (cov,)
        )
        cov = cov * 2
        # Steps 2..6 only do real work when n < 36 (cov = 2n < n + 36),
        # so a short window suffices: need <= 72 there, and the window
        # start stays < 2 * 72 — far inside the buffer.
        SHORT = min(N, 4096)
        for _ in range(5):
            off = jnp.where(cov < need, cov, 0)
            dbl = jax.lax.dynamic_update_slice(
                dbl, jax.lax.slice(dbl, (0,), (SHORT,)), (off,)
            )
            cov = cov * 2

    def byte(off: int) -> jax.Array:
        return jax.lax.slice(dbl, (off,), (off + N,))

    def relabel(diffs: jax.Array):
        """Positional ranks from a sorted-neighbor difference mask.

        Returns (rank_sorted, live_groups, unresolved, multi): positional
        ranks over the sorted array, the number of groups of size > 1, the
        number of lanes in those groups, and their mask (valid lanes are
        exactly the first n sorted slots).
        """
        is_head = jnp.concatenate([jnp.ones(1, bool), diffs])
        head_pos = jax.lax.cummax(jnp.where(is_head, idx, -1), axis=0)
        ngroups = jnp.sum((is_head & valid).astype(jnp.int32))
        nxt_head = jnp.concatenate([is_head[1:], jnp.ones(1, bool)])
        single = is_head & nxt_head
        nsingle = jnp.sum((single & valid).astype(jnp.int32))
        unres = n - nsingle
        return head_pos, ngroups - nsingle, unres, ~single

    # ---- Round 1: _R1_LEN-byte packed prefix, one multi-key sort ----------
    # idx rides in the last *key* (not payload) so ties keep ascending
    # positions — the chain-resolution pass below needs per-group position
    # order.
    pack3 = (b << 16) | (byte(1) << 8) | byte(2)
    key0 = jnp.where(valid, pack3, _PAD_RANK)

    def pack4(off: int) -> jax.Array:
        v = (
            (byte(off) << 24)
            | (byte(off + 1) << 16)
            | (byte(off + 2) << 8)
            | byte(off + 3)
        )
        return v.astype(jnp.uint32)

    kws = [pack4(3 + 4 * w) for w in range(_R1_WORDS)]

    # Chain-resolution precompute (position space, zero gathers): for every
    # candidate period q the lex relation between prefix(i+q) and
    # prefix(i), as (gt, eq) bit pairs.  The 2*QMAX cmp bits share ONE
    # uint32 key with the position (idx << 12 | cmpbits): positions are
    # unique, so the comparison never reaches the cmp bits, ties still come
    # out in ascending-position order, and round 1 needs one less sort
    # operand.  See _resolve_chains for how the bits are used.
    cmpbits = zeros
    for q in range(1, _QMAX + 1):
        q0 = (byte(q) << 16) | (byte(q + 1) << 8) | byte(q + 2)
        qws = [pack4(q + 3 + 4 * w) for w in range(_R1_WORDS)]
        gt = jnp.zeros(N, bool)
        eq = jnp.ones(N, bool)
        for qa, ka in zip(reversed(qws), reversed(kws)):
            gt = (qa > ka) | ((qa == ka) & gt)
            eq = (qa == ka) & eq
        gt = (q0 > pack3) | ((q0 == pack3) & gt)
        eq = (q0 == pack3) & eq
        cmpbits = cmpbits | (
            gt.astype(jnp.int32) << (2 * (q - 1))
        ) | (eq.astype(jnp.int32) << (2 * (q - 1) + 1))

    idx_cmp = (
        idx.astype(jnp.uint32) << 12
    ) | cmpbits.astype(jnp.uint32)
    with jax.named_scope("bwt_r1_sort"):
        sorted_r1 = _sort(
            (key0, *kws, idx_cmp), num_keys=1 + _R1_WORDS + 1
        )
    oc_s = sorted_r1[-1]
    order = (oc_s >> 12).astype(jnp.int32)
    cmp_s = (oc_s & 0xFFF).astype(jnp.int32)
    diffs = jnp.zeros(N - 1, bool)
    for s_op in sorted_r1[:-1]:
        diffs = diffs | (s_op[1:] != s_op[:-1])
    rank_sorted, live_groups, unres, multi = relabel(diffs)
    k = jnp.int32(_R1_LEN)

    # ---- Tandem-repeat chain resolution ------------------------------------
    # Periodic regions (runs after RLE1, short-period repeats) produce huge
    # tie groups that plain doubling needs ~log4(region) full-width rounds
    # to split.  But a group whose members form an arithmetic chain
    # p, p+q, ..., with step q <= k is *analytically* ordered: equal
    # k-prefixes give data period q over the chain span, so
    # cmp(rot(p_j), rot(p_j+q)) telescopes to cmp(rot(p_end), rot(p_end+q))
    # — one cross-group comparison at the chain end decides whether the
    # whole chain ascends or descends by position (the tandem-repeat
    # insight of Itoh–Tanaka-style suffix sorters).  The comparison itself
    # is the precomputed prefix15 relation carried in ``cmp_s``, so the
    # pass costs no gather and the single inverse-permutation sort below
    # doubles as round 1's rank inversion.
    with jax.named_scope("bwt_chains"):
        rank, resolved_lanes, resolved_groups, applied = _resolve_chains(
            rank_sorted, order, cmp_s, n, idx, valid
        )
    multi = multi & ~applied
    unres = unres - resolved_lanes
    live_groups = live_groups - resolved_groups
    done = (unres == 0) | (k >= n)

    # ---- Full-width octupling rounds while unresolved lanes are dense -----
    # Offsets k..7k tile [p, p+8k) of rank coverage in ONE multi-key sort;
    # the shifts are single dynamic slices of a 2-copy rank extension, so
    # one wide round costs barely more than a quadrupling round but
    # usually ends the full-width phase in a single lockstep iteration.
    # Sort traffic is the floor here (XLA's sort is bandwidth-bound), so
    # the 8 shifted ranks ride as 20-BIT FIELDS packed into 5 uint32 key
    # words instead of 8 int32 operands: valid ranks are < n < 2^20 and
    # the pad sentinel becomes the field max 2^20-1, so lexicographic
    # word comparison equals the unpacked multi-key order while moving
    # 6 operands (5 keys + idx payload) instead of 9 — a third less
    # bandwidth per round.
    _FMULT = 8
    _FM_PAD = jnp.int32((1 << 20) - 1)   # per-field pad: > any valid rank

    def full_round(state):
        k, rank, _o, _m, live_groups, _u, _d = state
        dblr = jax.lax.dynamic_update_slice(
            jnp.full(2 * N, _FM_PAD, jnp.int32), rank, (0,)
        )
        dblr = jax.lax.dynamic_update_slice(dblr, rank, (n,))

        def shift(m):
            if m == 0:
                return jnp.where(valid, rank, _FM_PAD).astype(jnp.uint32)
            s = jnp.where(n > 0, (m * k) % n, 0)
            r = jax.lax.dynamic_slice(dblr, (s,), (N,))
            return jnp.where(valid, r, _FM_PAD).astype(jnp.uint32)

        # Pack 8 x 20-bit fields MSB-first into 5 x 32-bit words: field m
        # occupies key bits [160-20(m+1), 160-20m); word w covers key bits
        # [160-32(w+1), 160-32w).  A field's contribution to a word is the
        # field shifted by (field_lsb - word_lsb): left when the field
        # sits above the word's LSB, right when its tail hangs below.
        fields = [shift(m) for m in range(_FMULT)]
        words = []
        for w in range(5):
            w_lo = 160 - 32 * (w + 1)
            acc = jnp.zeros(N, jnp.uint32)
            for m in range(_FMULT):
                sh = (160 - 20 * (m + 1)) - w_lo
                if sh >= 32 or sh <= -20:
                    continue
                if sh >= 0:
                    acc = acc | (fields[m] << sh)
                else:
                    acc = acc | (fields[m] >> -sh)
            words.append(acc)

        sorted_ops = _sort(tuple(words) + (idx,), num_keys=5)
        order = sorted_ops[-1]
        diffs = jnp.zeros(N - 1, bool)
        for s_op in sorted_ops[:-1]:
            diffs = diffs | (s_op[1:] != s_op[:-1])
        rank_sorted, lg2, unres, multi = relabel(diffs)
        _, new_rank = _sort((order, rank_sorted), num_keys=1)
        new_rank = jnp.where(valid, new_rank, _PAD_RANK)
        kx = k * _FMULT
        # No group of size > 1 split and none resolved => fixpoint
        # (identical rotations); kx >= n => prefix covers the rotation.
        stalled = (lg2 == live_groups) & (unres == state[5])
        done = (unres == 0) | stalled | (kx >= n)
        return (kx, new_rank, order, multi, lg2, unres, done)

    state = (k, rank, order, multi, live_groups, unres, done)
    with jax.named_scope("bwt_full"):
        state = jax.lax.while_loop(
            lambda s: ~s[6] & (s[5] > W1), full_round, state
        )
    k, rank, order, multi, live_groups, unres, done = state

    # ---- Compact refinement cascade ---------------------------------------
    # Unresolved lanes (whole groups) move to a narrow buffer holding
    # (position, group-head rank); resolved lanes are killed each round and
    # sort to the back, so the live prefix shrinks monotonically.
    # Tier rounds re-sort by group head anyway, so the compaction only has
    # to bring live lanes to the front: a 1-operand key sort, with the
    # positions recovered by a narrow W1-lane gather from ``order`` —
    # cheaper than carrying ``order`` as a sort payload through N lanes.
    ckey = jnp.where(multi & valid, idx, _PAD_RANK)
    (ck_s,) = _sort((ckey,), num_keys=1)

    # Compact rounds multiply k by (mults + 1) per round: offsets k..mults*k
    # in one fused gather + one (mults+1)-key sort.  Octupling (mults=7)
    # doubles coverage per round vs quadrupling for the same total gather
    # lanes, halving the per-round fixed costs (sort dispatch,
    # scatter-back, loop overhead).  The narrow tail tiers are bound by
    # per-round fixed overhead (repack + vmapped loop shell), not width,
    # so higher multipliers (15, 31) buy little there.  Every call site
    # uses the default; the ``mults`` parameter stays for experiments.
    _MULTS = 7

    def make_tier(W: int, mults: int = _MULTS):
        j2 = jnp.arange(W, dtype=jnp.int32)

        def tier_body(st):
            k, rank, c_pos, c_head, live_groups, _done = st
            live = c_head < _PAD_RANK
            ext = jnp.concatenate([rank, jnp.zeros(1, jnp.int32)])

            # All shifted-rank lookups ride ONE gather of mults*W lanes.
            marange = jnp.arange(1, mults + 1, dtype=jnp.int32)
            j = c_pos[None, :] + marange[:, None] * k
            j = jnp.where(n > 0, j % n, 0)
            j = jnp.where(live[None, :], j, N)
            gs = jnp.where(
                live[None, :], ext[j.reshape(-1)].reshape(mults, W),
                _PAD_RANK,
            )

            sorted_ops = _sort(
                (c_head, *tuple(gs), c_pos), num_keys=1 + mults
            )
            h_s = sorted_ops[0]
            p_s = sorted_ops[-1]
            grp_change = jnp.concatenate(
                [jnp.zeros(1, bool), h_s[1:] != h_s[:-1]]
            )
            key_change = jnp.zeros(W - 1, bool)
            for g_s in sorted_ops[1:-1]:
                key_change = key_change | (g_s[1:] != g_s[:-1])
            sub_change = grp_change | jnp.concatenate(
                [jnp.zeros(1, bool), key_change]
            )
            grp_start = jax.lax.cummax(
                jnp.where(grp_change | (j2 == 0), j2, -1), axis=0
            )
            sub_start = jax.lax.cummax(
                jnp.where(sub_change | (j2 == 0), j2, -1), axis=0
            )
            live_s = h_s < _PAD_RANK
            new_head = jnp.where(
                live_s, h_s + (sub_start - grp_start), _PAD_RANK
            )
            # Scatter refined ranks back into the full rank array (lanes
            # resolved this round carry their final rank here too).
            tgt = jnp.where(live_s, p_s, N)
            rank2 = (
                jnp.concatenate([rank, jnp.zeros(1, jnp.int32)])
                .at[tgt]
                .set(jnp.where(live_s, new_head, 0))[:N]
            )
            rank2 = jnp.where(valid, rank2, _PAD_RANK)
            # Kill resolved lanes: singleton sub-groups are final.
            is_start = sub_change | (j2 == 0)
            sub_end = jnp.concatenate([sub_change[1:], jnp.ones(1, bool)])
            single = is_start & sub_end & live_s
            c_head2 = jnp.where(single, _PAD_RANK, new_head)
            nsub = jnp.sum((is_start & live_s).astype(jnp.int32))
            nsingle = jnp.sum(single.astype(jnp.int32))
            unres2 = jnp.sum(live_s.astype(jnp.int32)) - nsingle
            knext = k * (mults + 1)
            # nsub == live_groups entering <=> no live group split.
            done = (unres2 == 0) | (nsub == live_groups) | (knext >= n)
            return (knext, rank2, p_s, c_head2, nsub - nsingle, done)

        return tier_body

    # Tier 1 (W1): enter from the full-width state.  Positions and
    # group-head ranks are recovered with two narrow gathers
    # (order[c_slot], rank[c_pos]).
    c_slot1 = ck_s[:W1]
    lane_live1 = c_slot1 < _PAD_RANK
    ext_o = jnp.concatenate([order, jnp.zeros(1, jnp.int32)])
    c_pos1 = jnp.where(
        lane_live1, ext_o[jnp.where(lane_live1, c_slot1, N)], 0
    )
    ext_r = jnp.concatenate([rank, jnp.full(1, _PAD_RANK, jnp.int32)])
    c_head1 = jnp.where(
        lane_live1, ext_r[jnp.where(lane_live1, c_pos1, N)], _PAD_RANK
    )
    st = (k, rank, c_pos1, c_head1, live_groups, done)
    with jax.named_scope("bwt_tier1"):
        st = jax.lax.while_loop(
            lambda s: ~s[5] & (_live(s[3]) > W3), make_tier(W1), st
        )

    # Tier switches must re-pack live lanes to the front: a tier round only
    # pushes lanes killed in *previous* rounds to the back (they sort last
    # by their PAD head at the next sort), so lanes killed in the tier's
    # final round are still interleaved when the loop exits.  One narrow
    # 2-op sort per switch restores the packed invariant before truncating.
    def repack(st, W: int):
        h2, p2 = _sort((st[3], st[2]), num_keys=1)
        return (st[0], st[1], p2[:W], h2[:W], st[4], st[5])

    # No middle tier: the live-lane count (a property of the data, not of
    # the device) jumps from ~6% of n straight to <= W3 after ONE tier-1
    # round on every corpus tried, so a W2 = N/32 tier would never run
    # its body yet pay a repack + vmapped loop shell (max-trip semantics
    # bill every block for the shell).  A block that does land in
    # (W3, W1] live lanes simply takes one more W1-width round.

    # Tier 3 (W3): run to completion.  The tail is fixed-overhead-bound
    # (17 sort operands at 7K lanes, or one more repack + loop shell for
    # a separate 32x tier), so it keeps octupling.
    with jax.named_scope("bwt_tier3"):
        st = repack(st, W3)
        st = jax.lax.while_loop(lambda s: ~s[5], make_tier(W3), st)
    rank = st[1]

    # Extract the BWT column by sorting the preceding-byte payload by final
    # rank — one key sort instead of a full-width random gather.  Tied
    # (identical) rotations carry identical preceding bytes, so unstable
    # tie order is harmless; ptr may point at any row of rotation 0's tie
    # group (all rows are identical strings).
    # prev_byte[i] = b[(i + n - 1) mod n] = dbl[i + n - 1] (coverage >= 2n-1).
    # The byte rides the low 8 bits of the rank key (valid ranks < n < 2^20,
    # so rank<<8 stays within int32), making this a 1-operand sort; pad
    # lanes sort last under a small sentinel with zero byte bits.
    with jax.named_scope("bwt_extract"):
        prev_byte = jax.lax.dynamic_slice(
            dbl, (jnp.maximum(n - 1, 0),), (N,)
        )
        packed_rb = jnp.where(valid, (rank << 8) | prev_byte, _PAD_RANK)
        (rb_sorted,) = _sort((packed_rb,), num_keys=1)
        bwt = (rb_sorted & 0xFF).astype(jnp.uint8)
        ptr = jnp.sum(((rank < rank[0]) & valid).astype(jnp.int32))
    return bwt, ptr


def _live(c_head: jax.Array) -> jax.Array:
    return jnp.sum((c_head < _PAD_RANK).astype(jnp.int32))


_R1_WORDS = 3  # 4-byte words after the 3-byte head: prefix = 3 + 4*_R1_WORDS
# Why 3 and not wider: on repetitive text (bench corpus: source code) the
# unresolved fraction is ~47% at 15-byte coverage, ~26% at 27 — both above
# the N/8 tier entry, and reaching it needs ~120-byte coverage (~30 sort
# operands).  One octupling full round runs either way, so extra round-1
# operands and a wider cmp precompute buy nothing.
_R1_LEN = 3 + 4 * _R1_WORDS

_QMAX = 6   # chain steps detected; must be <= the rank coverage k at entry
# and <= 6 so the 2*QMAX cmp bits fit beside a 20-bit position in one
# uint32 sort key (N < 2^20).  Real periodic data — RLE1-coded runs
# (period 5), short repeats — has fundamental period well under 6; longer
# periods fall back to the doubling rounds.


def _resolve_chains(r_s, p_s, cmp_s, n, idx, valid):
    """Resolve arithmetic tie chains (tandem repeats) in closed form.

    Operates in sorted space: ``r_s`` positional ranks per SA slot, ``p_s``
    positions (ascending within tie groups — round 1 sorts with the
    position as a final key), ``cmp_s`` the packed per-period prefix15
    relations (bit 2(q-1): prefix15(p+q) > prefix15(p); bit 2(q-1)+1:
    equal) computed gather-free in position space.  Only groups whose
    members form one arithmetic progression with step q in [1, QMAX]
    (QMAX <= k, so equal k-prefixes prove data periodicity over the chain
    span) are touched.  Returns (position-space rank — this sort also
    realizes round 1's rank inversion for untouched lanes — plus #lanes
    resolved, #groups resolved, per-slot applied mask).
    """
    slot_valid = idx < n

    same = jnp.concatenate(
        [jnp.zeros(1, bool), r_s[1:] == r_s[:-1]]
    ) & slot_valid
    is_head = ~same
    gstart = jax.lax.cummax(jnp.where(is_head, idx, -1), axis=0)
    step = jnp.concatenate([jnp.zeros(1, jnp.int32), p_s[1:] - p_s[:-1]])
    prev_head = jnp.concatenate([jnp.ones(1, bool), is_head[:-1]])
    prev_step = jnp.concatenate([jnp.zeros(1, jnp.int32), step[:-1]])
    ok_pair = same & (step >= 1) & (step <= _QMAX)
    consistent = ok_pair & (prev_head | (step == prev_step))
    bad = same & ~consistent
    badmark = jax.lax.cummax(jnp.where(bad, idx, -1), axis=0)
    ok_so_far = badmark < gstart

    is_end = jnp.concatenate([is_head[1:], jnp.ones(1, bool)]) & slot_valid
    multi = same | (
        jnp.concatenate([same[1:], jnp.zeros(1, bool)])
    )  # group size >= 2 (per slot)

    # The one cross-group comparison at each group-end slot: rot(p_end + q)
    # vs rot(p_end) to prefix15 depth, read from the precomputed bits.
    # Equal prefixes (the fully-cyclic wrap case: p_end + q mod n lands
    # back inside the group) mean identical rotations — a true tie that
    # must NOT be ordered.
    q = step  # at an end slot of an ok chain, the last pair's step == q
    end_cand = is_end & multi & ok_so_far
    qsh = 2 * jnp.maximum(q - 1, 0)
    gt_b = ((cmp_s >> qsh) & 1).astype(bool)
    eq_b = ((cmp_s >> (qsh + 1)) & 1).astype(bool)
    apply_g = end_cand & ~eq_b
    asc = gt_b

    # Broadcast (end slot, apply, asc) back over each group: nearest end
    # slot at >= own slot via a reversed cummin of packed (slot, flags).
    pack = jnp.where(
        is_end,
        (idx << 2) | (apply_g.astype(jnp.int32) << 1) | asc.astype(jnp.int32),
        jnp.int32(2**30),
    )
    rpack = jax.lax.cummin(pack, axis=0, reverse=True)
    end_slot = rpack >> 2
    apply_lane = ((rpack >> 1) & 1).astype(bool) & slot_valid & multi
    asc_lane = (rpack & 1).astype(bool)

    j = idx - gstart
    m = end_slot - gstart + 1
    chain_rank = jnp.where(asc_lane, r_s + j, r_s + (m - 1 - j))
    new_r_s = jnp.where(apply_lane, chain_rank, r_s)

    _, new_rank = _sort((p_s, new_r_s), num_keys=1)
    new_rank = jnp.where(valid, new_rank, _PAD_RANK)
    resolved_lanes = jnp.sum(apply_lane.astype(jnp.int32))
    resolved_groups = jnp.sum((apply_lane & is_end).astype(jnp.int32))
    return new_rank, resolved_lanes, resolved_groups, apply_lane
