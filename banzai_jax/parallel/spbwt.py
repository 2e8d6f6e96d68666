"""Within-block sharded BWT: one block's rotation sort across a device mesh.

SURVEY.md §5's "long-context" stretch axis: the reference's sequential
suffix sort (lib/bwt.rs:526-756) has no scaling story beyond one core; the
block-DP layer (parallel/dp.py) scales across *blocks* but a single block's
sort still lives on one chip.  This module shards ONE block's rotation
sort lane-wise over a 1-D ``('lanes',)`` mesh with per-device memory
O(N/D) — the input block itself enters sharded, and no collective ever
materializes an O(N) array on one device:

  * each device owns a contiguous shard of positions; round-0 prefix keys
    and the chain-pass comparisons read at most _SP_HALO bytes past the
    shard (a neighbour halo + the global head for the cyclic wrap — two
    tiny static exchanges);
  * ranks live in POSITION space, sharded like the input.  The doubling
    round's shifted-rank lookup ``rank[(p + k) mod n]`` is a *uniform
    shift*, not a gather: a barrel roll — ceil(log2 D) static ppermute
    stages select shard-granular shifts by the bits of ``k // m``, one
    more ppermute supplies the neighbour tail for the intra-shard offset
    ``k % m`` — plus a second roll patching the mod-n wrap tail.  Traffic:
    ~2 * (log2 D + 1) shards per round, vs the O(N)-per-device all_gather
    this replaces;
  * the global sort is an **odd-even merge-split of shards**: D rounds of
    pairwise shard exchange (ppermute) + local merge sorts (by the 0-1
    principle, D merge-split rounds over D locally-sorted shards sort the
    whole array);
  * rank relabeling crosses shard boundaries with 1-hop ppermutes and a
    D-scalar all_gather carry (group heads are a prefix max, which
    composes associatively across shards);
  * sorted-space ranks return to position space by a second merge-split
    (sort by position) — after it, device d holds exactly the ranks of
    its own contiguous positions, because positions are dealt evenly;
  * round 0 sorts a 7-byte packed prefix and is followed by a sharded
    tandem-repeat CHAIN pass (_resolve_chains_sharded — the single-chip
    analytic trick of ops/bwt.py, with every scan crossing shards via
    edge ppermutes and D-scalar carries): period-<=6 tie groups — runs
    after RLE1 are period-5 — resolve in closed form instead of paying
    plain-doubling round counts (asserted at 256K lanes in
    tests/test_spbwt.py::test_chain_resolution_round_count_periodic);
  * termination is a global psum of unresolved lanes; a round that
    resolves nothing and splits no group is a fixpoint (identical
    rotations — periodic input), so the loop exits early instead of
    doubling k all the way to n.

Honest perf model: bzip2 blocks are <= 900 KB (level 9), which fits one
chip's HBM ~100x over, and the single-chip path additionally has packed
15-byte round-1 keys, octupling rounds and the compact tier cascade that
this sharded formulation does not replicate — so for *this* format the
block-DP axis is strictly better and this path is the long-context
capability: per-device memory is O(N/D)
by construction (validated by the compiled memory analysis in
tests/test_spbwt.py at 1M lanes), so inputs that exceed one chip's
memory shard across the mesh with all traffic on the device interconnect.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

_PAD = np.uint32(0xFFFFFFFF)  # padded-lane key; np scalar: no device put at import
_PADI = np.int32(2**30)       # padded-lane int32 rank-key sentinel


def lane_mesh(devices=None) -> Mesh:
    if devices is None:
        devices = jax.local_devices()
    return Mesh(np.asarray(devices), ("lanes",))


def _merge_split_sort(ops, axis: str, D: int, num_keys: int):
    """Globally sort equal-shape shard tuples ``ops`` over mesh axis ``axis``.

    Odd-even transposition over shards: every round, paired devices
    exchange shards (ppermute), both sort the 2m concatenation, the lower
    device keeps the lower half, the upper the upper half.  After D rounds
    the concatenation of shards in device order is globally sorted.  Shards
    must enter locally sorted (round 0's local sort is the caller's).
    """
    m = ops[0].shape[0]
    me = jax.lax.axis_index(axis)

    for r in range(D):
        if r % 2 == 0:
            partner_of = [d ^ 1 for d in range(D)]
        else:
            partner_of = [d - 1 if d % 2 == 0 else d + 1 for d in range(D)]
        perm = [(d, p) for d, p in enumerate(partner_of) if 0 <= p < D]
        if not perm:
            continue
        recv = [jax.lax.ppermute(op, axis, perm) for op in ops]
        partner = jnp.asarray(partner_of, jnp.int32)[me]
        paired = (partner >= 0) & (partner < D)
        keep_low = paired & (me < partner)
        keep_high = paired & (me > partner)
        # Both partners MUST sort the identical 2m sequence (lower shard
        # first): with tied keys an unstable sort may order payloads
        # differently for different concatenation orders, and the two
        # kept halves would no longer partition the pair's lanes.
        merged = jax.lax.sort(
            tuple(
                jnp.concatenate(
                    [
                        jnp.where(keep_low, a, b),
                        jnp.where(keep_low, b, a),
                    ]
                )
                for a, b in zip(ops, recv)
            ),
            num_keys=num_keys,
            is_stable=False,
        )
        ops = tuple(
            jnp.where(
                keep_low,
                jax.lax.slice_in_dim(mg, 0, m),
                jnp.where(
                    keep_high, jax.lax.slice_in_dim(mg, m, 2 * m), op
                ),
            )
            for op, mg in zip(ops, merged)
        )
    return ops


def _carry_max(local_last: jax.Array, axis: str, D: int) -> jax.Array:
    """Exclusive prefix-max over devices of a per-device int32 scalar."""
    allv = jax.lax.all_gather(local_last, axis)  # [D]
    me = jax.lax.axis_index(axis)
    mask = jnp.arange(D) < me
    return jnp.max(jnp.where(mask, allv, jnp.int32(-1)))


def _carry_min_rev(local_min: jax.Array, axis: str, D: int, big) -> jax.Array:
    """Exclusive suffix-min over devices (the mirror of _carry_max)."""
    allv = jax.lax.all_gather(local_min, axis)
    me = jax.lax.axis_index(axis)
    mask = jnp.arange(D) > me
    return jnp.min(jnp.where(mask, allv, big))


_SP_QMAX = 6              # chain periods resolved analytically (< k = 7)
_SP_HALO = 13             # shard halo bytes: prefix7 at offset _SP_QMAX


def _resolve_chains_sharded(
    r_s, p_s, cmp_s, n, idx, me, D, right_perm, left_perm
):
    """Sharded mirror of ops.bwt._resolve_chains (see its docstring for
    the tandem-repeat argument): resolve arithmetic tie chains with step
    q <= _SP_QMAX after round 0's k=7 sort, in sorted space.

    All scans cross shard boundaries with 1-element ppermute edges plus
    D-scalar all_gather carries (prefix-max left-to-right, suffix-min
    right-to-left) — per-device memory stays O(m).  Returns the corrected
    rank_sorted and the globally-resolved (lanes, groups) counts.
    """
    m = r_s.shape[0]
    slot_valid = idx < n

    def prev_of(x, fill):
        e = _edge(x[-1:], "lanes", right_perm, me > 0, fill)
        return jnp.concatenate([e[None], x[:-1]])

    def next_of(x, fill):
        e = _edge(x[:1], "lanes", left_perm, me < D - 1, fill)
        return jnp.concatenate([x[1:], e[None]])

    def scan_max(marked):
        local = jax.lax.cummax(marked, axis=0)
        carry = _carry_max(local[-1], "lanes", D)
        return jnp.maximum(local, carry)

    same = (r_s == prev_of(r_s, -1)) & slot_valid
    is_head = ~same
    gstart = scan_max(jnp.where(is_head, idx, -1))
    step = p_s - prev_of(p_s, 0)
    prev_head = prev_of(is_head.astype(jnp.int32), 1) > 0
    prev_step = prev_of(step, 0)
    ok_pair = same & (step >= 1) & (step <= _SP_QMAX)
    consistent = ok_pair & (prev_head | (step == prev_step))
    bad = same & ~consistent
    badmark = scan_max(jnp.where(bad, idx, -1))
    ok_so_far = badmark < gstart

    is_end = next_of(is_head.astype(jnp.int32), 1) > 0
    is_end = is_end & slot_valid
    multi = same | (next_of(same.astype(jnp.int32), 0) > 0)

    # One cross-group comparison per group end, read from the carried
    # prefix7 relation bits; equal prefixes (fully-cyclic wrap) are true
    # ties and must NOT be ordered.
    q = step
    end_cand = is_end & multi & ok_so_far
    qsh = 2 * jnp.maximum(q - 1, 0)
    gt_b = ((cmp_s >> qsh) & 1).astype(bool)
    eq_b = ((cmp_s >> (qsh + 1)) & 1).astype(bool)
    apply_g = end_cand & ~eq_b
    asc = gt_b

    # Broadcast (end slot, apply, asc) back over each group: nearest end
    # slot at >= own slot, via a distributed reversed cummin.
    pack = jnp.where(
        is_end,
        (idx << 2) | (apply_g.astype(jnp.int32) << 1) | asc.astype(jnp.int32),
        jnp.int32(2**30),
    )
    local = jax.lax.cummin(pack, axis=0, reverse=True)
    carry = _carry_min_rev(local[0], "lanes", D, jnp.int32(2**30))
    rpack = jnp.minimum(local, carry)
    end_slot = rpack >> 2
    apply_lane = ((rpack >> 1) & 1).astype(bool) & slot_valid & multi
    asc_lane = (rpack & 1).astype(bool)

    j = idx - gstart
    gsize = end_slot - gstart + 1
    chain_rank = jnp.where(asc_lane, r_s + j, r_s + (gsize - 1 - j))
    new_r_s = jnp.where(apply_lane, chain_rank, r_s)
    resolved_lanes = jax.lax.psum(
        jnp.sum(apply_lane.astype(jnp.int32)), "lanes"
    )
    resolved_groups = jax.lax.psum(
        jnp.sum((apply_lane & is_end).astype(jnp.int32)), "lanes"
    )
    return new_r_s, resolved_lanes, resolved_groups


def _edge(x_slice: jax.Array, axis: str, perm, active, fill) -> jax.Array:
    """A 1-element shard-boundary exchange; ``fill`` where not receiving."""
    got = jax.lax.ppermute(x_slice, axis, perm)
    return jnp.where(active, got[0], jnp.asarray(fill, x_slice.dtype))


@partial(jax.jit, static_argnames=("mesh", "debug_rounds"))
def bwt_rotations_sharded(
    block: jax.Array, n: jax.Array, *, mesh: Mesh,
    debug_rounds: bool = False,
) -> tuple[jax.Array, ...]:
    """Wrap-around BWT of ``block[:n]`` with the sort sharded over ``mesh``.

    Same contract as ops.bwt.bwt_rotations: uint8[N] padded block (N must
    be a multiple of the mesh size), int32 true length (1 <= n <= N);
    returns (bwt uint8[N] — first n entries valid, ptr int32), byte-
    identical to the single-chip path.  ``block`` may be passed as a
    replicated host array; jit shards it to P('lanes') on entry, and
    inside the mesh every device touches only O(N/D) lanes.
    """
    N = block.shape[0]
    D = mesh.devices.size
    assert N % D == 0, "padded block length must divide the lane mesh"
    m = N // D
    LOGD = max(1, (D - 1).bit_length())
    right_perm = [(d, d + 1) for d in range(D - 1)]  # d's tail -> d+1
    left_perm = [(d + 1, d) for d in range(D - 1)]   # d+1's head -> d

    def shard_fn(bsh, n):
        n = n[0]
        me = jax.lax.axis_index("lanes")
        il = jnp.arange(m, dtype=jnp.int32)
        idx = me * m + il          # global position ids of this shard;
        valid = idx < n            # doubles as global SLOT ids in sorted
        # space (same value, different meaning).
        b32 = bsh.astype(jnp.uint32)

        # ---- Collective building blocks ------------------------------------
        def dev_roll(x, q):
            """Shards rolled left by ``q`` devices: out_d = in_{(d+q)%D}.
            q is traced; each bit selects a static ppermute stage."""
            cur = x
            for bit in range(LOGD):
                sh = 1 << bit
                perm = [((d + sh) % D, d) for d in range(D)]
                cand = jax.lax.ppermute(cur, "lanes", perm)
                cur = jnp.where((q >> bit) & 1 > 0, cand, cur)
            return cur

        def barrel_roll(x, s):
            """Global cyclic left-roll: out[p] = x[(p + s) mod N], s traced
            in [0, N).  ceil(log2 D) + 1 static ppermutes of one shard."""
            q = s // m
            t = s % m
            y = dev_roll(x, q)
            nxt = jax.lax.ppermute(
                y, "lanes", [((d + 1) % D, d) for d in range(D)]
            )
            return jax.lax.dynamic_slice(
                jnp.concatenate([y, nxt]), (t,), (m,)
            )

        def shifted_rank(rank_pos, k):
            """rank[(p + k) mod n] per local position p (garbage on pads).
            Two barrel rolls: the main shift by k, plus a head roll that
            patches the mod-n wrap tail (positions p >= n - k)."""
            v1 = barrel_roll(rank_pos, k)
            v2 = barrel_roll(rank_pos, k - n + N)
            return jnp.where(idx >= n - k, v2, v1)

        def to_position_space(sidx, rank_sorted):
            """Sorted-space ranks -> position space: distributed sort by
            position.  Positions are dealt evenly, so device d ends up
            holding exactly ranks for positions [d*m, (d+1)*m)."""
            si, rp = jax.lax.sort(
                (sidx, rank_sorted), num_keys=1, is_stable=False
            )
            _si, rp = _merge_split_sort((si, rp), "lanes", D, num_keys=1)
            return rp

        def relabel(k1, k2):
            """Positional ranks for sorted shards (rank = global slot of
            the group head), the global unresolved-lane count, and the
            global multi-group count (groups of size >= 2)."""
            pk1 = jnp.concatenate(
                [_edge(k1[-1:], "lanes", right_perm, me > 0, _PAD)[None],
                 k1[:-1]]
            )
            pk2 = jnp.concatenate(
                [_edge(k2[-1:], "lanes", right_perm, me > 0, 0)[None],
                 k2[:-1]]
            )
            is_head = (k1 != pk1) | (k2 != pk2) | (idx == 0)
            local_head = jax.lax.cummax(
                jnp.where(is_head, idx, -1), axis=0
            )
            carry = _carry_max(local_head[-1], "lanes", D)
            rank_sorted = jnp.maximum(local_head, carry)
            nk1 = jnp.concatenate(
                [k1[1:],
                 _edge(k1[:1], "lanes", left_perm, me < D - 1, _PAD)[None]]
            )
            nk2 = jnp.concatenate(
                [k2[1:],
                 _edge(k2[:1], "lanes", left_perm, me < D - 1, 0)[None]]
            )
            lane_valid = k1 != _PAD
            tied = lane_valid & (
                ((k1 == pk1) & (k2 == pk2)) | ((k1 == nk1) & (k2 == nk2))
            )
            unres = jax.lax.psum(jnp.sum(tied.astype(jnp.int32)), "lanes")
            groups = jax.lax.psum(
                jnp.sum((is_head & tied).astype(jnp.int32)), "lanes"
            )
            return rank_sorted, unres, groups

        # ---- Round 0 --------------------------------------------------------
        # With shards big enough to cover the halo (always, outside tiny
        # unit-test meshes): a 7-byte prefix — k1 = bytes 0..2 (3 bytes,
        # so a valid key never collides with the _PAD sentinel), k2 =
        # bytes 3..6 — so k = 7 > _SP_QMAX and the tandem-chain pass can
        # resolve every period-<=6 tie group analytically (runs after
        # RLE1 are period-5 "aaaaC" repeats; see ops/bwt.py's single-chip
        # pass).  Keys + chain comparisons read at most _SP_HALO bytes
        # past the shard: the right neighbour's head plus the global head
        # for the lanes whose prefix wraps past n.
        chains = m >= _SP_HALO
        halo = _SP_HALO if chains else 2
        tailh = jax.lax.ppermute(b32[:halo], "lanes", left_perm)
        tailh = jnp.where(me < D - 1, tailh, 0)
        headh = jax.lax.all_gather(b32[:halo], "lanes")[0]
        ext = jnp.concatenate([b32, tailh, headh])      # [m + 2*halo]

        def bref(off: int):
            wrap = valid & (idx + off >= n)             # off < halo
            j = jnp.where(wrap, m + halo + (idx + off - n), il + off)
            return ext[j]

        if chains:
            def prefix7(off: int):
                ka = (
                    (bref(off) << 16) | (bref(off + 1) << 8)
                    | bref(off + 2)
                )
                kb = (
                    (bref(off + 3) << 24) | (bref(off + 4) << 16)
                    | (bref(off + 5) << 8) | bref(off + 6)
                )
                return ka, kb

            k1p, k2p = prefix7(0)
            key1 = jnp.where(valid, k1p, _PAD)
            key2 = jnp.where(valid, k2p, 0)

            # Chain-resolution precompute (position space, zero gathers):
            # the lex relation of prefix7(p+q) vs prefix7(p) per period
            # q, packed as (gt, eq) bit pairs — carried through the sort
            # with the position (ops/bwt.py's identical trick at k=15).
            cmpbits = jnp.zeros(m, jnp.int32)
            for qq in range(1, _SP_QMAX + 1):
                a1, a2 = prefix7(qq)
                gt = (a1 > k1p) | ((a1 == k1p) & (a2 > k2p))
                eq = (a1 == k1p) & (a2 == k2p)
                cmpbits = cmpbits | (
                    gt.astype(jnp.int32) << (2 * (qq - 1))
                ) | (eq.astype(jnp.int32) << (2 * (qq - 1) + 1))

            if N <= (1 << 20):
                # Position and cmp bits share one uint32 key: positions
                # are unique, so ties never reach the cmp bits, and
                # within-group ascending-position order (which the chain
                # pass needs) is free.
                sidx_c = (idx.astype(jnp.uint32) << 12) | cmpbits.astype(
                    jnp.uint32
                )
                ops = jax.lax.sort(
                    (key1, key2, sidx_c), num_keys=3, is_stable=False
                )
                ops = _merge_split_sort(ops, "lanes", D, num_keys=3)
                k1, k2, oc = ops
                sidx = (oc >> 12).astype(jnp.int32)
                cmp_s = (oc & 0xFFF).astype(jnp.int32)
            else:
                # Long-context layout: position as the tie key, cmp bits
                # as a fourth operand.
                ops = jax.lax.sort(
                    (key1, key2, idx.astype(jnp.uint32), cmpbits),
                    num_keys=3, is_stable=False,
                )
                ops = _merge_split_sort(ops, "lanes", D, num_keys=3)
                k1, k2, su, cmp_s = ops
                sidx = su.astype(jnp.int32)
            rank_sorted, unres, groups = relabel(k1, k2)
            rank_sorted, dl, dg = _resolve_chains_sharded(
                rank_sorted, sidx, cmp_s, n, idx, me, D,
                right_perm, left_perm,
            )
            unres = unres - dl
            groups = groups - dg
            k0 = 7
        else:
            # Tiny-shard fallback (unit-test meshes): 3-byte prefix, no
            # chain pass.
            key0 = jnp.where(
                valid, (bref(0) << 16) | (bref(1) << 8) | bref(2), _PAD
            )
            zero_k = jnp.zeros_like(key0)
            k1, k2, sidx = jax.lax.sort(
                (key0, zero_k, idx), num_keys=2, is_stable=False
            )
            k1, k2, sidx = _merge_split_sort(
                (k1, k2, sidx), "lanes", D, num_keys=2
            )
            rank_sorted, unres, groups = relabel(k1, k2)
            k0 = 3
        rank_pos = to_position_space(sidx, rank_sorted)

        # ---- Doubling rounds ------------------------------------------------
        def body(state):
            k, rank_pos, unres, groups, _cont = state
            r0 = jnp.where(valid, rank_pos.astype(jnp.uint32), _PAD)
            r1 = jnp.where(
                valid, shifted_rank(rank_pos, k).astype(jnp.uint32), 0
            )
            s1, s2, sidx2 = jax.lax.sort(
                (r0, r1, idx), num_keys=2, is_stable=False
            )
            s1, s2, sidx2 = _merge_split_sort(
                (s1, s2, sidx2), "lanes", D, num_keys=2
            )
            rank_sorted, unres2, groups2 = relabel(s1, s2)
            rank_pos2 = to_position_space(sidx2, rank_sorted)
            k2x = k * 2
            # Stalled <=> no lane resolved AND no tie group split (a round
            # can split a group into smaller multi-groups without changing
            # the lane count — progress via the count alone misses; see the
            # single-chip guard in ops/bwt.py full_round).  Then remaining
            # ties are identical rotations (periodic input): done.
            stalled = (unres2 == unres) & (groups2 == groups)
            done = (unres2 == 0) | stalled | (k2x >= n)
            return (
                k2x, rank_pos2, unres2, groups2,
                jnp.where(done, 0, 1).astype(jnp.int32),
            )

        cont0 = jnp.where((unres == 0) | (k0 >= n), 0, 1).astype(jnp.int32)
        state = (jnp.int32(k0), rank_pos, unres, groups, cont0)
        state = jax.lax.while_loop(lambda s: s[4] > 0, body, state)
        rank_pos = state[1]

        # ---- Extraction ------------------------------------------------------
        # In position space the preceding byte is a 1-byte left halo (plus
        # b[n-1] for rotation 0, fetched with a psum since its home device
        # is data-dependent).  Sorted slots come from one more distributed
        # 1-operand sort by rank: tied (identical) rotations share a rank
        # and land in arbitrary order across their slots, which is
        # harmless — they carry identical preceding bytes.
        left1 = _edge(b32[-1:], "lanes", right_perm, me > 0, 0)
        prevb = jnp.concatenate([left1[None], b32[:-1]])
        bn1 = jax.lax.psum(
            jnp.sum(jnp.where(idx == n - 1, b32, 0)), "lanes"
        )
        prevb = jnp.where(idx == 0, bn1, prevb)
        if N < (1 << 22):
            # Packed single-operand fast path: (rank << 8) | prev_byte.
            # Valid only while keys stay below the _PADI = 2^30 sentinel,
            # i.e. rank < 2^22 — guaranteed by n <= N (static).  Beyond
            # that the packed key would first collide with the sentinel
            # (n >= 2^22) and then overflow int32 (n >= 2^23).
            rb = jnp.where(
                valid, (rank_pos << 8) | prevb.astype(jnp.int32), _PADI
            )
            (rb,) = jax.lax.sort((rb,), num_keys=1, is_stable=False)
            (rb,) = _merge_split_sort((rb,), "lanes", D, num_keys=1)
            bwt_shard = (rb & 0xFF).astype(jnp.uint8)
        else:
            # Long-context path: rank and byte as two sort operands, so
            # ranks up to the full int32 range stay exact.
            rk = jnp.where(valid, rank_pos, _PADI)
            pb = prevb.astype(jnp.int32)
            rk, pb = jax.lax.sort((rk, pb), num_keys=1, is_stable=False)
            rk, pb = _merge_split_sort((rk, pb), "lanes", D, num_keys=1)
            bwt_shard = pb.astype(jnp.uint8)
        ptr = jax.lax.psum(
            jnp.sum(jnp.where(idx == 0, rank_pos, 0)), "lanes"
        )
        return bwt_shard, ptr[None], state[0][None]

    sharded = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("lanes"), P()),
        out_specs=(P("lanes"), P("lanes"), P("lanes")),
        check_vma=False,
    )
    bwt, ptrs, kf = sharded(block, jnp.broadcast_to(n, (D,)))
    if debug_rounds:
        # Diagnostic: the rank coverage k when the doubling loop exited
        # (k0 == no doubling round ran) — the round-count evidence for
        # the chain pass (tests/test_spbwt.py).
        return bwt, ptrs[0], kf[0]
    return bwt, ptrs[0]
