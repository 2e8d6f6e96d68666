"""Chunk-parallel MTF on device.

The reference's per-byte 256-entry recency shuffle (lib/mtf.rs:69-104) has a
sequential dependency of depth n.  Device formulation (shared with the NumPy
twin in mtf_rle2.py): the recency list at a chunk boundary is a *closed-form*
function of per-symbol last-occurrence positions, so chunk-initial states are
computed with a scatter-max + exclusive cummax + batched sort, and the
sequential shuffle runs only *within* chunks — vectorized across all C
chunks, i.e. a fori_loop of depth K over a [C, 256] state matrix.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_S = 256  # full renamed-alphabet width; absent names sit inert at the tail


@partial(jax.jit, static_argnames=("chunk",))
def mtf_indices_device(
    bwt: jax.Array,
    n: jax.Array,
    present: jax.Array,
    chunk: int = 512,
) -> jax.Array:
    """MTF list positions of the dense-renamed BWT column.

    Args:
      bwt: uint8[N] padded BWT column (N static, divisible by ``chunk``).
      n: int32 true length.
      present: bool[256] byte-presence map.
    Returns:
      int32[N] MTF indices; entries past ``n`` are garbage.
    """
    N = bwt.shape[0]
    assert N % chunk == 0, "pad N to a multiple of the chunk size"
    C = N // chunk
    pos = jnp.arange(N, dtype=jnp.int32)
    valid = pos < n
    # Work directly in byte space: the dense renaming is only an order
    # isomorphism, so seeding the recency lists with "present bytes in
    # ascending order, absent bytes at the tail" yields the exact same MTF
    # indices without a 1M-lane renaming gather.
    syms = jnp.where(valid, bwt.astype(jnp.int32), -1)

    # Last occurrence of each symbol inside each chunk (global position),
    # as a one-hot compare + max-reduce over [C, chunk, S]: XLA fuses the
    # compare into the reduction, so no scatter is needed.
    sym_t = syms.reshape(C, chunk)
    pos_c = pos.reshape(C, chunk)
    sym_col = jnp.arange(_S, dtype=jnp.int32)[None, None, :]
    occ = jnp.max(
        jnp.where(sym_t[:, :, None] == sym_col, pos_c[:, :, None], -1),
        axis=1,
    )
    # Exclusive cummax across chunks -> last occurrence before chunk start.
    before = jnp.concatenate(
        [
            jnp.full((1, _S), -1, jnp.int32),
            jax.lax.cummax(occ, axis=0)[:-1],
        ],
        axis=0,
    )

    # Chunk-initial recency lists: symbols by last-occurrence descending,
    # then never-seen present bytes ascending, absent bytes at the tail.
    # The three sort fields pack into ONE key — (N - before) needs 21
    # bits (before in [-1, N), N < 2^20), absent 1, symbol id 8 — so the
    # [C, 256] sort runs with a single operand, and state0 is the low
    # byte of the sorted keys.
    sym_ids = jnp.arange(_S, dtype=jnp.int32)[None, :]
    absent = (~present).astype(jnp.int32)[None, :]
    key = (
        ((N - before) << 9) | (absent << 8) | sym_ids
    )
    (key_s,) = jax.lax.sort((key,), num_keys=1)
    state0 = key_s & 0xFF

    syms_p = syms.reshape(C, chunk)
    col = jnp.arange(_S, dtype=jnp.int32)[None, :]

    def step(t, carry):
        state, out = carry
        s = jax.lax.dynamic_slice_in_dim(syms_p, t, 1, axis=1)   # [C, 1]
        hit = state == s
        idx = jnp.argmax(hit, axis=1).astype(jnp.int32)          # [C]
        shifted = jnp.concatenate([s, state[:, :-1]], axis=1)
        keep = (col > idx[:, None]) | (s < 0)
        state = jnp.where(keep, state, shifted)
        out = jax.lax.dynamic_update_slice_in_dim(
            out, idx[:, None], t, axis=1
        )
        return state, out

    _, out = jax.lax.fori_loop(
        0, chunk, step, (state0, jnp.zeros((C, chunk), jnp.int32))
    )
    return out.reshape(-1)
