"""RLE2 on device: zero-run bijective-base-2 coding as prefix sums.

Reference semantics: lib/mtf.rs:46-65,106-113 — maximal runs of MTF index 0
become RUNA/RUNB digit strings (LSB-first bits of run+1 below its leading
one); nonzero index i becomes symbol i+1; EOB terminates the block.

Device formulation: treat EOB as a sentinel "nonzero" appended at position
n.  For every nonzero, the preceding zero-run length falls out of an
exclusive cummax of nonzero positions; digit counts are exact integer
bit-lengths (comparison ladder, no float log); output offsets are one
exclusive cumsum.

The emit->output expansion is a *merge*: emit entries (keyed by their
output offset) and output slots (keyed by their index) are interleaved by
one 2-operand sort, the covering entry's fields are forward-filled with
cheap cummaxes (the offset-prefixed packing makes "latest entry" == "max"),
and a second 2-operand sort compacts the slot lanes back to a dense
stream: two ~2M-lane sorts + three cummaxes in place of a scatter +
full-width gather (a searchsorted/gather formulation is the alternative
to measure on the GPU).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_MAX_DIGITS = 20  # zero runs < 2^20 (block <= 900_000)
_BIG = np.int32(1 << 26)  # > any merge key (2*(M+1) < 2^22); np: no device put at import
_PAD2 = np.int32(1 << 30)  # > any packed slot key ((j_slot << 9) < 2^29)


def rle2_entries(
    mtf_idx: jax.Array, n: jax.Array, num_names: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """The RLE2 entry stream shared by both expansion back ends.

    One entry per emit lane (nonzero MTF index or the EOB sentinel at
    position ``n``), covering output slots [off, off + width): its first
    ``width - 1`` slots are the zero-run's bijective-base-2 digits of
    ``zp1`` and its last slot is the symbol ``val``.  Dead lanes carry
    width 0.  Returns (off, width, zp1, val, out_len), all int32[N+1]
    except the scalar out_len.
    """
    N = mtf_idx.shape[0]
    M = N + 1
    eob = num_names + 1
    pos = jnp.arange(M, dtype=jnp.int32)
    is_eob = pos == n
    ext = jnp.concatenate([mtf_idx, jnp.zeros(1, jnp.int32)])
    nz = (ext > 0) & (pos < n)
    emit = nz | is_eob

    # Previous emit position (exclusive cummax).
    marked = jnp.where(emit, pos, -1)
    prev = jnp.concatenate(
        [jnp.full(1, -1, jnp.int32), jax.lax.cummax(marked, axis=0)[:-1]]
    )
    zrun = jnp.where(emit, pos - prev - 1, 0)

    # Digit count = bitlength(zrun + 1) - 1, exact via comparison ladder.
    zp1 = zrun + 1
    nd = jnp.zeros(M, jnp.int32)
    for k in range(1, _MAX_DIGITS + 1):
        nd = nd + (zp1 >= (1 << k)).astype(jnp.int32)

    emit_i = emit.astype(jnp.int32)
    width = (nd + 1) * emit_i
    ends = jnp.cumsum(width)                            # inclusive
    off = ends - width                                  # exclusive
    val = jnp.where(is_eob, eob, ext + 1)
    return off, width, zp1, val, ends[-1]


def rle2_device(
    mtf_idx: jax.Array,
    n: jax.Array,
    num_names: jax.Array,
    with_freqs: bool = True,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Encode the MTF index stream.

    Args:
      mtf_idx: int32[N] (valid first ``n``).
      n: int32 true length.
      num_names: int32 number of present byte values.
      with_freqs: compute the [258] frequency histogram.  The fused device
        pipeline derives frequencies from the segment histogram instead
        (ops/huffman.segment_hist), so it passes False to skip the scatter.
    Returns:
      syms int32[N+1] (RLE2 symbols, padded with 258),
      out_len int32,
      freqs int32[258] (zeros when ``with_freqs`` is False).
    """
    N = mtf_idx.shape[0]
    M = N + 1
    pos = jnp.arange(M, dtype=jnp.int32)
    off, width, zp1, val, out_len = rle2_entries(mtf_idx, n, num_names)
    emit = width > 0

    # --- merge entries with output slots -----------------------------------
    # Entry lane (emit only): key 2*off (even, sorts before the slot it
    # starts covering); slot lane j: key 2*j + 1.  zp1 (21 bits) and the
    # symbol value (9 bits) ride as one packed payload operand.
    packed = zp1 | (val << 21)
    e_key = jnp.where(emit, off * 2, _BIG)
    keys = jnp.concatenate([e_key, pos * 2 + 1])
    pays = jnp.concatenate([packed, jnp.zeros(M, jnp.int32)])
    k_s, p_s = jax.lax.sort((keys, pays), num_keys=1, is_stable=False)

    # Forward-fill the covering entry's (off, zp1, val): prefixing each
    # 11-bit payload piece with the entry offset (strictly increasing over
    # emit entries) turns "latest entry so far" into a running max.
    is_entry = (k_s & 1) == 0
    off_e = jnp.where(is_entry, k_s >> 1, 0)
    fA = jnp.where(is_entry, (off_e << 11) | (p_s & 0x7FF), -1)
    fB = jnp.where(is_entry, (off_e << 11) | ((p_s >> 11) & 0x3FF), -1)
    fC = jnp.where(is_entry, (off_e << 11) | ((p_s >> 21) & 0x1FF), -1)
    FA = jax.lax.cummax(fA, axis=0)
    FB = jax.lax.cummax(fB, axis=0)
    FC = jax.lax.cummax(fC, axis=0)
    off_f = FA >> 11
    zp1_f = (FA & 0x7FF) | ((FB & 0x3FF) << 11)
    val_f = FC & 0x1FF

    j_slot = k_s >> 1
    d = jnp.clip(j_slot - off_f, 0, _MAX_DIGITS)
    digit = (zp1_f >> d) & 1
    # Symbol-slot detection in place: an entry spans nd digit slots then
    # its symbol, so slot d == nd (== bitlength(zp1)-1) is the symbol.
    # Resolving it BEFORE compaction lets the per-slot value (<= 9 bits:
    # val <= 257) ride inside the compaction key, making the second
    # 2M-lane sort single-operand.
    nd_f = jnp.zeros_like(zp1_f)
    for k in range(1, _MAX_DIGITS + 1):
        nd_f = nd_f + (zp1_f >= (1 << k)).astype(jnp.int32)
    slot_val = jnp.where(d == nd_f, val_f, digit)
    # Slot keys reach (M << 9) < 2^29, so entry/pad lanes need a larger
    # sentinel than the merge sort's _BIG; keys are unique (distinct
    # j_slot).
    s_key = jnp.where(is_entry, _PAD2, (j_slot << 9) | slot_val)
    (d_key,) = jax.lax.sort((s_key,), num_keys=1, is_stable=False)
    live = pos < out_len
    syms = jnp.where(live, d_key[:M] & 0x1FF, 258)

    if with_freqs:
        freqs = (
            jnp.zeros(259, jnp.int32)
            .at[syms]
            .add(live.astype(jnp.int32))[:258]
        )
    else:
        freqs = jnp.zeros(258, jnp.int32)
    return syms, out_len, freqs
