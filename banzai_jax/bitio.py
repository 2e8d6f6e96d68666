"""MSB-first bit stream assembly for the .bz2 container.

The reference writes its stream through a byte-at-a-time bit splicer
(lib/out.rs).  Here the design is different, device-first: the device emits each
block's payload as a dense ``uint32`` word array plus an exact bit length
(see ops/bitpack.py); the host only writes the short headers bit-by-bit and
splices whole payloads with a vectorized byte-shift — O(bytes) numpy work,
never a Python loop over the payload.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """Accumulates an MSB-first bit stream into a bytearray."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._partial = 0          # current partial byte, left-aligned bits
        self._nbits = 0            # bits used in _partial (0..7)
        self._total_bits = 0
        self._drained = 0          # whole bytes already handed out by drain()

    @property
    def bit_length(self) -> int:
        return self._total_bits

    def write_bits(self, value: int, n: int) -> None:
        """Write the low ``n`` bits of ``value``, most significant first."""
        if n == 0:
            return
        value &= (1 << n) - 1
        self._total_bits += n
        acc = (self._partial << n) | value
        nbits = self._nbits + n
        while nbits >= 8:
            nbits -= 8
            self._buf.append((acc >> nbits) & 0xFF)
        self._partial = acc & ((1 << nbits) - 1)
        self._nbits = nbits

    def write_bytes(self, data: bytes) -> None:
        if self._nbits == 0:
            self._buf.extend(data)
            self._total_bits += 8 * len(data)
        else:
            for b in data:
                self.write_bits(b, 8)

    def splice_words(self, words: np.ndarray, nbits: int) -> None:
        """Append ``nbits`` taken MSB-first from big-endian ``uint32`` words.

        Bits past ``nbits`` in the final word are ignored.  This is the host
        half of the bit-packing contract with the device kernel.
        """
        nbits = int(nbits)
        if nbits <= 0:
            return
        nwords = (nbits + 31) // 32
        nbytes = (nbits + 7) // 8
        if len(words) < nwords:
            # Silent truncation here would emit a structurally plausible
            # but undecodable stream; fail loudly instead.
            raise ValueError(
                f"splice_words: {len(words)} words < {nwords} needed "
                f"for {nbits} bits"
            )
        arr = np.frombuffer(
            np.ascontiguousarray(words[:nwords], dtype=np.uint32)
            .astype(">u4")
            .tobytes(),
            dtype=np.uint8,
        )[:nbytes].copy()
        # Zero stray bits beyond nbits in the final byte.
        tail = nbits & 7
        if tail:
            arr[-1] &= (0xFF << (8 - tail)) & 0xFF

        r = self._nbits
        if r == 0:
            self._buf.extend(arr.tobytes())
        else:
            hi = arr >> r
            lo = ((arr.astype(np.uint16) << (8 - r)) & 0xFF).astype(np.uint8)
            out = np.empty(len(arr) + 1, dtype=np.uint8)
            out[0] = (self._partial << (8 - r)) | hi[0]
            out[1:] = lo
            out[1:-1] |= hi[1:]
            self._buf.extend(out.tobytes())
            # Rewind: keep only ceil((old_bits + nbits)/8) bytes.
            total = self._total_bits + nbits
            keep = (total + 7) // 8 - self._drained
            del self._buf[keep:]

        self._total_bits += nbits
        new_nbits = self._total_bits & 7
        if new_nbits:
            last = self._buf.pop()
            self._partial = last >> (8 - new_nbits)
        else:
            self._partial = 0
        self._nbits = new_nbits

    def close(self) -> bytes:
        """Flush, zero-padding the final partial byte (lib/out.rs:22-28)."""
        if self._nbits:
            self._buf.append((self._partial << (8 - self._nbits)) & 0xFF)
            self._partial = 0
            self._nbits = 0
        return bytes(self._buf)

    def drain(self, final: bool = False) -> bytes:
        """Hand out the completed bytes so far and drop them from the
        buffer (streaming output).  With ``final`` the partial byte is
        zero-padded and included."""
        if final:
            out = self.close()
        else:
            out = bytes(self._buf)
            self._buf.clear()
        self._drained += len(out)
        if final:
            self._buf.clear()
        return out


def pack_bits_numpy(values: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, int]:
    """Host oracle for the device bit-pack kernel: concatenate ``lengths[i]``
    MSB-first bits of ``values[i]`` into uint32 words.  Returns (words, nbits).

    Each code occupies the disjoint bit range ``[start_i, start_i + len_i)``
    where ``start`` is the exclusive prefix sum of lengths.  A code spans at
    most two 32-bit words (lengths <= 32), so we left-align it inside the
    64-bit window anchored at its word and scatter-OR the two halves.
    """
    values = np.asarray(values, dtype=np.uint64)
    lengths = np.asarray(lengths, dtype=np.uint64)
    nbits = int(lengths.sum())
    if nbits == 0:
        return np.zeros(0, dtype=np.uint32), 0
    starts = np.cumsum(lengths) - lengths
    nwords = (nbits + 31) // 32
    acc = np.zeros(nwords + 1, dtype=np.uint64)   # each entry holds < 2**32
    widx = (starts >> np.uint64(5)).astype(np.int64)
    bit = starts & np.uint64(31)
    # Mask stray high bits and keep the shift < 64 (zero-length entries).
    values = values & ((np.uint64(1) << lengths) - np.uint64(1))
    shift = np.minimum(np.uint64(64) - bit - lengths, np.uint64(63))
    shifted = values << shift
    np.bitwise_or.at(acc, widx, shifted >> np.uint64(32))
    np.bitwise_or.at(acc, widx + 1, shifted & np.uint64(0xFFFFFFFF))
    return acc[:nwords].astype(np.uint32), nbits
