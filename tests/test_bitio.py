import numpy as np

from banzai_jax.bitio import BitWriter, pack_bits_numpy


def test_bitwriter_known_vector():
    bw = BitWriter()
    for v, n in [(0b101, 3), (0xFF, 8), (0, 2), (1, 1)]:
        bw.write_bits(v, n)
    bits = "101" + "1" * 8 + "00" + "1"
    bits += "0" * (-len(bits) % 8)
    expect = bytes(int(bits[i : i + 8], 2) for i in range(0, len(bits), 8))
    assert bw.close() == expect


def test_pack_and_splice_match_serial_writer():
    rng = np.random.default_rng(0)
    for lead_bits in range(0, 8):
        m = int(rng.integers(1, 300))
        lens = rng.integers(1, 25, size=m)
        vals = np.array([rng.integers(0, 1 << l) for l in lens], np.uint64)
        serial = BitWriter()
        serial.write_bits((1 << lead_bits) - 1, lead_bits)
        for v, l in zip(vals, lens):
            serial.write_bits(int(v), int(l))
        words, nbits = pack_bits_numpy(vals, lens)
        spliced = BitWriter()
        spliced.write_bits((1 << lead_bits) - 1, lead_bits)
        spliced.splice_words(words, nbits)
        assert spliced.close() == serial.close()


def test_pack_zero_length_entries():
    words, nbits = pack_bits_numpy(
        np.array([5, 0, 3], np.uint64), np.array([3, 0, 2], np.uint64)
    )
    assert nbits == 5
    bw = BitWriter()
    bw.splice_words(words, nbits)
    assert bw.close() == bytes([0b10111000])
