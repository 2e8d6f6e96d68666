import random

from banzai_jax.crc32 import block_crc, block_crc_slow, combine_stream_crc


def test_fast_matches_slow_oracle():
    rng = random.Random(0)
    for data in [b"", b"a", b"hello world", bytes(range(256)),
                 rng.randbytes(1), rng.randbytes(1000), rng.randbytes(4097)]:
        assert block_crc(data) == block_crc_slow(data)


def test_combine_is_rotl_xor():
    assert combine_stream_crc(0, 0xDEADBEEF) == 0xDEADBEEF
    assert combine_stream_crc(0x80000000, 0) == 1
    assert combine_stream_crc(0x40000000, 5) == 0x80000005
