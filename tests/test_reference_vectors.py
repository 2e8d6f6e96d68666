"""Golden vectors harvested from the reference's inline tests (SURVEY §4).

Data only — the implementations under test are ours.  Includes the MTF
vectors that never ran in the reference (the #[cfg(tests)] typo,
lib/mtf.rs:123) — they pass here.
"""

import numpy as np

from banzai_jax.bitio import BitWriter
from banzai_jax.mtf_rle2 import mtf_indices, rle2_encode
from banzai_jax.oracle.stages import naive_bwt, numpy_bwt


def test_bwt_smoke_vector():
    # lib/bwt.rs:758-772
    text = (
        b"He served fire and smoke; these denizens of the fields served "
        b"vegetation, weather, frost, and sun."
    )
    expect = (
        b"e,eed,sesddf;d,trnne.  etenne lrshHkwvvvidzhsshgo   "
        b"etttftfnoesouaaee mireifeende   o se a asrr  i"
    )
    bwt, ptr = numpy_bwt(text)
    assert bytes(bwt) == expect
    assert ptr == 20
    bwt2, ptr2 = naive_bwt(text)
    assert bwt2 == expect and ptr2 == 20


def test_bitstring_vector():
    # lib/out.rs:107-133
    bw = BitWriter()
    bw.write_bits(6, 3)
    bw.write_bits(200, 8)
    bw.write_bits(0, 1)
    bw.write_bytes(bytes([0xCA, 0xFE, 0xBA, 0xBE]))
    bw.write_bits(1, 7)
    assert bw.close() == bytes([0xD9, 0x0C, 0xAF, 0xEB, 0xAB, 0xE0, 0x20])


def test_mtf_rle2_joe_tsai_vector():
    # lib/mtf.rs:123-158 (dormant in the reference; live here)
    data = np.array(
        [153, 45, 45, 38, 135, 179, 26, 154, 165, 170, 170, 170, 170, 18,
         109, 240, 174, 150, 87, 164, 30, 30, 30, 30, 30, 30, 30, 148, 190,
         10, 60, 13, 13, 13, 13, 13, 6, 81, 200, 13, 225, 32, 17, 43, 22,
         179, 13, 13, 17, 236, 236, 236, 236, 236, 236, 236, 121, 211, 2,
         211, 185, 54, 16, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5,
         5, 5, 5, 5, 5, 5, 50, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5,
         5, 5, 5, 5, 5, 5, 5, 40],
        dtype=np.uint8,
    )
    expected = [27, 17, 0, 15, 25, 33, 15, 29, 31, 32, 0, 0, 17, 28, 40, 34,
                33, 31, 34, 25, 1, 1, 34, 36, 23, 33, 25, 1, 0, 25, 34, 37,
                4, 39, 32, 31, 34, 33, 26, 7, 0, 5, 40, 1, 1, 38, 40, 34, 2,
                40, 40, 38, 38, 0, 1, 1, 0, 40, 2, 0, 1, 1, 0, 40, 41]
    present = np.zeros(256, dtype=bool)
    present[data] = True
    idx = mtf_indices(data, present)
    syms, _freqs = rle2_encode(idx, int(present.sum()))
    assert syms.tolist() == expected
