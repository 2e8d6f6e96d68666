"""Regression-corpus replay (the reference keeps its fuzz corpus out of
git, fuzz/.gitignore; we ratchet instead: every input fuzzing ever broke
the encoder with is checked in under tests/corpus/ and replayed in CI).

File naming: ``fail_<origin>_l<level>.bin`` replays at that exact level;
``seed_*.bin`` are structured mutation seeds for fuzz.py's mutation loop
and replay here across a small level sweep.  Every case must round-trip
through the independent system bzip2 decoder and respect the <=-banzai
size contract.
"""

import glob
import os
import re

import pytest

from banzai_jax.encoder_host import compress as host_compress
from banzai_jax.oracle import banzai_compress

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "corpus")
CASES = sorted(glob.glob(os.path.join(CORPUS, "*.bin")))


def _levels(path: str) -> list[int]:
    m = re.search(r"_l(\d)\.bin$", path)
    if m:
        return [int(m.group(1))]
    return [1, 9]


def test_corpus_not_empty():
    assert len(CASES) >= 7


@pytest.mark.parametrize("path", CASES, ids=[os.path.basename(p) for p in CASES])
def test_corpus_replay(path, bunzip):
    data = open(path, "rb").read()
    for level in _levels(path):
        ours = host_compress(data, level)
        assert bunzip(ours) == data, (path, level)
        theirs = banzai_compress(data, level)
        assert len(ours) <= len(theirs), (
            f"{os.path.basename(path)} level {level}: "
            f"ours {len(ours)} > banzai {len(theirs)}"
        )
