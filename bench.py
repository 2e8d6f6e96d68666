#!/usr/bin/env python
"""Benchmark: encode MB/s per card at level 9 on a silesia-proxy corpus.

The headline corpus mirrors silesia's category mix from in-image analogs
(build_silesia_proxy: prose/binary/database/source/sensor/xml at silesia's
fractions — the real corpus is unfetchable here, zero egress) and the
detail carries per-region MB/s plus the rounds-1-4 mixed corpus number for
round-over-round comparability.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "MB/s", "vs_baseline": N}

The baseline is the measured single-core throughput of system bzip2 -9 on
the same corpus (the reference banzai has no Rust toolchain here and is
documented as slower-on-average than bzip2: /root/reference/README.md:7, so
bzip2 is a conservative proxy).  It fails when JAX finds no GPU.

Also asserts, every run: bit-exact decode via bzip2 -d and compressed size
<= the banzai model's output.
"""

from __future__ import annotations

import glob
import json
import subprocess
import sys
import time

import numpy as np


def build_corpus(target_mb: float = 20.0) -> bytes:
    """Deterministic mixed corpus: source text, binary, runs, periodic.

    The original (rounds 1-4) headline corpus; kept as a secondary number
    (``mixed20_MBps``) so the round-over-round progression stays
    comparable, and because its run/periodic stressors exercise the
    chain-resolution paths the silesia proxy's regions mostly don't."""
    parts: list[bytes] = []
    # Text: jax's own source tree (stable inside the image).
    files = sorted(glob.glob("/opt/venv/lib/python3.12/site-packages/jax/_src/*.py"))
    text = b"".join(open(f, "rb").read() for f in files[:120])
    parts.append(text)
    # Binary-ish: deterministic pseudo-random with local correlation.
    rng = np.random.default_rng(42)
    walk = rng.integers(-3, 4, size=1_000_000).cumsum() % 256
    parts.append(walk.astype(np.uint8).tobytes())
    # Runs + periodic stressors.
    parts.append(b"\x00" * 300_000)
    parts.append(b"abcde" * 60_000)
    blob = b"".join(parts)
    target = int(target_mb * 1e6)
    reps = max(1, target // len(blob) + 1)
    return (blob * reps)[:target]


def _tile(blob: bytes, size: int) -> bytes:
    reps = max(1, size // max(len(blob), 1) + 1)
    return (blob * reps)[:size]


def _read_sorted(pattern: str, cap: int) -> bytes:
    out, total = [], 0
    for f in sorted(glob.glob(pattern)):
        try:
            b = open(f, "rb").read()
        except OSError:
            continue
        out.append(b)
        total += len(b)
        if total >= cap:
            break
    return b"".join(out)[:cap]


def build_silesia_proxy(target_mb: float = 20.0):
    """Silesia-composition proxy from in-image analogs (the corpus itself
    cannot be fetched: zero egress).  Region fractions follow silesia's
    category mix (prose 27.5% = dickens+reymont+webster, executable
    binary 27.1% = mozilla+ooffice, database 24.1% = nci+osdb+sao,
    source 10.2% = samba, sensor imagery 8.7% = mr+x-ray, xml 2.5%).

    Returns (corpus_bytes, [(region_name, start, end), ...]) so the bench
    can report per-region MB/s — a text-heavy stand-in can't flatter the
    headline when every region is timed and labelled."""
    t = int(target_mb * 1e6)
    sp = "/opt/venv/lib/python3.12/site-packages"
    regions: list[tuple[str, bytes]] = []
    # prose: package METADATA files — English prose + light markup
    # (dickens/webster analog: natural-language text).
    regions.append(
        ("prose", _tile(_read_sorted(f"{sp}/*.dist-info/METADATA",
                                     4 << 20), int(t * 0.275)))
    )
    # binary: ELF .text/.rodata of the largest in-image shared object
    # (mozilla/ooffice analog: compiled executable bytes).
    so = f"{sp}/tensorstore/_tensorstore.cpython-312-x86_64-linux-gnu.so"
    try:
        with open(so, "rb") as f:
            f.seek(1 << 20)                      # skip headers into .text
            elf = f.read(int(t * 0.271))
    except OSError:
        elf = b""
    regions.append(("binary", _tile(elf, int(t * 0.271))))
    # database: wheel RECORD files (path,hash,size rows — nci/osdb analog:
    # highly structured records) + a packed fixed-width binary table
    # (sao analog: binary star-catalog records).
    rec = _read_sorted(f"{sp}/*.dist-info/RECORD", 8 << 20)
    rng = np.random.default_rng(7)
    ids = np.arange(60_000, dtype=np.int32)
    mag = (rng.normal(9.0, 1.5, 60_000) * 100).astype(np.int16)
    ra = rng.integers(0, 1 << 24, 60_000).astype(np.int32)
    table = np.zeros(60_000, dtype=[("id", "<i4"), ("ra", "<i4"),
                                    ("mag", "<i2"), ("pad", "<i2")])
    table["id"], table["ra"], table["mag"] = ids, ra, mag
    db = _tile(rec, int(t * 0.16)) + _tile(table.tobytes(), int(t * 0.081))
    regions.append(("database", db))
    # source: C headers (samba analog: systems source code).
    regions.append(
        ("source", _tile(_read_sorted("/usr/include/*/*.h", 4 << 20),
                         int(t * 0.102)))
    )
    # sensor: correlated 16-bit-ish walk (mr/x-ray analog: smooth
    # scanner data, low local entropy, no text structure).
    walk = (rng.integers(-5, 6, int(t * 0.087)).cumsum() % 4096) >> 4
    regions.append(("sensor", walk.astype(np.uint8).tobytes()))
    # xml: iso-codes XML documents.
    regions.append(
        ("xml", _tile(_read_sorted("/usr/share/xml/iso-codes/*.xml",
                                   2 << 20), int(t * 0.025)))
    )
    spans, parts, off = [], [], 0
    for name, blob in regions:
        parts.append(blob)
        spans.append((name, off, off + len(blob)))
        off += len(blob)
    corpus = b"".join(parts)[:t]
    spans = [
        (name, lo, min(hi, t)) for name, lo, hi in spans if lo < t
    ]  # region fractions sum to ~1.001 of t: clamp the truncated tail
    return corpus, spans


def _require_gpu() -> None:
    """Fail unless JAX runs on a GPU: a number from any other backend must
    never be printed under the device metric's name."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py needs a GPU; JAX found {dev.platform} ({dev.device_kind})"
        )


def main() -> int:
    _require_gpu()
    corpus, spans = build_silesia_proxy()
    level = 9
    mb = len(corpus) / 1e6

    # Baseline: system bzip2 -9 wall time (single core).  Best of two runs
    # — the shared host's load varies a lot, and a slowed-down baseline
    # would overstate our ratio.
    bzip2_s = float("inf")
    for _ in range(2):
        t0 = time.time()
        p = subprocess.run(
            ["bzip2", "-9", "-c"], input=corpus, capture_output=True
        )
        bzip2_s = min(bzip2_s, time.time() - t0)
    bzip2_mbps = mb / bzip2_s

    from banzai_jax.pipeline import compress

    # Warm up on the full corpus so the timed run reuses every compiled
    # [batch, N] shape it will hit (the pow-2 tail ladder means the tail
    # batch can have its own shape).  Best of three timed runs.
    compress(corpus, level)
    encode_s = float("inf")
    for _ in range(3):
        t0 = time.time()
        out = compress(corpus, level)
        encode_s = min(encode_s, time.time() - t0)
    mbps = mb / encode_s

    # Correctness gates: bit-exact decode, and the north-star size contract
    # (output <= the quirk-exact banzai model) on three 1MB windows — one
    # each from the prose, binary and database regions (the full-corpus
    # model run would cost ~80s of pure-Python time; the level 1-9 sweep
    # in tests/test_size_parity.py is the exhaustive gate).
    d = subprocess.run(["bzip2", "-d"], input=out, capture_output=True)
    assert d.returncode == 0 and d.stdout == corpus, "round-trip failed"
    from banzai_jax.oracle import banzai_compress

    for name, lo, _hi in spans[:3]:
        window = corpus[lo : lo + 10**6]
        ours_w = compress(window, level)
        banzai_w = banzai_compress(window, level)
        assert len(ours_w) <= len(banzai_w), (
            f"banzai size gate failed on {name}: "
            f"{len(ours_w)} > {len(banzai_w)}"
        )

    # Level-dependent throughput (VERDICT r1 item 7): level 1 uses ~100 KB
    # blocks — 9x the block count, 1/9th the sort depth per block.
    lvl1_mbps = 0.0
    try:
        compress(corpus, 1)      # warm level-1 shapes (a 2MB slice missed
        # the full corpus's [64]/[16] tail-batch shapes and timed compiles)
        lvl1_s = float("inf")
        for _ in range(2):       # best-of-two, same rule as level 9
            t0 = time.time()
            out1 = compress(corpus, 1)
            lvl1_s = min(lvl1_s, time.time() - t0)
        lvl1_mbps = mb / lvl1_s
        d1 = subprocess.run(["bzip2", "-d"], input=out1, capture_output=True)
        assert d1.returncode == 0 and d1.stdout == corpus, "level-1 roundtrip"
    except Exception as e:
        if isinstance(e, AssertionError):
            raise
        lvl1_mbps = -1.0                     # backend hiccup: don't fail bench

    # Per-region throughput: each region tiled to a fixed 12 MB stream
    # (same [2]/[8]/[4] batch-shape ladder as the headline run — no new
    # compiles) and timed once against a single bzip2 -9 run.  12 MB
    # includes the ~0.2 s fill/drain edges, so region numbers read a few
    # MB/s under the 20 MB headline; they are for MIX HONESTY (no region
    # can hide behind the average), not for peak claims.
    regions: dict[str, dict] = {}
    try:
        for name, lo, hi in spans:
            blob = _tile(corpus[lo:hi], 12_000_000)
            t0 = time.time()
            out_r = compress(blob, level)
            s_r = time.time() - t0
            t0 = time.time()
            subprocess.run(["bzip2", "-9", "-c"], input=blob,
                           capture_output=True)
            s_bz = time.time() - t0
            regions[name] = {
                "MBps": round(12.0 / s_r, 2),
                "vs_bzip2": round(s_bz / s_r, 2),
            }
    except Exception as e:
        regions = {"error": str(e)[:120]}

    # Legacy rounds-1-4 mixed corpus (source + walk + runs/periodic): the
    # round-over-round comparable number.
    mixed20_mbps = 0.0
    try:
        mixed = build_corpus(20.0)
        compress(mixed, level)
        t0 = time.time()
        out_m = compress(mixed, level)
        mixed20_mbps = len(mixed) / 1e6 / (time.time() - t0)
        d_m = subprocess.run(["bzip2", "-d"], input=out_m,
                             capture_output=True)
        assert d_m.returncode == 0 and d_m.stdout == mixed, "mixed20 rt"
    except AssertionError:
        raise
    except Exception:
        mixed20_mbps = -1.0

    import jax

    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "device": {
                    "platform": dev.platform, "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "metric": "encode MB/s/card, level 9, "
                          "20MB silesia-proxy corpus",
                "value": round(mbps, 3),
                "unit": "MB/s",
                "vs_baseline": round(mbps / bzip2_mbps, 3),
                "detail": {
                    "bzip2_9_MBps": round(bzip2_mbps, 3),
                    "our_bytes": len(out),
                    "bzip2_bytes": len(p.stdout),
                    "corpus_bytes": len(corpus),
                    "regions_MBps": regions,
                    "mixed20_MBps": round(mixed20_mbps, 3),
                    "level1_MBps": round(lvl1_mbps, 3),
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
