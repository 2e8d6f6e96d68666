#!/usr/bin/env python
"""Differential fuzz harness — the reference's fuzz targets, deterministic.

Mirrors fuzz/fuzz_targets/{encode,round_trip}.rs: random inputs are encoded
and (a) must not raise, (b) must decode bit-exactly through the independent
system bzip2 decoder, (c) must be no larger than the banzai model's output.

Usage: python fuzz.py [iterations] [--seed S] [--backend numpy|jax]
                      [--platform cpu|<default>] [--corpus DIR]

``--platform cpu`` pins the jax backend to the host CPU (by default JAX
takes the accelerator when one is present).

``--corpus DIR`` (default tests/corpus) turns on the mutation loop —
the ratcheting stand-in for the reference's libFuzzer corpus
(fuzz/fuzz_targets/round_trip.rs): about half the cases are mutations
(flips, splices, repeats, run/periodic insertions, truncations) of saved
corpus entries instead of fresh structured generations, and any failing
input is saved back into the corpus as ``fail_s<seed>_i<iter>_l<level>.bin``
so CI replays it forever (tests/test_corpus.py).
"""

from __future__ import annotations

import argparse
import glob
import os
import random
import subprocess
import sys


def gen_case(rng: random.Random) -> bytes:
    """Structured generator: mixes literals, runs, periodic repeats."""
    kind = rng.randrange(6)
    n = rng.choice([0, 1, 2, 3, 7, 100, 1000, 10_000, 120_000])
    if kind == 0:
        return rng.randbytes(n)
    if kind == 1:
        alpha = rng.choice([1, 2, 3, 16])
        return bytes(rng.randrange(alpha) for _ in range(n))
    if kind == 2:                      # run soup
        parts, tot = [], 0
        while tot < n:
            ln = rng.choice([1, 2, 3, 4, 5, 250, 251, 255, 256, 259, 260])
            parts.append(bytes([rng.randrange(8)]) * ln)
            tot += ln
        return b"".join(parts)
    if kind == 3:                      # periodic
        period = rng.randrange(1, 12)
        seed = rng.randbytes(period)
        return (seed * (n // max(1, period) + 1))[:n]
    if kind == 4:                      # text-ish
        words = [rng.randbytes(rng.randrange(2, 9)) for _ in range(16)]
        out = bytearray()
        while len(out) < n:
            out += rng.choice(words) + b" "
        return bytes(out[:n])
    return rng.randbytes(rng.randrange(0, 300))


def mutate(rng: random.Random, pool: list[bytes]) -> bytes:
    """One mutation of a random corpus entry (possibly spliced with
    another).  Mutations deliberately target the encoder's data-dependent
    seams: RLE1 run boundaries, block-capacity edges, periodic regions."""
    data = bytearray(rng.choice(pool))
    for _ in range(rng.randrange(1, 4)):
        op = rng.randrange(7)
        if op == 0 and data:                      # byte flips
            for _ in range(rng.randrange(1, 8)):
                data[rng.randrange(len(data))] = rng.randrange(256)
        elif op == 1:                             # splice another entry
            other = rng.choice(pool)
            if other:
                i = rng.randrange(len(other))
                j = rng.randrange(i, min(len(other), i + 4096))
                at = rng.randrange(len(data) + 1)
                data[at:at] = other[i:j]
        elif op == 2 and data:                    # repeat-expand a slice
            i = rng.randrange(len(data))
            j = rng.randrange(i, min(len(data), i + 64))
            data[i:i] = bytes(data[i:j]) * rng.randrange(2, 40)
        elif op == 3:                             # insert a run
            at = rng.randrange(len(data) + 1)
            ln = rng.choice([3, 4, 5, 250, 251, 255, 256, 259, 260, 1000])
            data[at:at] = bytes([rng.randrange(256)]) * ln
        elif op == 4:                             # insert periodic chunk
            at = rng.randrange(len(data) + 1)
            p = rng.randbytes(rng.randrange(1, 9))
            data[at:at] = p * rng.randrange(4, 200)
        elif op == 5 and len(data) > 1:           # truncate / delete
            i = rng.randrange(len(data))
            j = rng.randrange(i, len(data))
            del data[i:j]
        else:                                     # duplicate whole input
            if len(data) < 400_000:
                data = data + data
    return bytes(data[:2_000_000])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("iterations", nargs="?", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="numpy")
    ap.add_argument(
        "--corpus",
        default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "corpus"),
        help="mutation corpus dir ('' disables the mutation loop)",
    )
    ap.add_argument(
        "--level", type=int, default=1,
        help="compression level 1-9, or 0 to draw a random level per case",
    )
    ap.add_argument(
        "--platform", default=None,
        help="jax platform override (e.g. cpu); default: backend's choice",
    )
    args = ap.parse_args()

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from banzai_jax import compress
    from banzai_jax.oracle import banzai_compress

    pool: list[bytes] = []
    if args.corpus and os.path.isdir(args.corpus):
        pool = [
            open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(args.corpus, "*.bin")))
        ]

    rng = random.Random(args.seed)

    def save_fail(data: bytes, level: int, i: int) -> None:
        with open("fuzz_fail.bin", "wb") as f:
            f.write(data)
        if args.corpus and os.path.isdir(args.corpus):
            name = f"fail_s{args.seed}_i{i}_l{level}.bin"
            with open(os.path.join(args.corpus, name), "wb") as f:
                f.write(data)
            print(f"saved to corpus: {name}", file=sys.stderr)

    for i in range(args.iterations):
        data = mutate(rng, pool) if pool and rng.random() < 0.5 else (
            gen_case(rng)
        )
        level = args.level or rng.randrange(1, 10)
        out = compress(data, level, backend=args.backend)
        p = subprocess.run(["bzip2", "-d"], input=out, capture_output=True)
        if p.returncode != 0 or p.stdout != data:
            print(f"FAIL roundtrip @ iter {i}: {len(data)} bytes "
                  f"(seed {args.seed})", file=sys.stderr)
            save_fail(data, level, i)
            return 1
        ref = banzai_compress(data, level)
        if len(out) > len(ref):
            print(f"FAIL size @ iter {i}: ours {len(out)} > banzai "
                  f"{len(ref)} ({len(data)} bytes input)", file=sys.stderr)
            save_fail(data, level, i)
            return 1
        if i % 10 == 0:
            print(f"iter {i}: {len(data):7d} -> {len(out):7d} "
                  f"(banzai {len(ref)})")
    print(f"{args.iterations} iterations clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
