#!/usr/bin/env python
"""Smoke run of the encoder on the GPU, through the public entry points.

Builds a ~32 MB corpus from ``--seed`` and the checkout's own sources and
drives it through ``banzai_jax.compress``/``encode`` and the ``bnz`` CLI at
level 9 (900 kB blocks, batch 8) and level 1 (100 kB blocks, batch 64).
Every stream must decode bit-exactly with libbz2 (and ``bzip2 -d`` when it
is on PATH), must equal the host twin's stream (``backend="numpy"``) byte
for byte, and must be no larger than the banzai model's.  Prints one line
per phase, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when JAX finds no GPU or any phase fails.

    python chip_smoke.py              # one card: every one-card phase
    python chip_smoke.py --chips 4    # four cards: sharded vs one card only
"""

from __future__ import annotations

import argparse
import bz2
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
_FULL_LEVEL = 9      # 900 kB blocks: the widest shape the format has
_CORPUS_MB = 32.0    # dozens of 900 kB blocks: several batches of 8


def _say(msg: str) -> None:
    print(msg, flush=True)


# ---- corpus -----------------------------------------------------------------

def _zipf_text(rng: np.random.Generator, size: int) -> bytes:
    """Seeded prose-like text: Zipf-distributed words over a random
    lowercase vocabulary, with sentence punctuation and line breaks."""
    nvocab = 20_000
    lens = rng.integers(2, 11, nvocab)
    letters = rng.integers(ord("a"), ord("z") + 1, int(lens.sum()), np.uint8)
    cuts = np.cumsum(lens)[:-1]
    vocab = [w.tobytes() for w in np.split(letters, cuts)]
    p = 1.0 / np.arange(1, nvocab + 1) ** 1.1
    nwords = size // 5 + 1
    ids = rng.choice(nvocab, nwords, p=p / p.sum())
    seps = np.array([b" ", b" ", b" ", b" ", b" ", b" ", b", ", b".\n"])
    sep = seps[rng.integers(0, len(seps), nwords)]
    out = b"".join(vocab[i] + s for i, s in zip(ids.tolist(), sep.tolist()))
    return out[:size]


def _walk(rng: np.random.Generator, size: int) -> bytes:
    """Binary random walk: locally correlated bytes, no text structure."""
    return (rng.integers(-3, 4, size).cumsum() % 256).astype(np.uint8).tobytes()


def _runs(rng: np.random.Generator, size: int) -> bytes:
    """Runs of 1..2000 equal bytes (RLE1's 4..255 chunking and its
    block-boundary rules)."""
    n = size // 500 + 1
    vals = rng.integers(0, 256, n).astype(np.uint8)
    lens = rng.integers(1, 2001, n)
    return np.repeat(vals, lens).tobytes()[:size]


def _periodic(rng: np.random.Generator, size: int) -> bytes:
    """Periodic stretches (periods 1..251): long tie groups in the BWT."""
    parts, total = [], 0
    while total < size:
        period = int(rng.choice([1, 2, 5, 17, 64, 251]))
        seed = rng.integers(0, 256, period).astype(np.uint8).tobytes()
        ln = int(rng.integers(50_000, 400_000))
        parts.append((seed * (ln // period + 1))[:ln])
        total += ln
    return b"".join(parts)[:size]


def _sources(size: int) -> bytes:
    """The package's own source files, tiled."""
    paths = []
    for root, dirs, files in os.walk(os.path.join(_REPO, "banzai_jax")):
        dirs[:] = sorted(d for d in dirs if not d.startswith((".", "__")))
        paths += [
            os.path.join(root, f) for f in sorted(files)
            if f.endswith((".py", ".c"))
        ]
    blob = b"".join(open(p, "rb").read() for p in paths)
    if not blob:
        raise RuntimeError("no package sources found beside chip_smoke.py")
    return (blob * (size // len(blob) + 1))[:size]


def build_corpus(seed: int, mb: float):
    """(corpus bytes, [(region, start, end), ...]) — deterministic in
    ``seed`` and the checkout's sources."""
    rng = np.random.default_rng(seed)
    total = int(mb * 1e6)
    plan = [
        ("text", 0.375, lambda n: _zipf_text(rng, n)),
        ("walk", 0.25, lambda n: _walk(rng, n)),
        ("source", 0.125, _sources),
        ("runs", 0.125, lambda n: _runs(rng, n)),
        ("periodic", 0.125, lambda n: _periodic(rng, n)),
    ]
    parts, spans, off = [], [], 0
    for name, frac, make in plan:
        n = int(total * frac)
        blob = make(n)
        if len(blob) != n:
            raise RuntimeError(f"region {name}: {len(blob)} != {n} bytes")
        parts.append(blob)
        spans.append((name, off, off + n))
        off += n
    return b"".join(parts), spans


# ---- checks -----------------------------------------------------------------

def check_decodes(stream: bytes, data: bytes, what: str) -> str:
    """Bit-exact decode with libbz2 and, when present, ``bzip2 -d``."""
    if bz2.decompress(stream) != data:
        raise AssertionError(f"{what}: libbz2 decode differs from input")
    if shutil.which("bzip2") is None:
        return "libbz2 ok, bzip2 not on PATH"
    p = subprocess.run(["bzip2", "-d"], input=stream, capture_output=True)
    if p.returncode != 0 or p.stdout != data:
        raise AssertionError(f"{what}: bzip2 -d failed (rc {p.returncode})")
    return "libbz2 ok, bzip2 -d ok"


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


# ---- phases -----------------------------------------------------------------

def phase_identity(jax) -> None:
    from banzai_jax.utils import cache_dir

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _say(smi)                     # the card's name and power limit
    dev = jax.devices()[0]
    _say(
        f"[1 identity] device_kind={dev.device_kind} "
        f"count={len(jax.devices())} jax={jax.__version__} "
        f"cache={cache_dir()}"
    )


def phase_level(bj, corpus: bytes, level: int, tag: str) -> bytes:
    mb = len(corpus) / 1e6
    cold, cold_s = _timed(bj.compress, corpus, level, backend="jax")
    warm, warm_s = _timed(bj.compress, corpus, level, backend="jax")
    if warm != cold:
        raise AssertionError(f"level {level}: warm stream != cold stream")
    dec = check_decodes(warm, corpus, f"level {level}")
    _say(
        f"[{tag} level{level}] {len(corpus)} -> {len(warm)} B; "
        f"cold {cold_s:.3f} s (compile + run); warm {warm_s:.3f} s = "
        f"{mb / warm_s:.3f} MB/s; {dec}"
    )
    return warm


def phase_stream_cli(bj, corpus: bytes) -> None:
    data = corpus[: 12 * 10**6]
    out = io.BytesIO()
    n = bj.encode(io.BytesIO(data), out, level=_FULL_LEVEL, backend="jax",
                  span_bytes=5 * 10**6)
    stream = out.getvalue()
    if n != len(stream):
        raise AssertionError("encode() byte count != bytes written")
    if stream != bj.compress(data, _FULL_LEVEL, backend="jax"):
        raise AssertionError("encode() stream != compress() stream")
    dec = check_decodes(stream, data, "encode()")
    from banzai_jax import cli

    os.environ["BANZAI_BACKEND"] = "jax"     # the CLI's backend="auto"
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "slice.bin")
        with open(src, "wb") as f:
            f.write(data[: 3 * 10**6])
        rc = cli.main(["-k", f"-{_FULL_LEVEL}", src])
        if rc != 0:
            raise AssertionError(f"CLI exit code {rc}")
        with open(src + ".bz2", "rb") as f:
            cli_stream = f.read()
    cli_dec = check_decodes(cli_stream, data[: 3 * 10**6], "CLI")
    _say(
        f"[4 stream+cli] encode(): {len(data)} -> {len(stream)} B, {dec}; "
        f"CLI -{_FULL_LEVEL}: {len(cli_stream)} B, {cli_dec}"
    )


def phase_reference(bj, corpus: bytes, spans) -> None:
    from banzai_jax.oracle import banzai_compress

    lo = max(0, spans[0][2] - 1_500_000)         # straddles text | walk
    piece = corpus[lo : lo + 3_000_000]
    for level in (_FULL_LEVEL, 1):
        dev = bj.compress(piece, level, backend="jax")
        host = bj.compress(piece, level, backend="numpy")
        if dev != host:
            raise AssertionError(
                f"level {level}: device stream != host twin "
                f"({len(dev)} vs {len(host)} B)"
            )
    sizes = []
    for name, start, _end in spans[:3]:
        window = corpus[start : start + 10**6]
        ours = bj.compress(window, _FULL_LEVEL, backend="jax")
        ref = banzai_compress(window, _FULL_LEVEL)
        if len(ours) > len(ref):
            raise AssertionError(f"{name}: {len(ours)} B > banzai {len(ref)}")
        sizes.append(f"{name} {len(ours)}<={len(ref)}")
    _say(
        "[5 reference] 3 MB slice byte-identical to host twin at levels "
        f"{_FULL_LEVEL} and 1; banzai size gate: {', '.join(sizes)}"
    )


def phase_card_only(jax, corpus: bytes) -> None:
    import jax.numpy as jnp

    from banzai_jax import pipeline
    from banzai_jax.constants import SEGMENT_WIDTH, block_capacity
    from banzai_jax.ops.bwt import bwt_rotations
    from banzai_jax.oracle.stages import numpy_bwt
    from banzai_jax.rle1 import iter_blocks

    N = pipeline._padded_len(_FULL_LEVEL)
    blk = next(iter_blocks(corpus, _FULL_LEVEL))
    rle1 = np.asarray(blk.output)
    n = len(rle1)
    if n < 0.99 * block_capacity(_FULL_LEVEL):
        raise AssertionError(f"first block is only {n} B: not full")
    block = np.zeros(N, np.uint8)
    block[:n] = rle1
    (bwt_d, ptr_d), s = _timed(
        lambda: jax.block_until_ready(
            bwt_rotations(jnp.asarray(block), jnp.int32(n))
        )
    )
    bwt_h, ptr_h = numpy_bwt(rle1.tobytes())
    if not (np.array_equal(np.asarray(bwt_d)[:n], bwt_h)
            and int(ptr_d) == ptr_h):
        raise AssertionError("full-shape BWT differs from the numpy oracle")
    nseg = (N + 1 + SEGMENT_WIDTH - 1) // SEGMENT_WIDTH
    spec = jax.ShapeDtypeStruct(
        (pipeline._DEFAULT_BATCH, N + pipeline._ROW_EXTRA), np.uint8
    )
    compiled = pipeline._encode_blocks.lower(
        spec, nseg=nseg, nwords=pipeline._nwords(N, nseg)
    ).compile()
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    mem = ", ".join(f"{f}={getattr(m, f, 'n/a')}" for f in fields)
    _say(
        f"[6 card-only] full-shape BWT n={n} matches numpy oracle "
        f"(compile + run {s:.3f} s); fused jit [{spec.shape[0]}, {N}]: {mem}"
    )


def phase_four_cards(bj, jax, corpus: bytes) -> None:
    from banzai_jax import pipeline

    mb = len(corpus) / 1e6
    level = _FULL_LEVEL
    bj.compress(corpus, level, backend="jax")             # warm: sharded
    pipeline.compress(corpus, level, sharded=False)       # warm: one card
    sharded, s4 = _timed(bj.compress, corpus, level, backend="jax")
    single, s1 = _timed(pipeline.compress, corpus, level, sharded=False)
    if sharded != single:
        raise AssertionError("sharded stream != one-card stream")
    dec = check_decodes(sharded, corpus, "sharded")
    _say(
        f"[7 four cards] {len(jax.devices())} cards: {mb / s4:.3f} MB/s "
        f"({s4:.3f} s); one card (sharded=False): {mb / s1:.3f} MB/s "
        f"({s1:.3f} s); streams byte-identical; {dec}"
    )


def init_jax(chips: int):
    """Import JAX on the GPU only: no fallback to the CPU."""
    os.environ["JAX_PLATFORMS"] = "cuda"
    if chips == 1:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import jax

    if jax.default_backend() != "gpu":
        raise RuntimeError(f"JAX backend is {jax.default_backend()}, not gpu")
    if len(jax.devices()) != chips:
        raise RuntimeError(
            f"need {chips} GPU(s), JAX sees {len(jax.devices())}"
        )
    return jax


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    jax = init_jax(args.chips)
    import banzai_jax as bj

    # A device batch that the pipeline would quietly re-encode on the
    # host must fail the run instead.
    warnings.filterwarnings("error", message="device batch failed")
    t0 = time.perf_counter()
    phase_identity(jax)
    corpus, spans = build_corpus(args.seed, _CORPUS_MB)
    _say(
        f"corpus: {len(corpus)} B, seed {args.seed}, regions "
        + ", ".join(f"{n} [{a}, {b})" for n, a, b in spans)
    )
    if args.chips == 4:
        phase_four_cards(bj, jax, corpus)
    else:
        phase_level(bj, corpus, _FULL_LEVEL, "2")
        phase_level(bj, corpus, 1, "3")
        phase_stream_cli(bj, corpus)
        phase_reference(bj, corpus, spans)
        phase_card_only(jax, corpus)
    _say(f"total {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
