"""banzai_jax — a bzip2 encoder whose hot path runs on an accelerator.

A from-scratch re-design of the capabilities of the reference encoder
(jgbyrne/banzai, a Rust SA-IS bzip2 encoder) for a GPU: the per-block
pipeline (RLE1 -> BWT -> MTF -> RLE2 -> Huffman -> bit-pack) runs as batched
JAX/XLA array transforms over a device mesh, with a thin host layer
for streaming I/O, .bz2 container framing, ordered block stitching, and the
combined stream CRC.

Public API (mirrors the reference crate API, lib/lib.rs:84-153):

* ``compress(data, level=9, backend=...) -> bytes``
* ``encode(reader, writer, level=9, backend=...)``
* ``encode_file(input_path, output_path)``
"""

from __future__ import annotations

import os
from typing import BinaryIO

__version__ = "0.1.0"

_BACKENDS = ("auto", "numpy", "jax")


def compress(data: bytes, level: int = 9, backend: str = "auto") -> bytes:
    """One-shot encode of ``data`` at ``level`` (block size level*100kB)."""
    if not 1 <= level <= 9:
        raise ValueError(f"level must be in 1..9, got {level}")
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}")
    if backend == "auto":
        backend = _auto_backend()
    if backend == "jax":
        from .pipeline import compress as jax_compress

        return jax_compress(data, level)
    from .encoder_host import compress as np_compress

    return np_compress(data, level)


def encode(
    reader: BinaryIO,
    writer: BinaryIO,
    level: int = 9,
    backend: str = "auto",
    span_bytes: int = 32 * 1024 * 1024,
    report=None,
) -> int:
    """Stream-encode ``reader`` into ``writer`` with bounded memory.

    Matches the reference crate's ``encode`` entry point (lib/lib.rs:84):
    input is pulled in ``span_bytes`` spans; all blocks of a span except
    the last (which could still grow) are encoded and flushed immediately.
    The only state carried between spans is the running stream CRC and the
    unconsumed raw tail — exactly the reference's resumable state
    (SURVEY.md §5, checkpoint/resume).

    When ``report`` (a profiling.EncodeReport) is given, per-block stats
    are appended to it as blocks are flushed.
    """
    from .bitio import BitWriter
    from .constants import MAX_LEVEL, MIN_LEVEL
    from .container import write_stream_footer, write_stream_header
    from .crc32 import combine_stream_crc

    if not (MIN_LEVEL <= level <= MAX_LEVEL):
        raise ValueError(f"level must be {MIN_LEVEL}..{MAX_LEVEL}")
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}")
    if backend == "auto":
        backend = _auto_backend()

    bw = BitWriter()
    write_stream_header(bw, level)
    stream_crc = 0
    written = 0

    def flush() -> None:
        nonlocal written
        chunk = bw.drain()
        if chunk:
            writer.write(chunk)
            written += len(chunk)

    def span_blocks():
        """Lazy cross-span block stream: each span is read and RLE1-split
        only when the consumer pulls past the previous one — so under the
        jax backend, where the pipeline's producer thread is the puller,
        the NEXT span's host RLE1 overlaps the device's work on the
        current span instead of gating it (wall-vs-device gap)."""
        from .rle1 import split_blocks

        tail = b""
        eof = False
        while not eof:
            buf = reader.read(span_bytes)
            eof = not buf
            data = tail + buf
            if not data:
                return
            blocks = split_blocks(data, level)
            hold = 0 if eof else 1          # last block may still grow
            take = blocks[: len(blocks) - hold] if hold else blocks
            consumed = 0
            for blk in take:
                consumed += blk.consumed
                yield blk
            tail = data[consumed:]

    if backend == "jax":
        from .pipeline import compress_blocks_iter

        for blk, p in compress_blocks_iter(span_blocks(), level):
            stream_crc = combine_stream_crc(stream_crc, p.crc)
            p.write(bw)
            if report is not None:
                report.add_block(
                    blk.consumed, len(blk.output), p.nbits, p.ptr, p.crc,
                )
            flush()
    else:
        from .encoder_host import encode_block

        for blk in span_blocks():
            stream_crc = combine_stream_crc(stream_crc, blk.crc)
            ptr, payload_bits = encode_block(bw, blk.output, blk.crc)
            if report is not None:
                # Same numbers as the device path: entropy payload
                # bits (excl. header/symmap) and the real BWT ptr.
                report.add_block(
                    blk.consumed, len(blk.output),
                    payload_bits, ptr, blk.crc,
                )
            flush()

    write_stream_footer(bw, stream_crc)
    final = bw.drain(final=True)
    if final:
        writer.write(final)
        written += len(final)
    return written


def encode_file(input_path: str, output_path: str, level: int = 9) -> None:
    """File-to-file encode (reference: encode_file, lib/lib.rs:141-153;
    note the reference fixes level at 9 there — we default to 9 too)."""
    with open(input_path, "rb") as fin, open(output_path, "wb") as fout:
        encode(fin, fout, level)


def _auto_backend() -> str:
    """What ``backend="auto"`` means: ``BANZAI_BACKEND`` when it names a
    backend, else jax when it can initialize, else numpy.  A value that
    names no backend raises instead of being ignored."""
    from .utils import env_setting

    backend = env_setting("BANZAI_BACKEND") or "auto"
    if backend not in _BACKENDS:
        raise ValueError(
            f"BANZAI_BACKEND must be one of {_BACKENDS}, got {backend!r}"
        )
    if backend == "auto":
        backend = "jax" if _jax_usable() else "numpy"
    return backend


_JAX_PROBE: bool | None = None


def _jax_usable() -> bool:
    """True iff the JAX backend can actually initialize.

    ``import jax`` succeeding is not enough: an accelerator backend that
    imports but cannot initialize its device (a missing or broken runtime,
    a card held by another process) hangs or raises only at first device
    use, deep inside the pipeline, after output has started.  Probe
    ``jax.devices()`` once per process with a timeout and
    cache the verdict; on timeout/failure every ``backend="auto"`` entry
    point falls back to the byte-identical NumPy backend (slower, but the
    stream is valid).  The reference never needed this — it has no
    accelerator — but its CLI's exit-code contract
    (bnz/src/main.rs:11-14) implies "never traceback, never corrupt".
    """
    global _JAX_PROBE
    if _JAX_PROBE is None:
        _JAX_PROBE = _probe_jax_backend()
    return _JAX_PROBE


def _probe_jax_backend() -> bool:
    try:
        import jax
    except Exception:
        return False
    import threading

    # Backend init can HANG rather than raise, so the probe runs in a
    # daemon thread under a timeout (a thread, not a subprocess: a second
    # process would reserve the device's memory a second time).  On
    # timeout the zombie thread is abandoned; we never touch jax device
    # state again.
    ok: list[bool] = []

    def probe() -> None:
        try:
            ok.append(bool(jax.devices()))
        except Exception:
            ok.append(False)

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(float(os.environ.get("BANZAI_PROBE_TIMEOUT", "60")))
    return bool(ok) and ok[0]
