"""Multi-host streaming encode over several accelerator hosts.

The reference is single-process (SURVEY.md §2.11); this is the net-new
distribution layer.  Design (SURVEY.md §7 table, "distribution" row):

* ``jax.distributed.initialize()`` forms the job; every process owns a
  contiguous *span* of the input (spans, not striding, so RLE1's
  sequential block splitting stays host-local).
* **Process 0 plans, everyone else just encodes — pipelined.**  Block
  boundaries are data-dependent (an RLE1 block ends where its output hits
  capacity, which depends on every preceding byte), so process 0 streams
  the input through the vectorized splitter (~300 MB/s host-side).  The
  scan is INCREMENTAL: as soon as span ``h``'s boundary is found it is
  broadcast (a tiny [offset, length] row) and host ``h`` starts encoding
  on a worker thread while later spans are still being planned — so the
  serial prescan overlaps every host's encode instead of gating it, and
  the LAST span needs no scan at all (it is simply the remainder).  No
  process ever sees bytes outside its own span.
* Input is addressed by *path* on a filesystem every host can read: each
  process opens the file and reads only ``[offset, offset+length)`` — the
  per-host memory footprint is the span, not the input.  (A bytes-based
  entry point remains for single-process use and tests.)
* Within each host, blocks are encoded with the block-DP pipeline over the
  host's local devices (device interconnect only; no cross-host traffic
  on the hot path).
* The compressed ``(words, bit-length, crc, ptr)`` payloads are gathered
  over DCN in fixed-size chunks (bounded buffering, not one
  whole-stream-sized allgather) and stitched on process 0 *in input
  order*; the rotate-left-XOR stream-CRC combine (lib/lib.rs:108) is the
  only order-dependent state.
* **Scaling is accounted, not asserted**: every run can fill a ``report``
  dict with per-host span-wait/encode walls, the planner's scan time,
  gathered DCN bytes, and a modeled efficiency
  ``sum(encode_h) / (nproc * max_h(wall_h))`` where ``wall_h`` is host
  h's measured end-to-end wall (span wait + encode + gather) — the
  compute-bound scaling model the >=80% north star is tracked against
  (several real hosts are not always at hand; the model plus
  real 2/3/4-process CPU runs are the evidence).

Validated in-tree by real 2/3/4-process ``jax.distributed`` CPU runs
(tests/test_multihost.py) producing byte-identical streams to the
single-host encode, with the 4-process run recording the efficiency
model.
"""

from __future__ import annotations

import mmap
import os
import threading
import time
from dataclasses import dataclass

import numpy as np

from ..crc32 import combine_stream_crc
from ..rle1 import iter_blocks

_GATHER_CHUNK = 8 << 20  # bytes per DCN gather round


@dataclass
class Span:
    offset: int
    length: int


def plan_spans(data, level: int, n_hosts: int) -> list[Span]:
    """Split ``data`` into per-host spans on exact RLE1 block boundaries.

    Single-shot variant of the incremental rule the pipelined planner
    uses (proportional bytes, each span rounded up to the block boundary
    that reaches its share; the last span is the unscanned remainder).
    Kept for tests and offline planning; ``_encode_pipelined`` does the
    same thing one span at a time so encoding can start before the scan
    finishes.
    """
    total = len(data)
    blocks = iter_blocks(data, level)
    spans = []
    off = 0
    for h in range(n_hosts):
        remaining = total - off
        if h == n_hosts - 1:
            length = remaining
        else:
            target = -(-remaining // (n_hosts - h))
            length = 0
            while length < target:
                blk = next(blocks, None)
                if blk is None:
                    break
                length += blk.consumed
        spans.append(Span(off, length))
        off += length
    return spans


def _gather_chunked(flat: bytes, nproc: int) -> list[bytes] | None:
    """Gather per-host byte blobs to process 0 in bounded chunks.

    Every host contributes ``flat``; process 0 returns the list of blobs in
    process order, others return None.  Peak extra memory per round is
    nproc * _GATHER_CHUNK, not nproc * max blob size.
    """
    import jax
    from jax.experimental import multihost_utils

    pid = jax.process_index()
    lengths = multihost_utils.process_allgather(
        np.array([len(flat)], np.int64)
    ).reshape(-1)
    maxlen = int(lengths.max())
    nchunks = max(1, -(-maxlen // _GATHER_CHUNK))
    parts: list[list[bytes]] = [[] for _ in range(nproc)]
    src = np.frombuffer(flat, np.uint8)
    for c in range(nchunks):
        lo = c * _GATHER_CHUNK
        hi = min(lo + _GATHER_CHUNK, maxlen)
        buf = np.zeros(hi - lo, np.uint8)
        take = src[lo : min(hi, len(src))]
        buf[: len(take)] = take
        gathered = np.asarray(multihost_utils.process_allgather(buf))
        if pid == 0:
            for h in range(nproc):
                parts[h].append(gathered[h].tobytes())
    if pid != 0:
        return None
    return [
        b"".join(parts[h])[: int(lengths[h])] for h in range(nproc)
    ]


def _stitch(blobs: list[bytes], level: int) -> bytes:
    from ..bitio import BitWriter
    from ..container import write_stream_footer, write_stream_header
    from .serial import BlockPayload

    bw = BitWriter()
    write_stream_header(bw, level)
    stream_crc = 0
    for blob in blobs:
        for p in BlockPayload.iter_from_bytes(blob):
            stream_crc = combine_stream_crc(stream_crc, p.crc)
            p.write(bw)
    write_stream_footer(bw, stream_crc)
    return bw.close()


def _encode_pipelined(
    read_span,
    consumed_iter,
    total: int,
    level: int,
    nproc: int,
    pid: int,
    report: dict | None = None,
) -> bytes:
    """The pipelined core: incremental span broadcast + threaded encode.

    ``read_span(Span) -> bytes`` fetches this process's input bytes;
    ``consumed_iter`` (process 0 only) yields per-block consumed counts
    from the streaming splitter.  Returns the stitched stream on process
    0, b"" elsewhere.  Fills ``report`` (all processes) with the scaling
    accounting described in the module docstring.
    """
    from jax.experimental import multihost_utils

    t_entry = time.perf_counter()
    enc_out: dict = {}
    enc_thread = None
    span_wait = 0.0
    off = 0
    scan_s = 0.0
    for h in range(nproc):
        if pid == 0:
            remaining = total - off
            if h == nproc - 1:
                length = remaining        # remainder: no scan needed
            else:
                target = -(-remaining // (nproc - h))
                length = 0
                t0 = time.perf_counter()
                while length < target:
                    c = next(consumed_iter, None)
                    if c is None:
                        break
                    length += c
                scan_s += time.perf_counter() - t0
            row = np.array([off, length], np.int64)
            off += length
        else:
            row = np.zeros(2, np.int64)
        row = np.asarray(multihost_utils.broadcast_one_to_all(row))
        if h == pid:
            span = Span(int(row[0]), int(row[1]))
            span_wait = time.perf_counter() - t_entry
            my = read_span(span)

            def run(data=my):
                from ..pipeline import compress_blocks_payloads

                t0 = time.perf_counter()
                ps = compress_blocks_payloads(data, level)
                enc_out["flat"] = b"".join(p.to_bytes() for p in ps)
                enc_out["encode_s"] = time.perf_counter() - t0

            # Encode on a worker thread so this process keeps serving the
            # remaining span broadcasts (collectives are main-thread-only
            # by convention here; jit dispatch is thread-safe).
            enc_thread = threading.Thread(target=run)
            enc_thread.start()
    enc_thread.join()
    flat = enc_out["flat"]
    t0 = time.perf_counter()
    blobs = _gather_chunked(flat, nproc)
    # NOTE: this local gather window also absorbs waiting for straggler
    # processes still encoding (the collective can't complete before the
    # slowest host arrives), so it is NOT pure DCN time; it is reported
    # for visibility but the efficiency model uses measured end-to-end
    # walls, which can't double-count the skew.
    gather_s = time.perf_counter() - t0
    wall_s = time.perf_counter() - t_entry

    stats = np.asarray(
        multihost_utils.process_allgather(
            np.array(
                [span_wait, enc_out["encode_s"], float(len(flat)), wall_s],
                np.float64,
            )
        )
    ).reshape(nproc, 4)
    if report is not None:
        waits, encs, payload = stats[:, 0], stats[:, 1], stats[:, 2]
        t1 = float(encs.sum())               # modeled single-host encode
        tn = float(stats[:, 3].max())        # measured parallel wall
        report.update(
            nproc=nproc,
            input_bytes=total,
            span_wait_s=[round(x, 4) for x in waits.tolist()],
            encode_s=[round(x, 4) for x in encs.tolist()],
            plan_scan_s=round(scan_s, 4),
            gather_s=round(gather_s, 4),
            dcn_payload_bytes=int(payload.sum()),
            modeled_single_host_s=round(t1, 4),
            modeled_parallel_s=round(tn, 4),
            modeled_efficiency=round(t1 / (nproc * max(tn, 1e-9)), 4),
        )
    if blobs is None:
        return b""
    return _stitch(blobs, level)


def encode_multihost_path(
    path: str, level: int = 9, report: dict | None = None
) -> bytes:
    """Encode a file across all processes; returns the stream on process 0
    (other processes return b"").

    Process 0 mmaps the file and plans spans incrementally while every
    host (itself included) encodes; every process reads only its own span
    bytes.  ``path`` must be readable on every host.
    """
    import jax

    nproc = jax.process_count()
    pid = jax.process_index()
    if nproc == 1:
        from ..pipeline import compress

        with open(path, "rb") as f:
            return compress(f.read(), level)

    total = os.path.getsize(path)
    consumed_iter = None
    mm = None
    f0 = None
    if pid == 0:
        f0 = open(path, "rb")
        try:
            mm = mmap.mmap(f0.fileno(), 0, access=mmap.ACCESS_READ)
            data = mm
        except ValueError:              # empty file
            data = b""
        consumed_iter = (b.consumed for b in iter_blocks(data, level))

    def read_span(span: Span) -> bytes:
        with open(path, "rb") as f:
            f.seek(span.offset)
            return f.read(span.length)

    try:
        return _encode_pipelined(
            read_span, consumed_iter, total, level, nproc, pid, report
        )
    finally:
        del consumed_iter
        if mm is not None:
            try:
                mm.close()
            except BufferError:
                pass  # a stray view still holds the buffer; GC's
        if f0 is not None:
            f0.close()


def encode_multihost(
    data: bytes, level: int = 9, report: dict | None = None
) -> bytes:
    """Encode in-memory bytes across all processes (stream on process 0).

    Only process 0's ``data`` is authoritative: it plans the spans and
    broadcasts the table; every process encodes ``data[offset:offset+len)``
    of its *own* copy, so all processes must be handed identical bytes.
    For inputs too large to replicate, use :func:`encode_multihost_path`.
    """
    import jax

    nproc = jax.process_count()
    if nproc == 1:
        from ..pipeline import compress

        return compress(data, level)

    pid = jax.process_index()
    consumed_iter = (
        (b.consumed for b in iter_blocks(data, level)) if pid == 0 else None
    )

    def read_span(span: Span) -> bytes:
        return data[span.offset : span.offset + span.length]

    return _encode_pipelined(
        read_span, consumed_iter, len(data), level, nproc, pid, report
    )
