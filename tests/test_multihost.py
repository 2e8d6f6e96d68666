"""Real multi-process multihost test (VERDICT r1 item 3).

Launches a genuine 2-process ``jax.distributed`` job on the CPU backend
(SURVEY.md §4: multi-host logic is testable with multi-process JAX on CPU)
and checks the stitched stream is byte-identical to the single-host encode
and decodes via bzip2 -d.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _corpus() -> bytes:
    import numpy as np

    rng = np.random.default_rng(7)
    txt = open(os.path.join(REPO, "banzai_jax", "rle1.py"), "rb").read()
    parts = [
        txt * 3,
        b"abcde" * 8000,
        bytes(rng.integers(0, 256, 60_000, dtype=np.uint8)),
        b"\x00" * 30_000,
        txt,
    ]
    return b"".join(parts)


def _run_multihost(tmp_path, data, level, nproc, want_report=False):
    inp = tmp_path / "input.bin"
    outp = tmp_path / "multi.bz2"
    repp = tmp_path / "report.json"
    inp.write_bytes(data)

    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    worker = os.path.join(REPO, "tests", "multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), str(nproc), str(port),
             str(inp), str(outp), str(level)]
            + ([str(repp)] if want_report else []),
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(nproc)
    ]
    for p in procs:
        try:
            rc = p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        if rc != 0:
            err = p.stderr.read().decode()[-2000:]
            pytest.fail(f"worker exited {rc}: {err}")
    report = None
    if want_report:
        import json

        report = json.loads(repp.read_text())
    return outp.read_bytes(), report


@pytest.mark.parametrize("level,nproc", [(1, 2), (1, 3)])
def test_two_process_stream_matches_single_host(tmp_path, level, nproc):
    data = _corpus()
    multi, _ = _run_multihost(tmp_path, data, level, nproc)

    # Single-host reference (this process, CPU backend via conftest).
    from banzai_jax.pipeline import compress

    single = compress(data, level)
    assert multi == single, (
        f"multi-host stream differs: {len(multi)} vs {len(single)} bytes"
    )

    d = subprocess.run(["bzip2", "-d", "-c"], input=multi,
                       capture_output=True)
    assert d.returncode == 0 and d.stdout == data


def test_four_process_scaling_accounted(tmp_path):
    """4-process run with the scaling-model report (VERDICT r3 item 5):
    byte-identity, planning overlapped with encode, DCN bytes =
    compressed payloads only, and a recorded modeled efficiency.

    The >=80% north star is about compute-bound pod spans; this CPU run
    asserts a slightly looser 0.70 floor because four jax processes share
    one noisy CI host, and records the real number for STATUS.md.
    """
    # Big enough that encode dominates: ~1.6 MB, 16+ level-1 blocks.
    data = _corpus() * 5 + _corpus()[::-1] * 3
    multi, report = _run_multihost(tmp_path, data, 1, 4, want_report=True)

    from banzai_jax.pipeline import compress

    single = compress(data, 1)
    assert multi == single
    assert report["nproc"] == 4
    # Planning is pipelined: no host waited for the FULL scan before its
    # span arrived — the scan itself must overlap encode, so every span
    # wait is well under the slowest host's total.
    assert max(report["span_wait_s"]) < report["modeled_parallel_s"] / 2
    # DCN traffic is compressed payloads + tiny tables, not input-sized.
    assert report["dcn_payload_bytes"] < len(data) / 2
    assert report["modeled_single_host_s"] > 0
    eff = report["modeled_efficiency"]
    assert eff >= 0.70, f"modeled efficiency {eff} below floor (report={report})"
    print(f"multihost 4-process scaling report: {report}")
