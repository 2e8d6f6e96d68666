"""Worker for the real multi-process multihost tests (tests/test_multihost.py).

Usage: python multihost_worker.py <pid> <nproc> <port> <input> <output>
       <level> [report.json]

Run once per process; forms a jax.distributed job over localhost TCP on the
CPU backend and encodes <input> with encode_multihost_path.  Process 0
writes the stitched stream to <output> and, when a report path is given,
the scaling-accounting report (span waits, encode walls, plan scan,
gathered DCN bytes, modeled efficiency) as JSON.
"""

import json
import sys


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    inp, outp, level = sys.argv[4], sys.argv[5], int(sys.argv[6])
    report_path = sys.argv[7] if len(sys.argv) > 7 else None

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc

    from banzai_jax.parallel.multihost import encode_multihost_path

    report: dict = {}
    out = encode_multihost_path(inp, level, report=report)
    if pid == 0:
        with open(outp, "wb") as f:
            f.write(out)
        if report_path:
            with open(report_path, "w") as f:
                json.dump(report, f, indent=1)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
