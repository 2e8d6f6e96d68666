import os
import subprocess
import sys

import pytest

from banzai_jax.cli import EXIT_OK, EXIT_OUTPUT_IO, EXIT_USAGE, parse_args


def test_parse_defaults():
    inv = parse_args(["file.txt"])
    assert inv.input == "file.txt" and inv.level == 9
    assert inv.keep_inf is None and not inv.stdout


def test_parse_combined_short_flags():
    inv = parse_args(["-kc9", "x"])
    assert inv.keep_inf is True and inv.stdout and inv.level == 9


def test_parse_keep_remove_last_wins():
    # Mirrors the reference's Option<bool> overwrite (bnz/src/main.rs:193-196).
    assert parse_args(["-k", "-r", "x"]).keep_inf is False
    assert parse_args(["-r", "--keep", "x"]).keep_inf is True


def test_parse_aliases_and_output():
    inv = parse_args(["--fast", "--output", "out.bz2", "in"])
    assert inv.level == 1 and inv.output == "out.bz2"


def test_parse_stdin_and_end_of_flags():
    inv = parse_args(["--", "-weird-name"])
    assert inv.input == "-weird-name"
    inv = parse_args(["-c", "-"])
    assert inv.input == "-" and inv.stdout


def test_parse_errors():
    assert parse_args([]) == EXIT_USAGE
    assert parse_args(["-x", "f"]) == EXIT_USAGE
    assert parse_args(["a", "b"]) == EXIT_USAGE
    assert parse_args(["--output"]) == EXIT_USAGE


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, data=None, cwd=REPO):
    env = dict(os.environ, BANZAI_BACKEND="numpy")
    return subprocess.run(
        [sys.executable, "-m", "banzai_jax.cli", *args],
        capture_output=True, env=env, cwd=cwd, input=data,
    )


def test_cli_roundtrip(tmp_path, bunzip):
    src = tmp_path / "data.txt"
    payload = b"the quick brown fox " * 200
    src.write_bytes(payload)
    p = _run(["-k", "-1", str(src)])
    assert p.returncode == 0, p.stderr
    out = (tmp_path / "data.txt.bz2").read_bytes()
    assert bunzip(out) == payload
    assert src.exists()          # -k kept the input


def test_cli_deletes_input_by_default(tmp_path):
    src = tmp_path / "g.txt"
    src.write_bytes(b"abc" * 100)
    p = _run(["-1", str(src)])
    assert p.returncode == 0, p.stderr
    assert not src.exists()
    assert (tmp_path / "g.txt.bz2").exists()


def test_cli_output_flag_keeps_input_by_default(tmp_path, bunzip):
    # Reference: default keep iff an output destination was given
    # (bnz/src/main.rs:292-299).
    src = tmp_path / "h.txt"
    src.write_bytes(b"xyz" * 50)
    dst = tmp_path / "h.out"
    p = _run(["-1", "--output", str(dst), str(src)])
    assert p.returncode == 0, p.stderr
    assert src.exists()
    assert bunzip(dst.read_bytes()) == b"xyz" * 50


def test_cli_remove_overrides_output_keep(tmp_path):
    src = tmp_path / "i.txt"
    src.write_bytes(b"qrs" * 50)
    dst = tmp_path / "i.out"
    p = _run(["-1", "-r", "--output", str(dst), str(src)])
    assert p.returncode == 0, p.stderr
    assert not src.exists()


def test_cli_stdin_defaults_to_stdout(bunzip):
    # Reference: stdin input + unspecified output writes to stdout
    # (bnz/src/main.rs:268-285).
    payload = b"stdin to stdout " * 100
    p = _run(["-1", "-"], data=payload)
    assert p.returncode == 0, p.stderr
    assert bunzip(p.stdout) == payload


def test_cli_stdout_flag(bunzip, tmp_path):
    src = tmp_path / "j.txt"
    src.write_bytes(b"stream me " * 40)
    p = _run(["-c", "-1", str(src)])
    assert p.returncode == 0, p.stderr
    assert bunzip(p.stdout) == b"stream me " * 40
    assert src.exists()          # -c counts as an output destination


def test_cli_deletion_failure_exits_3(tmp_path, monkeypatch, capsys):
    # Reference: failed input deletion is an error (bnz/src/main.rs:302-307).
    # Tested in-process (this suite runs as root, so permission bits cannot
    # force an unlink failure in a subprocess).
    import banzai_jax.cli as cli

    monkeypatch.setenv("BANZAI_BACKEND", "numpy")
    src = tmp_path / "k.txt"
    src.write_bytes(b"data" * 30)
    monkeypatch.setattr(
        cli.os, "unlink",
        lambda p: (_ for _ in ()).throw(OSError("unlink denied")),
    )
    rc = cli.main(["-1", str(src)])
    assert rc == EXIT_OUTPUT_IO
    assert "deleting" in capsys.readouterr().err


def test_cli_verbose_emits_block_stats(tmp_path):
    src = tmp_path / "v.txt"
    src.write_bytes(b"verbose me " * 500)
    p = _run(["-v", "-k", "-1", str(src)])
    assert p.returncode == 0, p.stderr
    assert b"block 0:" in p.stderr and b"rle1" in p.stderr


def test_banzai_compat_flag(tmp_path, bunzip):
    """--banzai-compat reproduces the reference model's stream byte-exactly
    (SURVEY §7's exact-size switch)."""
    data = b"compat test " * 400
    p = tmp_path / "in.bin"
    p.write_bytes(data)
    r = _run(["-k", "--banzai-compat", "-1", "-c", str(p)])
    assert r.returncode == 0
    from banzai_jax.oracle import banzai_compress

    assert r.stdout == banzai_compress(data, 1)
    assert bunzip(r.stdout) == data


def test_cli_mid_encode_failure_exits_3_no_partial(tmp_path, monkeypatch, capsys):
    """A non-IO failure mid-encode (e.g. accelerator runtime dying after
    backend selection) must print one clean line, leave NO partial .bz2,
    and exit 3 — the reference's exit-code contract
    (bnz/src/main.rs:11-14).  Reproduced raw-traceback + zero-byte
    partial + exit 1 before the round-5 catch-all."""
    import banzai_jax.cli as cli
    import banzai_jax

    src = tmp_path / "boom.txt"
    src.write_bytes(b"will not survive " * 100)

    def _boom(*a, **kw):
        raise RuntimeError("backend died mid-encode")

    monkeypatch.setattr(banzai_jax, "encode", _boom)
    rc = cli.main(["-k", str(src)])
    assert rc == EXIT_OUTPUT_IO
    err = capsys.readouterr().err
    assert "error during compression" in err
    assert "Traceback" not in err
    assert not (tmp_path / "boom.txt.bz2").exists()


def test_backend_auto_falls_back_when_jax_backend_dead(bunzip):
    """backend="auto" with a jax that imports but cannot init its platform
    must fall back to the NumPy backend and still produce a valid stream
    (a backend that imports but cannot reach its device).  Run in a
    subprocess so the bogus platform doesn't poison this process's jax."""
    code = (
        "import sys\n"
        "from banzai_jax import compress\n"
        "data = b'fallback stream ' * 200\n"
        "out = compress(data, 1, backend='auto')\n"
        "sys.stdout.buffer.write(out)\n"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "bogus_dead_platform"
    env.pop("BANZAI_BACKEND", None)
    env["BANZAI_PROBE_TIMEOUT"] = "30"
    p = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, env=env,
        timeout=180,
    )
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    assert bunzip(p.stdout) == b"fallback stream " * 200
