"""bnz-compatible CLI (reference: bnz/src/main.rs).

Flags (bnz/src/main.rs:32-59): ``--output <path>``, ``-c/--stdout``,
``-k/--keep``, ``-r/--remove``, ``-1``..``-9``, ``--fast``/``--best``,
``-v/--verbose`` (dead in the reference; here it prints real per-block
statistics), ``-`` for stdin, ``--`` end-of-flags, combined short flags
(``-kc9``), ``--help/--info/--version``.

Behavior: default level 9 (bnz/src/main.rs:165-170); default output
``<input>.bz2`` for file input and stdout for stdin input
(bnz/src/main.rs:268-285); input kept iff an output destination was given
unless ``-k``/``-r`` override, and deletion failure exits 3
(bnz/src/main.rs:292-309).  Exit codes 0/1/2/3 (bnz/src/main.rs:11-14).
The encode streams through the library's bounded-memory ``encode()``
(never slurps the input), matching the reference's BufReader/BufWriter
wiring (bnz/src/main.rs:259-287).
"""

from __future__ import annotations

import os
import sys

EXIT_OK = 0
EXIT_USAGE = 1
EXIT_INPUT_IO = 2
EXIT_OUTPUT_IO = 3

_HELP = """usage: bnz [flags] [--output <path>] <input|->

Compress a file to the bzip2 format on a GPU (JAX/XLA).

flags:
  -c, --stdout     write to standard output
  -k, --keep       keep the input file
  -r, --remove     remove the input file (default unless --output/-c/-k)
  -1 .. -9         block size 100kB..900kB (default 9)
      --fast       alias for -1
      --best       alias for -9
  -v, --verbose    per-block statistics to stderr
  --banzai-compat  reproduce the reference banzai's output byte-exactly
                   (quirk-exact model; larger and slower than the default)
      --output P   write to P
      --help       this message
      --info       about this program
      --version    version string
"""

_INFO = (
    "banzai_jax: a bzip2 encoder whose per-block pipeline runs on the GPU\n"
    "(JAX/XLA).\n"
    "Linear-work pipeline: RLE1 -> rotation-sort BWT -> chunk-parallel MTF\n"
    "-> RLE2 -> package-merge Huffman -> prefix-sum bit packing.\n"
)


class Invocation:
    def __init__(self) -> None:
        self.input: str | None = None
        self.output: str | None = None
        self.stdout = False
        # tri-state like the reference's Option<bool> (bnz/src/main.rs:122):
        # None = default policy, True = -k, False = -r (last flag wins).
        self.keep_inf: bool | None = None
        self.verbose = False
        self.banzai_compat = False
        self.level: int | None = None


def parse_args(argv: list[str]) -> Invocation | int:
    inv = Invocation()
    expect_output = False
    no_more_flags = False
    for arg in argv:
        if expect_output:
            inv.output = arg
            expect_output = False
            continue
        if not no_more_flags and arg == "--":
            no_more_flags = True
            continue
        if not no_more_flags and arg.startswith("--"):
            name = arg[2:]
            if name == "help":
                print(_HELP, end="")
                return EXIT_OK
            if name == "info":
                print(_INFO, end="")
                return EXIT_OK
            if name == "version":
                from . import __version__

                print(f"banzai_jax {__version__}")
                return EXIT_OK
            if name == "output":
                expect_output = True
            elif name == "stdout":
                inv.stdout = True
            elif name == "keep":
                inv.keep_inf = True
            elif name == "remove":
                inv.keep_inf = False
            elif name == "verbose":
                inv.verbose = True
            elif name == "banzai-compat":
                inv.banzai_compat = True
            elif name == "fast":
                inv.level = 1
            elif name == "best":
                inv.level = 9
            else:
                print(f"bnz: unknown flag --{name}", file=sys.stderr)
                return EXIT_USAGE
            continue
        if not no_more_flags and arg.startswith("-") and arg != "-":
            for ch in arg[1:]:
                if ch == "c":
                    inv.stdout = True
                elif ch == "k":
                    inv.keep_inf = True
                elif ch == "r":
                    inv.keep_inf = False
                elif ch == "v":
                    inv.verbose = True
                elif ch.isdigit() and ch != "0":
                    inv.level = int(ch)
                else:
                    print(f"bnz: unknown flag -{ch}", file=sys.stderr)
                    return EXIT_USAGE
            continue
        if inv.input is not None:
            print("bnz: multiple inputs specified", file=sys.stderr)
            return EXIT_USAGE
        inv.input = arg
    if expect_output:
        print("bnz: --output requires a path", file=sys.stderr)
        return EXIT_USAGE
    if inv.input is None:
        print("bnz: no input specified (use - for stdin)", file=sys.stderr)
        return EXIT_USAGE
    if inv.level is None:
        inv.level = 9
    return inv


class _InputIOError(Exception):
    """Read-side failure, tagged so it maps to exit 2 (input IO) instead
    of the output-IO handler catching the same OSError type."""


class _TaggedReader:
    """Wrap the input stream so read errors are distinguishable from
    write errors inside the shared encode() loop."""

    def __init__(self, f):
        self._f = f

    def read(self, n: int = -1):
        try:
            return self._f.read(n)
        except OSError as e:
            raise _InputIOError(str(e)) from e


def main(argv: list[str] | None = None) -> int:
    inv = parse_args(sys.argv[1:] if argv is None else argv)
    if isinstance(inv, int):
        return inv

    from . import encode

    # Open the reader (bnz/src/main.rs:259-266): stream, never slurp.
    if inv.input == "-":
        reader = sys.stdin.buffer
        close_reader = False
    else:
        try:
            reader = open(inv.input, "rb")
        except OSError as e:
            print(f"bnz: cannot read {inv.input}: {e}", file=sys.stderr)
            return EXIT_INPUT_IO
        close_reader = True

    # Open the writer (bnz/src/main.rs:268-285): unspecified output means
    # <input>.bz2 for file input and STDOUT for stdin input.
    out_path: str | None = None
    if not inv.stdout and (inv.output is not None or inv.input != "-"):
        out_path = inv.output if inv.output is not None else inv.input + ".bz2"
        # Refuse input == output: opening 'wb' would truncate the input
        # before the first read and destroy the user's data (bzip2 guards
        # the same way).
        try:
            same = inv.input != "-" and os.path.exists(out_path) and (
                os.path.samefile(inv.input, out_path)
            )
        except OSError:
            same = False
        if same:
            print(
                f"bnz: input file {inv.input} is the same as output file "
                f"{out_path}", file=sys.stderr,
            )
            if close_reader:
                reader.close()
            return EXIT_OUTPUT_IO
        try:
            writer = open(out_path, "wb")
        except OSError as e:
            print(f"bnz: cannot write {out_path}: {e}", file=sys.stderr)
            if close_reader:
                reader.close()
            return EXIT_OUTPUT_IO
    else:
        writer = sys.stdout.buffer
    close_writer = out_path is not None

    report = None
    if inv.verbose:
        from .profiling import EncodeReport

        report = EncodeReport(level=inv.level)

    def _drop_partial() -> None:
        # A mid-stream failure leaves a truncated .bz2 that only fails at
        # decompress time; remove it like bzip2 does (file outputs only).
        if out_path is not None:
            try:
                writer.close()
            except Exception:
                pass
            try:
                os.unlink(out_path)
            except OSError:
                pass

    try:
        if inv.banzai_compat:
            # SURVEY §7's exact-size switch: route through the quirk-exact
            # reference model (oracle/banzai_model) — byte-identical to
            # the reference banzai's stream, including its Huffman quirks.
            from .oracle import banzai_compress

            writer.write(
                banzai_compress(_TaggedReader(reader).read(), inv.level)
            )
        else:
            encode(_TaggedReader(reader), writer, inv.level, report=report)
        if not close_writer:
            writer.flush()
    except BrokenPipeError:
        # Reader went away (e.g. `bnz -c x | head`); mirror bzip2's quiet
        # exit instead of a traceback.
        try:
            sys.stdout.close()
        except Exception:
            pass
        return EXIT_OUTPUT_IO
    except _InputIOError as e:
        # Read-side failure: input-IO exit code (see module docstring).
        print(f"bnz: cannot read {inv.input}: {e}", file=sys.stderr)
        _drop_partial()
        return EXIT_INPUT_IO
    except OSError as e:
        # Compression/IO failure mid-stream (bnz/src/main.rs:287-290).
        print(f"bnz: error during compression: {e}", file=sys.stderr)
        _drop_partial()
        return EXIT_OUTPUT_IO
    except KeyboardInterrupt:
        _drop_partial()
        raise
    except Exception as e:
        # Non-IO failure mid-encode (e.g. an accelerator runtime dying
        # after backend selection): same contract as an IO failure — one
        # clean line, no partial output file, exit 3.  Without this, a
        # RuntimeError printed a traceback, left a truncated .bz2 behind,
        # and exited 1 (EXIT_USAGE's code) — violating the exit-code
        # fidelity promised above (bnz/src/main.rs:11-14).
        print(f"bnz: error during compression: {e}", file=sys.stderr)
        _drop_partial()
        return EXIT_OUTPUT_IO
    finally:
        if close_reader:
            reader.close()
        if close_writer:
            try:
                writer.close()
            except OSError as e:
                # A buffered flush can fail only here (e.g. ENOSPC):
                # report it as an output-IO error, not a traceback.
                print(
                    f"bnz: error during compression: {e}", file=sys.stderr
                )
                return EXIT_OUTPUT_IO

    if report is not None:
        print(report.summary(), file=sys.stderr)

    # Input deletion policy (bnz/src/main.rs:292-309): default keeps the
    # input only when an output destination was explicitly given (--output
    # or -c); -k/-r override.  Deletion failure is an error (exit 3).
    keep = inv.keep_inf
    if keep is None:
        keep = inv.stdout or inv.output is not None
    if not keep and inv.input != "-":
        try:
            os.unlink(inv.input)
        except OSError as e:
            print(f"bnz: error deleting input file: {e}", file=sys.stderr)
            return EXIT_OUTPUT_IO
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
