"""Interactive REPL: port of perceive_tpu/cli/repl.py.  Each line is
shlex-split and re-dispatched through the same argparse tree (reference
crates/perceive-cli/repl.rs:39-116), with persisted readline history and
exit/quit."""

from __future__ import annotations

import shlex
import sys

from ..paths import data_dir


def repl(state, parser) -> None:
    try:
        import readline

        hist = data_dir() / "repl_history"
        try:
            readline.read_history_file(hist)
        except OSError:
            pass
    except ImportError:
        readline = None
        hist = None

    from .main import dispatch

    print("perceive-tpu-torch — type a command, 'help', or 'exit'")
    while True:
        try:
            line = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not line:
            continue
        if line in ("exit", "quit"):
            break
        if line == "help":
            parser.print_help()
            continue
        try:
            argv = shlex.split(line)
        except ValueError as e:
            print(f"parse error: {e}", file=sys.stderr)
            continue
        try:
            args = parser.parse_args(argv)
        except SystemExit:  # argparse errors/help already printed
            continue
        if args.command is None:
            continue
        try:
            dispatch(state, args)
        except KeyboardInterrupt:
            print("^C", file=sys.stderr)
        except SystemExit as e:
            if e.code not in (0, None):
                print(f"error: {e}", file=sys.stderr)
        except Exception as e:  # noqa: BLE001 — the REPL survives command errors
            print(f"error: {e}", file=sys.stderr)

    if readline is not None and hist is not None:
        try:
            readline.write_history_file(hist)
        except OSError:
            pass
