"""CLI entry: ``python -m perceive_tpu_torch.cli [--db PATH] search QUERY``.

Port of perceive_tpu/cli/main.py, holding the ``search`` subcommand only
(the others are later work, ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from . import commands


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="perceive-tpu-torch", description="Semantic search for your life, on a GPU"
    )
    p.add_argument("--db", help="database path (default: data dir)")
    sub = p.add_subparsers(dest="command", required=True)

    pq = sub.add_parser("search", help="semantic search")
    pq.add_argument("query", nargs="*")

    def result_count(v: str) -> int:
        from ..index.searcher import MAX_K

        n = int(v)
        if not 1 <= n <= MAX_K:
            raise argparse.ArgumentTypeError(f"must be in [1, {MAX_K}]")
        return n

    pq.add_argument("-n", "--num-results", type=result_count, default=20)
    pq.add_argument("--source", help="restrict to one source by name")
    pq.add_argument("--like", help="item id: find items similar to this one")
    pq.add_argument("--json", action="store_true", help="machine-readable output")
    return p


def dispatch(state, args) -> None:
    if args.command == "search":
        commands.search(state, args)


def main(argv: Optional[Sequence[str]] = None, state=None) -> int:
    args = build_parser().parse_args(argv)
    if state is None:
        from .state import AppState

        state = AppState(args.db)
    try:
        dispatch(state, args)
    except SystemExit as e:
        if e.code in (0, None):
            return 0
        if isinstance(e.code, int):
            return e.code
        print(f"error: {e.code}", file=sys.stderr)  # commands raise messages
        return 1
    except Exception as e:  # noqa: BLE001 — one-line errors, as the JAX CLI
        if os.environ.get("PERCEIVE_TPU_DEBUG"):
            raise
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
