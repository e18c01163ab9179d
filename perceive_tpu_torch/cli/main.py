"""CLI entry: ``python -m perceive_tpu_torch.cli [--db PATH] COMMAND ...``.

Port of perceive_tpu/cli/main.py, holding the ``source`` subcommands
(add fs|browser-history|bookmarks, list, scan, reprocess, rebuild-search,
remove, edit), ``refresh``, ``search`` and ``snapshot``, with the JAX
package's flags and defaults.  The other subcommands are later work
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from . import commands

COMPARE_CHOICES = ["m_time_and_content", "m_time", "content", "force"]


def positive_float(v: str) -> float:
    f = float(v)
    if f <= 0:
        raise argparse.ArgumentTypeError("must be > 0")
    return f


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="perceive-tpu-torch", description="Semantic search for your life, on a GPU"
    )
    p.add_argument("--db", help="database path (default: data dir)")
    sub = p.add_subparsers(dest="command", required=True)

    # source
    ps = sub.add_parser("source", help="manage sources")
    ssub = ps.add_subparsers(dest="source_command", required=True)

    pa = ssub.add_parser("add", help="add a source")
    asub = pa.add_subparsers(dest="source_type", required=True)
    for kind, loc_help in (
        ("fs", "root directory to index"),
        ("browser-history", "Chromium profile dir containing History"),
        ("bookmarks", "Chromium profile dir containing Bookmarks"),
    ):
        pk = asub.add_parser(kind)
        pk.add_argument("location", help=loc_help)
        pk.add_argument("--name", required=True)
        pk.add_argument("--compare-strategy", choices=COMPARE_CHOICES, default="m_time_and_content")
        pk.add_argument(
            "--chunk-tokens", type=int, default=None,
            help="embed long documents as overlapping N-token chunks "
                 "(default: the model's max sequence budget; 0 = truncate)",
        )
        if kind == "fs":
            pk.add_argument("--glob", action="append", help="filename glob (repeatable)")
        else:
            pk.add_argument("--skip", action="append", help="domain suffix to skip (repeatable)")

    ssub.add_parser("list", help="list sources")

    pscan = ssub.add_parser("scan", help="scan a source")
    pscan.add_argument("name")
    pscan.add_argument("--force", action="store_true", help="re-read and re-embed everything")
    pscan.add_argument("--by-content", action="store_true", help="compare by content only")
    pscan.add_argument("--prune", action="store_true", help="delete items that vanished")

    pre = ssub.add_parser("reprocess", help="re-run content post-processing")
    pre.add_argument("name")

    prb = ssub.add_parser("rebuild-search", help="rebuild one source's index rows")
    prb.add_argument("name")

    prm = ssub.add_parser("remove", help="delete a source and its items")
    prm.add_argument("name")
    prm.add_argument("--yes", action="store_true", help="confirm deletion")

    ped = ssub.add_parser("edit", help="edit a source")
    ped.add_argument("name")
    ped.add_argument("--new-name")
    ped.add_argument("--interval", type=int, help="seconds between auto-refresh scans (0 clears)")
    ped.add_argument("--compare-strategy", choices=COMPARE_CHOICES)
    ped.add_argument("--glob", action="append")
    ped.add_argument("--skip", action="append")

    # refresh
    pr = sub.add_parser("refresh", help="scan every due source")
    pr.add_argument("--prune", action="store_true")
    pr.add_argument(
        "--watch", type=positive_float, default=None, metavar="SECONDS",
        help="keep running, re-checking due sources on this cadence",
    )
    pr.add_argument(
        "--due-only", action="store_true",
        help="one-shot: scan only sources whose index_interval elapsed",
    )

    # search
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

    # snapshot
    psnap = sub.add_parser("snapshot", help="save the device matrix for fast startup")
    psnap.add_argument("path", nargs="?", default=None)
    return p


_SOURCE_COMMANDS = {
    "add": commands.source_add,
    "list": commands.source_list,
    "scan": commands.source_scan,
    "reprocess": commands.source_reprocess,
    "rebuild-search": commands.source_rebuild_search,
    "remove": commands.source_remove,
    "edit": commands.source_edit,
}


def dispatch(state, args) -> None:
    if args.command == "source":
        _SOURCE_COMMANDS[args.source_command](state, args)
    elif args.command == "refresh":
        commands.refresh(state, args)
    elif args.command == "search":
        commands.search(state, args)
    elif args.command == "snapshot":
        commands.snapshot_cmd(state, args)


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
