"""CLI entry: ``python -m perceive_tpu_torch.cli [--db PATH] [COMMAND ...]``.

Port of perceive_tpu/cli/main.py: the argparse command tree and its
dispatch, with the JAX package's flags and defaults.  No command starts the
REPL (reference main.rs:28-31), which re-dispatches lines through this same
tree (repl.rs:104-116).  ``doctor`` and ``app --install`` build no AppState;
every other command builds one on ``cuda:0`` and raises without CUDA.
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


def nonnegative_float(v: str) -> float:
    f = float(v)
    if f < 0:
        raise argparse.ArgumentTypeError("must be >= 0")
    return f


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="perceive-tpu-torch", description="Semantic search for your life, on a GPU"
    )
    p.add_argument("--db", help="database path (default: data dir)")
    sub = p.add_subparsers(dest="command")

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
    pq.add_argument("--type", choices=["local", "web", "bookmarks"])
    pq.add_argument("--like", help="item id: find items similar to this one")
    pq.add_argument("--json", action="store_true", help="machine-readable output")
    pq.add_argument("--tag", help="restrict to items carrying this tag")
    pq.add_argument(
        "--after",
        help="only items modified at/after this time (7d, 12h, 2026-01-15, unix epoch)",
    )
    pq.add_argument("--before", help="only items modified before this time (same forms)")
    pq.add_argument(
        "--sort", choices=["score", "time"], default="score",
        help="order the top results by relevance (default) or recency",
    )

    # print / hide
    pp = sub.add_parser("print", help="print an item")
    pp.add_argument("item_id")
    pp.add_argument("--raw", action="store_true")

    ph = sub.add_parser("hide", help="hide (or unhide) an item from results")
    ph.add_argument("item_id")
    ph.add_argument("--unhide", action="store_true")

    # tag
    pt = sub.add_parser("tag", help="tag items")
    tsub = pt.add_subparsers(dest="tag_action", required=True)
    pta = tsub.add_parser("add")
    pta.add_argument("item_id")
    pta.add_argument("tag_name")
    ptr = tsub.add_parser("rm")
    ptr.add_argument("item_id")
    ptr.add_argument("tag_name")
    tsub.add_parser("list")

    # model
    pm = sub.add_parser("model", help="model registry")
    msub = pm.add_subparsers(dest="model_action", required=True)
    msub.add_parser("list")
    pms = msub.add_parser("set")
    pms.add_argument("model_name")

    # import-db
    pimp = sub.add_parser(
        "import-db",
        help="import a reference perceive (or perceive-tpu) database: "
        "items + embeddings transfer without re-scanning or re-embedding",
    )
    pimp.add_argument("path", help="path to the source SQLite database")

    # doctor: environment self-check (no model load / device matrix)
    sub.add_parser(
        "doctor",
        help="check the environment: GPU, kernel build, checkpoints, native deps, db",
    )

    # snapshot / stats
    psnap = sub.add_parser("snapshot", help="save the device matrix for fast startup")
    psnap.add_argument("path", nargs="?", default=None)
    sub.add_parser("stats", help="index statistics")

    # serve
    pserve = sub.add_parser("serve", help="HTTP API (status/sources/search)")
    pserve.add_argument("--host", default="127.0.0.1")
    pserve.add_argument("--port", type=int, default=5807)
    pserve.add_argument(
        "--refresh", type=positive_float, default=None, metavar="SECONDS",
        help="background rescan of due sources every SECONDS while serving "
        "(sources without an index_interval rescan every tick)",
    )
    pserve.add_argument(
        "--prune", action="store_true",
        help="with --refresh: also remove items that vanished from sources",
    )

    # app: the desktop-app analog (reference perceive-tauri): serve and open
    # the embedded search UI in the system browser once models are loaded
    papp = sub.add_parser("app", help="desktop app: serve and open the search UI when ready")
    papp.add_argument("--host", default="127.0.0.1")
    papp.add_argument("--port", type=int, default=5807)
    papp.add_argument(
        "--refresh", type=nonnegative_float, default=900.0, metavar="SECONDS",
        help="background rescan of due sources (default 900; 0 disables)",
    )
    papp.add_argument("--prune", action="store_true", help="with --refresh: remove items that vanished")
    papp.add_argument("--no-browser", action="store_true", help="don't open the browser (just serve)")
    papp.add_argument(
        "--install", action="store_true",
        help="install a desktop launcher entry instead of starting the app",
    )
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


_COMMANDS = {
    "refresh": commands.refresh,
    "search": commands.search,
    "print": commands.print_item,
    "hide": commands.hide,
    "tag": commands.tag_cmd,
    "model": commands.model_cmd,
    "import-db": commands.import_db,
    "snapshot": commands.snapshot_cmd,
    "stats": commands.stats_cmd,
}


def dispatch(state, args) -> None:
    cmd = args.command
    if cmd == "source":
        _SOURCE_COMMANDS[args.source_command](state, args)
    elif cmd in _COMMANDS:
        _COMMANDS[cmd](state, args)
    elif cmd == "doctor":  # also reachable through the REPL
        from .doctor import doctor

        db = getattr(state, "db", None)
        doctor(getattr(args, "db", None) or (db.path if db else None))
    elif cmd == "serve":
        from ..serve import serve

        serve(state, host=args.host, port=args.port, refresh_interval=args.refresh, refresh_prune=args.prune)
    elif cmd == "app":
        if args.install:  # also reachable through the REPL
            from .desktop import install_desktop_entry

            print(install_desktop_entry())
            return
        from ..serve import serve

        serve(
            state, host=args.host, port=args.port,
            refresh_interval=args.refresh or None, refresh_prune=args.prune,
            open_browser=not args.no_browser,
        )


def main(argv: Optional[Sequence[str]] = None, state=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.command == "app" and args.install:
        # a plain file write: no model load, no device
        from .desktop import install_desktop_entry

        print(install_desktop_entry())
        return 0

    if args.command == "doctor":
        # independent checks, no AppState: the doctor must work precisely
        # when the app doesn't (missing checkpoints, no GPU, a bad db)
        from .doctor import doctor

        return doctor(args.db)

    if state is None:
        from .state import AppState

        state = AppState(args.db)
    try:
        if args.command is None:
            from .repl import repl

            repl(state, parser)
        else:
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
