"""CLI command handlers (the ``search`` command of perceive_tpu/cli/commands.py)."""

from __future__ import annotations

import json
import sys
from typing import Optional

from ..index.searcher import SearchResult

BOLD = "\x1b[1m"
RESET = "\x1b[0m"


def item_time(item) -> Optional[int]:
    """The item's mtime, falling back to its atime (None when neither)."""
    m = item.metadata
    return m.mtime if m.mtime is not None else m.atime


def _resolve_source_filter(state, args) -> Optional[list[int]]:
    """--source NAME -> [source id]; None for no filter."""
    if not getattr(args, "source", None):
        return None
    src = state.source_by_name(args.source)
    if src is None:
        raise SystemExit(f"No source named {args.source}")
    return [src.id]


def format_result(r: SearchResult, highlight: Optional[str]) -> str:
    title = r.item.metadata.name or r.item.external_id
    lines = [f"{r.source_name} ({r.item.id}): {BOLD}{title}{RESET}  [{r.score:.4f}]"]
    if highlight:
        lines.append("  " + highlight.replace("\n", " • "))
    return "\n".join(lines)


def search(state, args) -> list[SearchResult]:
    if state.searcher is None:
        print("searcher not built", file=sys.stderr)
        return []
    source_ids = _resolve_source_filter(state, args)
    k = args.num_results
    hl_q = None  # highlight-model query embedding, from the fused search
    if getattr(args, "like", None):
        vec = state.searcher.stored_embedding(state.db, int(args.like))
        if vec is None:
            raise SystemExit(f"item {args.like} has no stored embedding")
        results = state.searcher.search_vector_and_retrieve(state.db, vec, k, source_ids)
    else:
        query = " ".join(args.query)
        if not query:
            raise SystemExit("search needs a query or --like <item-id>")
        hits, hl_q = state.searcher.search_fused(
            state.model, query, k, source_ids, aux_model=state.highlights_model
        )
        results = state.searcher.retrieve(state.db, hits)
    results = results[:k]

    docs = [r.item.content or "" for r in results]
    query_text = " ".join(args.query) if args.query else ""
    highlights = (
        state.highlights_model.highlight(query_text, docs, query_emb=hl_q)
        if query_text and docs
        else [None] * len(docs)
    )
    for r, h in zip(results, highlights):
        r.highlight = h
    if getattr(args, "json", False):
        print(
            json.dumps(
                [
                    {
                        "id": r.item.id,
                        "score": r.score,
                        "title": r.item.metadata.name,
                        "url": r.item.external_id,
                        "source": r.source_name,
                        "snippet": r.highlight,
                        "time": item_time(r.item),
                    }
                    for r in results
                ]
            )
        )
    else:
        for r in results:
            print(format_result(r, r.highlight))
    return results
