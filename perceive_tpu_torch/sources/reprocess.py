"""A copy of perceive_tpu/sources/reprocess.py.

Reprocess pipeline: re-run content post-processing over stored raw bytes
(improved HTML extraction etc.) without re-fetching, then re-embed.

Structure parity with the reference (crates/perceive-core/
sources/pipeline/reprocess.rs:85-138): read rows -> parallel
scanner.reprocess -> embed -> write, reusing the scan pipeline's embed and
write stages.  Only items whose reprocess returned Found (content changed)
are re-embedded and written, as CHANGED.  The reference needed a dedicated
rayon pool to dodge a tokenizer deadlock (reprocess.rs:52-55); plain Python
threads have no such interaction with the HF tokenizer.
"""

from __future__ import annotations

import queue
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from ..db import ITEM_COLUMNS, Database, deserialize_item_row
from ..types import Source
from .pipeline import (
    EMBED_BATCH_SIZE,
    _SENTINEL,
    _drain_queue,
    _embed_stage,
    _Stage,
    _write_stage,
    chunk_config,
)
from .scanner import ReadResult, ScanItem, ScanItemState, ScanStats, create_scanner

REPROCESS_PARALLELISM = 8


def reprocess_source(
    db: Database,
    model,
    source: Source,
    *,
    stats: Optional[ScanStats] = None,
    scanner=None,
    on_embeddings: Optional[Callable] = None,
    on_removed: Optional[Callable] = None,
    embed_batch_size: int = EMBED_BATCH_SIZE,
) -> tuple[ScanStats, bool]:
    stats = stats or ScanStats()
    scanner = scanner or create_scanner(source)
    # same FK precondition as scan_source: register non-zero model versions
    db.ensure_model_version(model.model_id, model.model_version)
    from ..models.model import BATCH_BUCKETS

    embed_batch_size = min(embed_batch_size, BATCH_BUCKETS[-1])  # dispatch limit
    errors: list = []

    q_rows: queue.Queue = queue.Queue(16)
    q_processed: queue.Queue = queue.Queue(embed_batch_size)
    q_embedded: queue.Queue = queue.Queue(8)

    def read_rows():
        """(reference reprocess.rs:19-44)"""
        cur = db.read().execute(
            f"SELECT {ITEM_COLUMNS} FROM items WHERE source_id = ? AND skipped IS NULL",
            (source.id,),
        )
        batch = []
        for row in cur:
            batch.append(deserialize_item_row(row))
            stats.scanned.add()
            if len(batch) >= EMBED_BATCH_SIZE:
                q_rows.put(batch)
                batch = []
        if batch:
            q_rows.put(batch)

    def process():
        """(reference reprocess.rs:46-83)"""
        with ThreadPoolExecutor(max_workers=REPROCESS_PARALLELISM) as pool:

            def one(item):
                stats.reading.add()
                try:
                    result = scanner.reprocess(item)
                except Exception as e:  # noqa: BLE001 — per-item isolation
                    print(f"{item.external_id}: reprocess error {e}", file=sys.stderr)
                    return
                finally:
                    stats.reading.sub()
                if result is ReadResult.FOUND:
                    stats.fetched.add()
                    q_processed.put(ScanItem(state=ScanItemState.CHANGED, item=item))

            for batch in _drain_queue(q_rows):
                list(pool.map(one, batch))

    t_read = _Stage("read_rows", read_rows, None, errors)
    t_proc = _Stage("reprocess", process, q_rows, errors)
    chunk_tokens, chunk_overlap = chunk_config(source, model.tokenizer)
    t_embed = _Stage(
        "embed",
        lambda: _embed_stage(
            stats, model, q_processed, q_embedded, embed_batch_size,
            chunk_tokens, chunk_overlap,
        ),
        q_processed,
        errors,
    )
    t_write = _Stage(
        "update_db",
        lambda: _write_stage(
            stats,
            db,
            model.model_id,
            model.model_version,
            source.index_version,
            q_embedded,
            on_embeddings,
            on_removed,
        ),
        q_embedded,
        errors,
    )
    for t in (t_read, t_proc, t_embed, t_write):
        t.start()
    t_read.join()
    q_rows.put(_SENTINEL)
    t_proc.join()
    q_processed.put(_SENTINEL)
    t_embed.join()
    q_embedded.put(_SENTINEL)
    t_write.join()
    return stats, not errors
