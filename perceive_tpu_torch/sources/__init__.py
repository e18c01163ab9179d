"""Connectors and the ingest pipeline: a port of perceive_tpu/sources with
the JAX package's exports, plus the chunker and its config
(``chunk_token_windows_batch``, ``chunk_config``)."""
from .pipeline import (
    EMBED_BATCH_SIZE,
    build_document,
    chunk_config,
    chunk_token_windows_batch,
    prune_missing_items,
    scan_source,
)
from .scanner import (
    FoundItem,
    ReadResult,
    ScanItem,
    ScanItemState,
    ScanStats,
    SourceScanner,
    create_scanner,
)

__all__ = [
    "EMBED_BATCH_SIZE",
    "FoundItem",
    "ReadResult",
    "ScanItem",
    "ScanItemState",
    "ScanStats",
    "SourceScanner",
    "build_document",
    "chunk_config",
    "chunk_token_windows_batch",
    "create_scanner",
    "prune_missing_items",
    "scan_source",
]
