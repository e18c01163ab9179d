"""CLI application state: database + models + searcher on one CUDA device.

Port of perceive_tpu/cli/state.py.  The main model defaults to
MsMarcoBertBaseDotV5 and highlights to AllMiniLmL6V2, overridable through
the ``config`` table's "model" key.  Without a checkpoint on disk the CLI
falls back to a deterministic random-weight MiniLM-class encoder, with a
warning (PERCEIVE_TPU_REQUIRE_CHECKPOINT=1 fails instead).  Its weights
come from a torch.Generator, so they differ from the JAX package's fallback
weights: vectors written by one package's fallback do not rank
meaningfully under the other's.

PERCEIVE_TPU_MATRIX_DTYPE: ``auto`` (default) follows the JAX package's
auto rule: bf16 up to 1.5M effective rows (rows x padded_dim / 384), int8
up to 4M, int2 (coarse-to-fine with an int8 or int4 companion) up to 24M,
then packed int4; ``bfloat16``/``bf16``, ``float32``/``f32``, ``int8``,
``int4`` and ``int2`` pin a tier.  Any other value raises ValueError.

The device is explicit and defaults to ``cuda:0``; a missing GPU is an
error, never a silent move to the CPU.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

import torch

from ..db import Database, list_sources
from ..index.matrix import CHUNK_STRIDE, INT2, INT4, LANE_ALIGN, _round_up, auto_matrix_dtype
from ..index.searcher import Searcher
from ..models import Model, ModelError, ModelType
from ..paths import database_path
from ..types import Source

DEFAULT_MODEL = ModelType.MSMARCO_BERT_BASE_DOT_V5
DEFAULT_HIGHLIGHT_MODEL = ModelType.ALL_MINILM_L6_V2
DEFAULT_DEVICE = "cuda:0"

# reserved model_version of the random-weight fallback encoder (its own
# keyspace, never the real checkpoint's version 0)
RANDOM_FALLBACK_VERSION = 1_000_000_000

_TIERS = {
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "f32": torch.float32,
    "int8": torch.int8,
    "int4": INT4,
    "int2": INT2,
}


def resolve_device(device: torch.device | str) -> torch.device:
    """The device to serve on; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available "
            "(pass device='cpu' explicitly to run on the CPU)"
        )
    return dev


def _random_fallback(model_type: ModelType, device: torch.device) -> Model:
    from ..models import EncoderArch, HeadConfig, TextTokenizer
    from ..models.tokenize import tiny_test_vocab

    print(
        f"WARNING: no checkpoint for {model_type.value}; using a random-weight "
        "MiniLM-class encoder (rankings are not meaningful). Place a "
        "sentence-transformers export under model_data/ for real embeddings.",
        file=sys.stderr,
    )
    vocab = tiny_test_vocab(["the", "a", "and", "search", "semantic"])
    tok = TextTokenizer.from_vocab(vocab, max_seq_length=128)
    arch = EncoderArch(
        vocab_size=len(vocab), hidden_size=128, num_layers=2, num_heads=4,
        intermediate_size=256, max_position_embeddings=128,
    )
    m = Model.random(arch, HeadConfig(pooling="mean", normalize=True), tok, seed=0, device=device)
    m.model_id = model_type.model_id
    m.model_version = RANDOM_FALLBACK_VERSION
    m.name = f"random-fallback:{model_type.value}"
    return m


def load_model(model_type: ModelType, device: torch.device) -> Model:
    try:
        return Model.new_pretrained(model_type, device=device)
    except (ModelError, FileNotFoundError):
        if os.environ.get("PERCEIVE_TPU_REQUIRE_CHECKPOINT"):
            raise
        return _random_fallback(model_type, device)


def storage_tier(choice: str, n_rows: int, padded_dim: int):
    """The matrix dtype (bf16, f32, int8, INT4 or INT2) for a
    PERCEIVE_TPU_MATRIX_DTYPE value."""
    choice = choice.lower()
    if choice == "auto":
        return auto_matrix_dtype(n_rows, padded_dim)
    if choice in _TIERS:
        return _TIERS[choice]
    raise ValueError(f"unknown PERCEIVE_TPU_MATRIX_DTYPE {choice!r}")


class AppState:
    def __init__(
        self,
        db_path: Optional[str] = None,
        *,
        model: Optional[Model] = None,
        highlights_model: Optional[Model] = None,
        device: torch.device | str = DEFAULT_DEVICE,
        build_searcher: bool = True,
    ):
        self.device = resolve_device(device)
        self.db = Database(db_path or database_path())
        cfg_model = self.db.read().execute("SELECT value FROM config WHERE key = 'model'").fetchone()
        model_type = ModelType.parse(cfg_model[0]) if cfg_model else DEFAULT_MODEL

        results: dict = {}
        load_errors: list = []

        def capture(key, fn):
            def run():
                try:
                    results[key] = fn()
                except BaseException as e:  # re-raised on the main thread
                    load_errors.append(e)

            return run

        # the configured main model IS the highlight default: share one
        share_main = highlights_model is None and model is None and model_type == DEFAULT_HIGHLIGHT_MODEL

        def load_highlight():
            if highlights_model is not None:
                return highlights_model
            if model is not None:
                return model
            return load_model(DEFAULT_HIGHLIGHT_MODEL, self.device)

        threads = [threading.Thread(target=capture("model", lambda: model or load_model(model_type, self.device)))]
        if not share_main:
            threads.append(threading.Thread(target=capture("highlights", load_highlight)))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if load_errors:
            raise load_errors[0]
        self.model: Model = results["model"]
        self.highlights_model: Model = results["model" if share_main else "highlights"]
        self._quarantine_legacy_fallback_rows()

        self.searcher: Optional[Searcher] = None
        if build_searcher:
            choice = os.environ.get("PERCEIVE_TPU_MATRIX_DTYPE", "auto").lower()
            n_rows = 0
            if choice == "auto":
                # counted with the same filters the searcher build uses
                n_rows = self.db.read().execute(
                    f"""SELECT COUNT(*) FROM item_embeddings ie
                        JOIN items ON items.id = ie.item_id
                        WHERE ie.model_id=? AND ie.model_version=?
                          AND ie.chunk_idx < {CHUNK_STRIDE}
                          AND items.skipped IS NULL
                          AND items.hidden_at IS NULL""",
                    (self.model.model_id, self.model.model_version),
                ).fetchone()[0]
            dtype = storage_tier(choice, n_rows, _round_up(self.model.dim, LANE_ALIGN))
            start = time.time()
            self.searcher = Searcher.build(
                self.db, self.model.model_id, self.model.model_version, self.model.dim,
                device=self.device, dtype=dtype,
            )
            self.searcher.auto_retier = choice == "auto"
            if len(self.searcher.matrix):
                print(f"Built search in {time.time() - start:.1f} seconds", file=sys.stderr)
        self.sources: list[Source] = list_sources(self.db)

    def _quarantine_legacy_fallback_rows(self) -> None:
        """Once per (model, version, dim): delete embeddings under this
        model's keyspace whose BLOB length is not this model's width (rows a
        random-weight fallback wrote before it had its own version).  The
        COUNT runs inside the same write transaction as the DELETE."""
        if self.model.model_version == RANDOM_FALLBACK_VERSION:
            return
        want_len = 4 * self.model.dim
        marker = f"quarantined:{self.model.model_id}:{self.model.model_version}:{self.model.dim}"
        if self.db.read().execute("SELECT 1 FROM config WHERE key = ?", (marker,)).fetchone():
            return
        with self.db.write() as conn:
            n_bad = conn.execute(
                """SELECT COUNT(*) FROM item_embeddings
                   WHERE model_id = ? AND model_version = ? AND LENGTH(embedding) != ?""",
                (self.model.model_id, self.model.model_version, want_len),
            ).fetchone()[0]
            if n_bad:
                print(
                    f"Quarantining {n_bad} wrong-dim embeddings under model "
                    f"{self.model.model_id} v{self.model.model_version} "
                    f"(expected {self.model.dim}-dim); re-scan sources to re-embed those items.",
                    file=sys.stderr,
                )
                conn.execute(
                    """DELETE FROM item_embeddings
                       WHERE model_id = ? AND model_version = ? AND LENGTH(embedding) != ?""",
                    (self.model.model_id, self.model.model_version, want_len),
                )
            conn.execute("INSERT OR REPLACE INTO config (key, value) VALUES (?, '1')", (marker,))

    def refresh_sources(self) -> None:
        self.sources = list_sources(self.db)

    def source_by_name(self, name: str) -> Optional[Source]:
        for s in self.sources:
            if s.name == name or str(s.id) == name:
                return s
        return None

    def close(self) -> None:
        self.db.close()
