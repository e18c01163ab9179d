"""Supported sentence-embedding model registry.

A copy of perceive_tpu/models/registry.py (that module is jax-free, but it
sits behind an ``__init__`` that imports jax).  The stable integer
``model_id`` of each type keys embedding rows in the store, so both
packages must agree on it; each entry names the sentence-transformers
checkpoint directory that ``convert.load_sentence_transformer`` reads.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from pathlib import Path
from typing import Optional


class ModelType(enum.Enum):
    ALL_MINILM_L6_V2 = "AllMiniLmL6V2"
    ALL_MINILM_L12_V2 = "AllMiniLmL12V2"
    DISTILUSE_BASE_MULTILINGUAL_CASED = "DistiluseBaseMultilingualCased"
    ALL_DISTILROBERTA_V1 = "AllDistilrobertaV1"
    PARAPHRASE_ALBERT_SMALL_V2 = "ParaphraseAlbertSmallV2"
    MSMARCO_DISTILBERT_DOT_V5 = "MsMarcoDistilbertDotV5"
    MSMARCO_DISTILBERT_BASE_TAS_B = "MsMarcoDistilbertBaseTasB"
    MSMARCO_BERT_BASE_DOT_V5 = "MsMarcoBertBaseDotV5"

    @property
    def model_id(self) -> int:
        """Stable DB id (must match reference configs.rs:72-83)."""
        return _MODEL_IDS[self]

    @property
    def checkpoint_dir_name(self) -> str:
        return _CHECKPOINT_DIRS[self]

    @classmethod
    def parse(cls, name: str) -> "ModelType":
        for m in cls:
            if m.value.lower() == name.lower() or m.name.lower() == name.lower():
                return m
        raise ValueError(f"unknown model type: {name!r}")


_MODEL_IDS = {
    ModelType.ALL_MINILM_L6_V2: 0,
    ModelType.ALL_MINILM_L12_V2: 1,
    ModelType.DISTILUSE_BASE_MULTILINGUAL_CASED: 2,
    ModelType.ALL_DISTILROBERTA_V1: 3,
    ModelType.PARAPHRASE_ALBERT_SMALL_V2: 4,
    ModelType.MSMARCO_DISTILBERT_DOT_V5: 5,
    ModelType.MSMARCO_DISTILBERT_BASE_TAS_B: 6,
    ModelType.MSMARCO_BERT_BASE_DOT_V5: 7,
}

# sentence-transformers hub names double as local directory names under
# the model-data dir (analog of reference scripts/install_models.sh).
_CHECKPOINT_DIRS = {
    ModelType.ALL_MINILM_L6_V2: "all-MiniLM-L6-v2",
    ModelType.ALL_MINILM_L12_V2: "all-MiniLM-L12-v2",
    ModelType.DISTILUSE_BASE_MULTILINGUAL_CASED: "distiluse-base-multilingual-cased",
    ModelType.ALL_DISTILROBERTA_V1: "all-distilroberta-v1",
    ModelType.PARAPHRASE_ALBERT_SMALL_V2: "paraphrase-albert-small-v2",
    ModelType.MSMARCO_DISTILBERT_DOT_V5: "msmarco-distilbert-dot-v5",
    ModelType.MSMARCO_DISTILBERT_BASE_TAS_B: "msmarco-distilbert-base-tas-b",
    ModelType.MSMARCO_BERT_BASE_DOT_V5: "msmarco-bert-base-dot-v5",
}


@dataclasses.dataclass(frozen=True)
class ModelVersion:
    """(model_id, version) pair keying item_embeddings rows."""

    model_id: int
    version: int = 0


def model_data_dir() -> Path:
    """Where converted/downloaded checkpoints live.
    Override with PERCEIVE_TPU_MODEL_DATA."""
    env = os.environ.get("PERCEIVE_TPU_MODEL_DATA")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "model_data"


def checkpoint_path(model_type: ModelType) -> Optional[Path]:
    p = model_data_dir() / model_type.checkpoint_dir_name
    return p if p.exists() else None
