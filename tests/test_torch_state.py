"""The port's AppState rules: the device is explicit, and the storage tier
is bf16, f32, int8, int4 or int2 or an error (never one tier in another's
place)."""

import pytest
import torch

from perceive_tpu_torch.cli import AppState
from perceive_tpu_torch.cli.state import resolve_device, storage_tier
from perceive_tpu_torch.index.matrix import INT2, INT4
from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, TextTokenizer, tiny_test_vocab
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)


def _model():
    vocab = tiny_test_vocab(["alpha", "beta"])
    arch = EncoderArch(vocab_size=len(vocab), hidden_size=32, num_layers=1, num_heads=4,
                       intermediate_size=64, max_position_embeddings=32)
    tok = TextTokenizer.from_vocab(vocab, max_seq_length=32)
    return Model.random(arch, HeadConfig(normalize=True), tok, seed=0, device="cpu", model_id=0)


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        assert resolve_device("cuda:0") == torch.device("cuda:0")
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize(
    "choice,n_rows,want",
    [("auto", 0, torch.bfloat16), ("auto", 1_500_000, torch.bfloat16), ("AUTO", 10, torch.bfloat16),
     ("bf16", 9_000_000, torch.bfloat16), ("bfloat16", 0, torch.bfloat16),
     ("f32", 0, torch.float32), ("float32", 5_000_000, torch.float32),
     ("auto", 1_500_001, torch.int8), ("auto", 4_000_000, torch.int8), ("int8", 0, torch.int8),
     ("INT8", 9_000_000, torch.int8), ("auto", 4_000_001, INT2), ("auto", 24_000_000, INT2),
     ("int2", 0, INT2), ("INT2", 30_000_000, INT2)],
)
def test_storage_tier(choice, n_rows, want):
    assert storage_tier(choice, n_rows, 384) is want


@pytest.mark.parametrize(
    "choice,n_rows,want",
    [("auto", 24_000_001, INT4), ("auto", 12_100_000, INT4), ("auto", 30_000_000, INT4),
     ("int4", 0, INT4), ("INT4", 5_000_000, INT4), ("fp8", 0, ValueError)],
    ids=["auto-24000001-NotImplementedError", "auto-12100000-NotImplementedError",
         "auto-30000000-NotImplementedError", "int4-0-NotImplementedError",
         "INT4-5000000-NotImplementedError", "fp8-0-ValueError"],
)
def test_unported_tiers_raise(choice, n_rows, want):
    """The int4 tier serves: past 24M effective rows ``auto`` picks it, and
    ``int4`` pins it; an unknown tier still raises ``ValueError``.  The test
    and its case ids keep the names they had when these cases asserted the
    int4 gap (NotImplementedError), so that runs before and after the tier
    was ported compare case for case."""
    # 12.1M rows at 768 padded dims count as 24.2M rows of 384: past int2
    dim = 768 if n_rows == 12_100_000 else 384
    if want is ValueError:
        with pytest.raises(ValueError, match="unknown"):
            storage_tier(choice, n_rows, dim)
        return
    assert storage_tier(choice, n_rows, dim) is want


def test_auto_tier_scales_by_width():
    # 800k rows at 768 padded dims count as 1.6M rows of 384: int8, not bf16
    assert storage_tier("auto", 800_000, 768) is torch.int8
    assert storage_tier("auto", 800_000, 384) is torch.bfloat16


@pytest.mark.parametrize("env,want", [(None, torch.bfloat16), ("f32", torch.float32), ("int8", torch.int8),
                                      ("int2", INT2), pytest.param("int4", INT4, id="int4-None")])
def test_appstate_tier_from_env(tmp_path, monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("PERCEIVE_TPU_MATRIX_DTYPE", raising=False)
    else:
        monkeypatch.setenv("PERCEIVE_TPU_MATRIX_DTYPE", env)
    db = str(tmp_path / "db.sqlite3")
    m = _model()
    state = AppState(db, model=m, device="cpu")
    try:
        assert state.searcher.matrix.dtype is want
        assert state.searcher.matrix.device == torch.device("cpu")
        assert state.highlights_model is m
    finally:
        state.close()
