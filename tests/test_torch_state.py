"""The port's AppState rules: the device is explicit, and the storage tier
is bf16, f32, int8 or int2 or an error (never one tier in another's place)."""

import pytest
import torch

from perceive_tpu_torch.cli import AppState
from perceive_tpu_torch.cli.state import resolve_device, storage_tier
from perceive_tpu_torch.index.matrix import INT2
from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, TextTokenizer, tiny_test_vocab


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
    "choice,n_rows,err",
    [("auto", 24_000_001, NotImplementedError), ("auto", 12_100_000, NotImplementedError),
     ("auto", 30_000_000, NotImplementedError), ("int4", 0, NotImplementedError),
     ("INT4", 5_000_000, NotImplementedError), ("fp8", 0, ValueError)],
)
def test_unported_tiers_raise(choice, n_rows, err):
    # 12.1M rows at 768 padded dims count as 24.2M rows of 384: past int2
    with pytest.raises(err, match="ROADMAP" if err is NotImplementedError else None):
        storage_tier(choice, n_rows, 768 if n_rows == 12_100_000 else 384)


def test_auto_tier_scales_by_width():
    # 800k rows at 768 padded dims count as 1.6M rows of 384: int8, not bf16
    assert storage_tier("auto", 800_000, 768) is torch.int8
    assert storage_tier("auto", 800_000, 384) is torch.bfloat16


@pytest.mark.parametrize("env,want", [(None, torch.bfloat16), ("f32", torch.float32), ("int8", torch.int8),
                                      ("int2", INT2), ("int4", None)])
def test_appstate_tier_from_env(tmp_path, monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("PERCEIVE_TPU_MATRIX_DTYPE", raising=False)
    else:
        monkeypatch.setenv("PERCEIVE_TPU_MATRIX_DTYPE", env)
    db = str(tmp_path / "db.sqlite3")
    m = _model()
    if want is None:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            AppState(db, model=m, device="cpu")
        return
    state = AppState(db, model=m, device="cpu")
    try:
        assert state.searcher.matrix.dtype is want
        assert state.searcher.matrix.device == torch.device("cpu")
        assert state.highlights_model is m
    finally:
        state.close()
