"""The port's checkpoint tools (``perceive_tpu_torch/tools``) against the JAX
package's ``scripts/install_models.py`` and ``scripts/verify_checkpoint.py``.

  * install: with a fake ``huggingface_hub`` that records each
    ``snapshot_download`` call, both make the same calls (repo id,
    ``local_dir``, ``allow_patterns``) for no arguments, two named models
    and ``--all``, and both skip a folder that holds a ``config.json``;
    without the package the port's tool exits 1 and says what to copy
    where;
  * verify on the CPU: the committed synthetic checkpoint passes at the
    golden bar (cosine > 0.999, rtol 2e-3, atol 2e-4), a copy with one
    weight moved fails (exit 1);
  * golden files cross: one the JAX package's encoder wrote passes the
    port's committed-golden stage, one the port's torch-golden stage wrote
    passes the JAX script's;
  * the port's doctor names the port's install tool.
"""

import importlib.util
import io
import runpy
import shutil
import sys
import types
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from perceive_tpu.models import Model as JaxModel
from perceive_tpu.models.registry import ModelType as JaxType
from perceive_tpu_torch.cli.doctor import doctor
from perceive_tpu_torch.models import ModelType
from perceive_tpu_torch.tools import install_models, verify_checkpoint
from test_torch_registry_checkpoints import SMOKE, UNCASED, _bert
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
CPU = torch.device("cpu")


@pytest.fixture
def model_data(tmp_path, monkeypatch):
    md = tmp_path / "model_data"
    monkeypatch.setenv("PERCEIVE_TPU_MODEL_DATA", str(md))
    return md


@pytest.fixture
def hub(monkeypatch):
    """A huggingface_hub whose snapshot_download records its arguments."""
    calls = []

    def snapshot_download(*args, **kwargs):
        calls.append((args, {k: str(v) if isinstance(v, Path) else v for k, v in kwargs.items()}))

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(snapshot_download=snapshot_download))
    return calls


def _jax_install(monkeypatch, argv) -> int:
    script = REPO / "scripts" / "install_models.py"
    monkeypatch.setattr(sys, "argv", [str(script), *argv])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(script), run_name="__main__")
    return done.value.code


def _both_install(monkeypatch, hub, argv) -> tuple:
    """(the JAX script's calls, the port's calls, what the port printed)."""
    with redirect_stdout(io.StringIO()):
        assert _jax_install(monkeypatch, argv) == 0
    jax_calls = list(hub)
    hub.clear()
    with redirect_stdout(io.StringIO()) as said:
        assert install_models.main(argv) == 0
    return jax_calls, list(hub), said.getvalue()


@pytest.mark.parametrize("argv, n", [([], 2), (["AllMiniLmL12V2", "msmarco_distilbert_dot_v5"], 2), (["--all"], 8)],
                         ids=["defaults", "two named", "all"])
def test_install_makes_the_jax_scripts_downloads(model_data, monkeypatch, hub, argv, n):
    jax_calls, calls, _ = _both_install(monkeypatch, hub, argv)
    assert calls == jax_calls and len({args[0] for args, _ in calls}) == n
    for args, kwargs in calls:
        name = args[0].removeprefix("sentence-transformers/")
        assert kwargs["local_dir"] == str(model_data / name)
        assert name in {mt.checkpoint_dir_name for mt in ModelType}


def test_install_skips_an_installed_checkpoint(model_data, monkeypatch, hub):
    installed = model_data / ModelType.ALL_MINILM_L6_V2.checkpoint_dir_name
    installed.mkdir(parents=True)
    (installed / "config.json").write_text("{}")
    jax_calls, calls, said = _both_install(monkeypatch, hub, [])
    assert calls == jax_calls and [a[0] for a, _ in calls] == ["sentence-transformers/msmarco-bert-base-dot-v5"]
    assert f"AllMiniLmL6V2: already installed at {installed}" in said


def test_install_without_huggingface_hub_fails(model_data, monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with redirect_stdout(io.StringIO()), redirect_stderr(io.StringIO()) as err:
        rc = install_models.main(["AllMiniLmL6V2"])
    assert rc == 1 and "huggingface_hub" in err.getvalue(), err.getvalue()
    assert str(model_data / "all-MiniLM-L6-v2") in err.getvalue() and not (model_data / "all-MiniLM-L6-v2").exists()


def _verify(argv=("--no-download", "--device", "cpu")) -> tuple:
    """(exit code, {stage: its first word}, what it printed)."""
    with redirect_stdout(io.StringIO()) as out, redirect_stderr(io.StringIO()):
        rc = verify_checkpoint.main(list(argv))
    summary = out.getvalue().split("== verify-checkpoint ==")[1].split("\n")
    words = {line.split()[0]: line.split()[1] for line in summary if line.strip()}
    return rc, words, out.getvalue()


def test_verify_passes_on_the_cpu(model_data):
    rc, words, out = _verify()
    assert rc == 0, out
    assert words == {"download": "SKIP", "synthetic_golden": "PASS", "torch_golden": "SKIP",
                     "committed_golden": "SKIP", "recall_10m": "SKIP"}, out
    assert "golden_st_checkpoint on cpu: f32 min cosine 1.0000" in out


def test_verify_fails_on_a_moved_weight(model_data, tmp_path, monkeypatch):
    """The planted fault: one weight of the golden checkpoint (the
    embedding LayerNorm's first gain) moved by 0.1, which moves the vectors
    by ~3e-3, past the golden bar."""
    fixtures = tmp_path / "fixtures"
    shutil.copytree(FIXTURES / "golden_st_checkpoint", fixtures / "golden_st_checkpoint")
    shutil.copy(FIXTURES / "golden_vectors.npz", fixtures)
    weights = fixtures / "golden_st_checkpoint" / "pytorch_model.bin"
    sd = torch.load(weights)
    sd["embeddings.LayerNorm.weight"][0] += 0.1
    torch.save(sd, weights)
    monkeypatch.setattr(verify_checkpoint, "FIXTURES", fixtures)
    rc, words, out = _verify()
    assert rc == 1 and words["synthetic_golden"] == "FAIL", out


def test_verify_refuses_a_missing_cuda_device(model_data):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        verify_checkpoint.main(["--no-download"])


def test_golden_files_cross_between_the_packages(model_data, tmp_path, monkeypatch):
    """A small all-MiniLM-L6-v2-shaped checkpoint under the model-data dir:
    the JAX encoder's golden passes the port's committed stage (and the
    same file with its rows swapped fails it); the port's torch-golden
    stage (transformers' mean pooling against the port) writes a golden
    that passes the JAX script's committed stage."""
    monkeypatch.setenv("USE_TF", "0")
    SMOKE.write_checkpoint(str(model_data / "all-MiniLM-L6-v2"), _bert(32, 2, len(UNCASED)), UNCASED, 96, seed=11)
    fixtures = tmp_path / "fixtures"
    fixtures.mkdir()
    golden = fixtures / "real_golden_all-MiniLM-L6-v2.npz"
    monkeypatch.setattr(verify_checkpoint, "FIXTURES", fixtures)
    sentences = verify_checkpoint.SENTENCES

    emb = JaxModel.new_pretrained(JaxType.ALL_MINILM_L6_V2, compute_dtype=np.float32, attention_impl="xla").encode(
        sentences)
    np.savez(golden, sentences=np.array(sentences), tower_mean_pooled=emb, embeddings=np.asarray(emb))
    with redirect_stdout(io.StringIO()):
        assert verify_checkpoint.stage_committed_golden(CPU) == "PASS"
        np.savez(golden, sentences=np.array(sentences), tower_mean_pooled=emb, embeddings=np.asarray(emb)[::-1])
        assert verify_checkpoint.stage_committed_golden(CPU).startswith("FAIL")
        golden.unlink()
        assert verify_checkpoint.stage_torch_golden(CPU) == "PASS"
    assert golden.exists() and set(np.load(golden)) == {"sentences", "tower_mean_pooled", "embeddings"}

    spec = importlib.util.spec_from_file_location("jax_verify_checkpoint", REPO / "scripts" / "verify_checkpoint.py")
    jax_verify = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_verify)
    monkeypatch.setattr(jax_verify, "FIXTURES", fixtures)
    with redirect_stdout(io.StringIO()):
        assert jax_verify.stage_committed_golden() == "PASS"


def test_doctor_names_the_ports_install_tool(model_data, tmp_path):
    with redirect_stdout(io.StringIO()) as out:
        doctor(str(tmp_path / "missing.sqlite3"), device="cpu")
    assert "python -m perceive_tpu_torch.tools.install_models" in out.getvalue(), out.getvalue()
    assert "scripts/install_models.py" not in out.getvalue()
