"""One-command checkpoint validation through the port.

    python -m perceive_tpu_torch.tools.verify_checkpoint [--no-download] [--device cuda:0|cpu]

The port's counterpart of ``scripts/verify_checkpoint.py``, with the same
stages and words: download (``install_models``, skipped when it fails,
as on a machine without network) -> the committed synthetic
sentence-transformers checkpoint against its golden vectors -> each
installed registry checkpoint against ``transformers`` (writing
``real_golden_<checkpoint>.npz``) -> the committed real-checkpoint goldens
-> the 10M recall harness.  Each stage reports PASS, SKIP or FAIL; the
exit code is non-zero only on a FAIL, so a machine with no network and
no checkpoints exits 0 with SKIPs.

Every encode runs on ``--device`` (default ``cuda:0``; there is no CPU
fallback: pass ``--device cpu`` to run on the CPU).  A golden file
written by either package's tool is read by the other's committed-golden
stage: same sentences, same keys.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
SENTENCES = [
    "The TPU sweeps the whole matrix in one fused kernel.",
    "A quick brown fox jumps over the lazy dog",
    "semantic search for your life",
    "Ground control to Major Tom.",
]
FIXTURES = REPO / "tests" / "fixtures"
# the synthetic golden's bar (tests/test_golden_fixture.py)
GOLDEN_MIN_COSINE = 0.999
GOLDEN_RTOL, GOLDEN_ATOL = 2e-3, 2e-4
SIMILARITY_TOL = 1e-2  # torch_golden: pairwise-similarity delta against transformers


def _installed():
    from ..models.registry import ModelType, checkpoint_path

    return [(mt, checkpoint_path(mt)) for mt in ModelType if checkpoint_path(mt)]


def _cosines(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))


def stage_download() -> str:
    try:
        r = subprocess.run([sys.executable, "-m", "perceive_tpu_torch.tools.install_models"],
                           capture_output=True, text=True, timeout=1800, cwd=str(REPO))
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"SKIP ({e})"
    if r.returncode == 0:
        return "PASS"
    sys.stderr.write(r.stderr[-2000:] + "\n")
    return "SKIP (download failed — no network or no huggingface_hub?)"


def stage_synthetic_golden(dev: torch.device) -> str:
    """The committed synthetic checkpoint (tests/fixtures/golden_st_checkpoint:
    BERT, mean pooling, a Dense head, Normalize) against the vectors
    transformers computed when it was made: ids and mask equal, the vectors
    at f32 within the golden bar; the cosine at the serving dtype (bf16) is
    reported."""
    from ..models import Model

    z = np.load(FIXTURES / "golden_vectors.npz")
    sentences = [str(s) for s in z["sentences"]]
    path = str(FIXTURES / "golden_st_checkpoint")
    model = Model.new_pretrained(path, device=dev, compute_dtype=torch.float32)
    tb = model.tokenizer.encode_batch(sentences)
    if not (np.array_equal(tb.input_ids, z["input_ids"]) and np.array_equal(tb.attention_mask, z["attention_mask"])):
        return "FAIL (tokenization differs from the golden input_ids / attention_mask)"
    got, want = model.encode(sentences), z["embeddings"]
    cos = _cosines(got, want)
    err = float(np.max(np.abs(got - want)))
    bf16 = _cosines(Model.new_pretrained(path, device=dev).encode(sentences), want)
    print(f"  golden_st_checkpoint on {dev}: f32 min cosine {cos.min():.6f}, max abs error {err:.3g}; "
          f"bf16 (serving) min cosine {bf16.min():.6f} (reported)")
    if cos.min() <= GOLDEN_MIN_COSINE:
        return f"FAIL (synthetic golden: cosine {cos.min():.4f} <= {GOLDEN_MIN_COSINE})"
    if not np.allclose(got, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL):
        return f"FAIL (synthetic golden: max abs error {err:.3g} past rtol {GOLDEN_RTOL}, atol {GOLDEN_ATOL})"
    return "PASS"


def stage_torch_golden(dev: torch.device) -> str:
    """On a machine with transformers and installed checkpoints: each
    checkpoint's mean-pooled tower from transformers against the port's
    embeddings (the pairwise-similarity structure), and, after a PASS,
    ``real_golden_<checkpoint>.npz`` for the committed-golden stage."""
    installed = _installed()
    if not installed:
        return "SKIP (no checkpoints under model_data/)"
    try:
        from transformers import AutoModel, AutoTokenizer
    except ImportError:
        return "SKIP (transformers unavailable)"

    from ..models import Model

    def simmat(x):
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        return xn @ xn.T

    for mt, path in installed:
        tok = AutoTokenizer.from_pretrained(str(path))
        ref = AutoModel.from_pretrained(str(path)).eval()
        enc = tok(SENTENCES, padding=True, truncation=True, return_tensors="pt")
        with torch.no_grad():
            out = ref(**enc).last_hidden_state
        mask = enc["attention_mask"].unsqueeze(-1).float()
        want = ((out * mask).sum(1) / mask.sum(1)).numpy()  # the raw mean-pooled tower
        got = Model.new_pretrained(mt, device=dev, compute_dtype=torch.float32).encode(SENTENCES)
        diff = float(np.abs(simmat(got) - simmat(want)).max())
        print(f"  {mt.value}: max pairwise-similarity delta {diff:.5f}")
        if diff > SIMILARITY_TOL:
            return f"FAIL ({mt.value}: similarity structure delta {diff:.4f})"
        fixture = FIXTURES / f"real_golden_{mt.checkpoint_dir_name}.npz"
        if not fixture.exists():
            np.savez(fixture, sentences=np.array(SENTENCES), tower_mean_pooled=want, embeddings=got)
            print(f"  wrote {fixture} — commit this file")
    return "PASS"


def stage_committed_golden(dev: torch.device) -> str:
    """Each committed real_golden_*.npz whose checkpoint is installed: the
    port's f32 embeddings of its sentences against its ``embeddings``."""
    from ..models import Model
    from ..models.registry import ModelType, checkpoint_path

    fixtures = sorted(FIXTURES.glob("real_golden_*.npz"))
    if not fixtures:
        return "SKIP (no committed real-model goldens yet)"
    checked = 0
    for f in fixtures:
        name = f.stem.replace("real_golden_", "")
        mt = next((m for m in ModelType if m.checkpoint_dir_name == name), None)
        if mt is None or checkpoint_path(mt) is None:
            continue
        z = np.load(f, allow_pickle=False)
        got = Model.new_pretrained(mt, device=dev, compute_dtype=torch.float32).encode(
            [str(s) for s in z["sentences"]])
        cos = _cosines(got, z["embeddings"])
        print(f"  {name} on {dev}: min cosine {cos.min():.6f}")
        if cos.min() <= GOLDEN_MIN_COSINE:
            return f"FAIL ({name}: cosine {cos.min():.4f} <= {GOLDEN_MIN_COSINE})"
        checked += 1
    return "PASS" if checked else "SKIP (goldens exist but checkpoints not installed)"


def stage_recall() -> str:
    return "SKIP (the port's recall harness comes with its benchmark; the 10M harness in benchmarks/ runs on a TPU)"


def _run(stage, *args) -> str:
    """A stage's word; an exception inside it is its FAIL."""
    try:
        return stage(*args)
    except Exception as e:  # noqa: BLE001 - each stage reports, the next still runs
        traceback.print_exc()
        return f"FAIL ({type(e).__name__}: {e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--no-download", action="store_true")
    ap.add_argument("--device", default="cuda:0", help="where every encode runs (default cuda:0)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available (pass --device cpu to run on the CPU)")

    results = {
        "download": "SKIP (--no-download)" if args.no_download else stage_download(),
        "synthetic_golden": _run(stage_synthetic_golden, dev),
        "torch_golden": _run(stage_torch_golden, dev),
        "committed_golden": _run(stage_committed_golden, dev),
        "recall_10m": stage_recall(),
    }
    print("\n== verify-checkpoint ==")
    for k, v in results.items():
        print(f"  {k:18s} {v}")
    return 1 if any(v.startswith("FAIL") for v in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
