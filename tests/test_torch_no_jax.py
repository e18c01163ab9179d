"""The port imports neither jax, nor anything of the JAX package, nor the
Rust tokenizers, and importing the kernel loader needs no CUDA compiler
(the build runs at the first launch)."""

import os
import subprocess
import sys
from pathlib import Path
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parent.parent


def _run(code: str, env=None):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, env=env, timeout=120
    )


SOURCE_MODULES = (
    "perceive_tpu_torch.sources, perceive_tpu_torch.sources.fs, perceive_tpu_torch.sources.pipeline, "
    "perceive_tpu_torch.sources.reprocess, perceive_tpu_torch.sources.parse_html, "
    "perceive_tpu_torch.sources.readability, perceive_tpu_torch.sources.chromium_history, "
    "perceive_tpu_torch.sources.chromium_bookmarks"
)
PORT_MODULES = (
    "perceive_tpu_torch, perceive_tpu_torch.cli, perceive_tpu_torch.cli.state, "
    "perceive_tpu_torch.index.searcher, perceive_tpu_torch.index.executor, perceive_tpu_torch.db, "
    "perceive_tpu_torch.models, perceive_tpu_torch.ops.topk, perceive_tpu_torch.ops.int2, "
    "perceive_tpu_torch.ops.attention, perceive_tpu_torch.index.matrix, "
    "perceive_tpu_torch.utils.coalesce, perceive_tpu_torch.paths, perceive_tpu_torch.types, "
    "perceive_tpu_torch.utils, perceive_tpu_torch.native, perceive_tpu_torch.cli.commands, "
    "perceive_tpu_torch.cli.main, " + SOURCE_MODULES + ", " + (
        "perceive_tpu_torch.serve, perceive_tpu_torch.cli.doctor, perceive_tpu_torch.cli.repl, "
        "perceive_tpu_torch.cli.desktop, perceive_tpu_torch.db.import_reference, "
        "perceive_tpu_torch.utils.dispatchmeter, perceive_tpu_torch.utils.profiling, "
        "perceive_tpu_torch.ops.similarity, perceive_tpu_torch.parallel, perceive_tpu_torch.parallel.mesh, "
        "perceive_tpu_torch.parallel.search, perceive_tpu_torch.parallel.dryrun, "
        "perceive_tpu_torch.tools.install_models, perceive_tpu_torch.tools.verify_checkpoint"
    )
)


def test_port_imports_nothing_of_the_jax_package():
    res = _run(
        "import sys\n"
        f"import {PORT_MODULES}\n"
        "bad = sorted(m for m in sys.modules if m == 'perceive_tpu' or m.startswith('perceive_tpu.'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py's imports, at module level and inside its phases."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "perceive_tpu")]
    assert not bad and "perceive_tpu_torch.db" in names, bad


def test_port_imports_no_jax_or_tokenizers():
    """Nor does the tokenizer.json reader load the tokenizers library or
    regex, even as it reads a file."""
    res = _run(
        "import sys, json, tempfile, pathlib\n"
        f"import {PORT_MODULES}, perceive_tpu_torch.models.tokenizer_json\n"
        "from perceive_tpu_torch.models.tokenizer_json import pipeline_from_json\n"
        "p = pathlib.Path(tempfile.mkdtemp()) / 'tokenizer.json'\n"
        "p.write_text(json.dumps({'model': {'type': 'BPE', 'vocab': {'a': 0, 'b': 1, 'ab': 2}, 'merges': [['a', 'b']]},"
        " 'pre_tokenizer': {'type': 'ByteLevel'}}))\n"
        "assert pipeline_from_json(p).encode('ab').ids\n"
        "bad = [m for m in ('jax', 'jaxlib', 'tokenizers', 'regex') if m in sys.modules]\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_compiled_tokenizer_loads_no_jax_or_tokenizers():
    """Building and using the compiled tokenizer, for WordPiece and for a
    tokenizer.json pipeline, loads no jax, tokenizers or JAX-package module."""
    res = _run(
        "import sys\n"
        "from perceive_tpu_torch.models.tokenize import TextTokenizer, tiny_test_vocab\n"
        "from perceive_tpu_torch.models.tokenizer_json import Pipeline\n"
        "tok = TextTokenizer.from_vocab(tiny_test_vocab(['hello']))\n"
        "assert tok.encode_batch(['hello world']).input_ids.shape == (1, 16)\n"
        "assert tok.encode_untruncated(['hello'])[0].ids == [1, 5, 2]\n"
        "bpe = TextTokenizer(Pipeline({'model': {'type': 'BPE', 'vocab': {'a': 0, 'b': 1, 'ab': 2}, "
        "'merges': [['a', 'b']]}, 'pre_tokenizer': {'type': 'ByteLevel', 'add_prefix_space': False}}))\n"
        "assert bpe.encode_untruncated(['ab'])[0].ids == [2]\n"
        "bad = [m for m in ('jax', 'jaxlib', 'tokenizers', 'regex') if m in sys.modules]\n"
        "bad += sorted(m for m in sys.modules if m == 'perceive_tpu' or m.startswith('perceive_tpu.'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_connectors_import_no_optional_packages():
    """A machine that runs the port may lack yaml, zstandard, lxml and requests: the
    connectors import each at its first use, never at import."""
    res = _run(
        "import sys\n"
        f"import {SOURCE_MODULES}, perceive_tpu_torch.native, perceive_tpu_torch.cli.commands\n"
        "bad = [m for m in ('yaml', 'zstandard', 'lxml', 'requests', 'jax') if m in sys.modules]\n"
        "bad += sorted(m for m in sys.modules if m == 'perceive_tpu' or m.startswith('perceive_tpu.'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_snapshots_load_no_jax(tmp_path):
    """A save, an adopt, a load and the CLI's ``snapshot`` load neither jax
    nor any module of the JAX package."""
    res = _run(
        "import sys, numpy as np, torch\n"
        "from perceive_tpu_torch.index.matrix import EmbeddingMatrix, INT2\n"
        "from perceive_tpu_torch.cli import AppState, main\n"
        "m = EmbeddingMatrix(16, dtype=INT2, device='cpu')\n"
        "m.upsert([1, 2, 3], [0, 0, 1], np.random.default_rng(0).standard_normal((3, 16)))\n"
        f"p = {str(tmp_path / 'm.npz')!r}\n"
        "assert m.save_snapshot(p) == 'full'\n"
        "assert EmbeddingMatrix(16, dtype=INT2, device='cpu').adopt_snapshot(p)\n"
        "assert len(EmbeddingMatrix.load_snapshot(p, device='cpu', dtype=INT2)) == 3\n"
        f"st = AppState({str(tmp_path / 'db.sqlite3')!r}, device='cpu')\n"
        f"assert main(['snapshot', {str(tmp_path / 's.npz')!r}], state=st) == 0\n"
        "bad = [m for m in ('jax', 'jaxlib') if m in sys.modules]\n"
        "bad += sorted(m for m in sys.modules if m == 'perceive_tpu' or m.startswith('perceive_tpu.'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n",
        env=dict(os.environ, PERCEIVE_TPU_DATA_DIR=str(tmp_path / "data")),
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_kernel_loader_imports_without_nvcc():
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    res = _run(
        "import perceive_tpu_torch.ops._cuda as c\n"
        "assert c._lib is None and c.build_seconds is None\n"
        "assert len(c.source_key()) == 16\n"
        "assert {p.name for p in c.sources()} >= {'scan_flat_rows.cu', 'scan_slab_rows.cu', 'scan_slab_cols.cu', 'scan_flat_cols.cu', 'topk_common.cuh', 'attention.cu',"
        " 'scan_int2.cu', 'select_topk.cu'}\n",
        env=env,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_cpu_tensors_never_build():
    """CPU tensors take the plain versions: no build, no launch counted."""
    res = _run(
        "import torch\n"
        "from perceive_tpu_torch.ops import _cuda, attention, int2, topk\n"
        "m = torch.zeros(512, 128); s = torch.zeros(512, dtype=torch.int32)\n"
        "a = torch.full((16,), -9, dtype=torch.int32); a[0] = topk.ALLOW_ALL\n"
        "topk.scan_topk(m, s, torch.zeros(1, 128), a, 4)\n"
        "topk.scan_topk(m.bfloat16(), s, torch.zeros(256, 128), a, 4)\n"
        "topk.scan_topk_int8(m.to(torch.int8), torch.ones(512), s, torch.zeros(300, 128), a, 4)\n"
        "topk.scan_topk_int8(m.to(torch.int8), torch.ones(512), s, torch.zeros(3, 128), a, 4)\n"
        "x = torch.zeros(1, 8, 2, 4); attention.attention(x, x, x, torch.ones(1, 8, dtype=torch.int32))\n"
        "p2 = torch.zeros(32, 512, dtype=torch.uint8); f8 = torch.zeros(128, 512, dtype=torch.int8)\n"
        "int2.scan_int2_coarse_fine(p2, torch.ones(512), f8, torch.ones(512), s, torch.zeros(1, 128), a, 4)\n"
        "topk.scan_topk_int8t(f8, torch.ones(512), s, torch.zeros(300, 128), a, 4)\n"
        "assert _cuda._lib is None and attention.LAUNCHES == 0\n"
        "assert set(topk.launch_counts().values()) == {0} and set(int2.launch_counts().values()) == {0}\n"
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_serve_ships_its_own_page():
    """The port serves its own copy of the search page, byte-equal to the
    JAX package's, from its own folder (and lists it as package data)."""
    res = _run(
        "import sys\n"
        "import perceive_tpu_torch.serve as s\n"
        "from pathlib import Path\n"
        "assert Path(s.__file__).with_name('serve_ui.html').exists()\n"
        "assert not any(m == 'perceive_tpu' or m.startswith('perceive_tpu.') for m in sys.modules)\n"
        "sys.stdout.write(s._INDEX_HTML)\n"
    )
    assert res.returncode == 0, res.stderr
    ours = (REPO / "perceive_tpu_torch" / "serve_ui.html").read_bytes()
    assert ours == (REPO / "perceive_tpu" / "serve_ui.html").read_bytes()
    assert res.stdout.encode() == ours
    data = (REPO / "pyproject.toml").read_text().split('"perceive_tpu_torch" =')[1].split("\n")[0]
    assert '"serve_ui.html"' in data
