"""The port imports neither jax, nor anything of the JAX package, nor the
Rust tokenizers, and importing the kernel loader needs no CUDA compiler
(the build runs at the first launch)."""

import os
import subprocess
import sys
from pathlib import Path

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
    "perceive_tpu_torch.cli.main, " + SOURCE_MODULES
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
    res = _run(
        "import sys\n"
        f"import {PORT_MODULES}\n"
        "bad = [m for m in ('jax', 'jaxlib', 'tokenizers') if m in sys.modules]\n"
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
