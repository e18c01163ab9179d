"""The port's native walker (``perceive_tpu_torch.native``) against the JAX
package's and against the port's Python walk: the same (path, mtime,
atime) list on each tree.  The port builds its own library into
``perceive_tpu_torch/_build/``, never loading the JAX package's, and falls
back to the Python walk where no g++ is found."""

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from perceive_tpu.native import fastwalk as jax_fastwalk
from perceive_tpu_torch import native
from perceive_tpu_torch.sources.fs import FileScanner, _utf8_path

REPO = Path(__file__).resolve().parent.parent


def gitignore_tree(root):
    root.mkdir(parents=True)
    (root / "a.txt").write_text("a")
    (root / ".hidden").write_text("x")
    (root / ".gitignore").write_text("ignored/\n*.log\n!keep.log\nbuild/out.txt\n# comment\n\n")
    (root / "x.log").write_text("log")
    (root / "keep.log").write_text("keep")
    (root / "sub" / "inner").mkdir(parents=True)
    (root / "sub" / "b.md").write_text("b")
    (root / "sub" / "nested.log").write_text("nested")
    (root / "ignored").mkdir()
    (root / "ignored" / "c.txt").write_text("c")
    (root / "build").mkdir()
    (root / "build" / "out.txt").write_text("out")
    (root / "build" / "in.txt").write_text("in")
    (root / "sub" / "inner" / ".gitignore").write_text("*.md\n")
    (root / "sub" / "inner" / "d.md").write_text("d")
    (root / "sub" / "inner" / "d.txt").write_text("d")
    (root / "sub" / ".hidden_dir").mkdir()
    (root / "sub" / ".hidden_dir" / "e.txt").write_text("e")


def repo_tree(root):
    """Every ignore-file source: .gitignore, .ignore, .git/info/exclude and
    the global gitignore (pinned by PERCEIVE_TPU_GLOBAL_GITIGNORE)."""
    (root / ".git" / "info").mkdir(parents=True)
    (root / ".git" / "info" / "exclude").write_text("excluded.txt\n")
    (root / ".gitignore").write_text("*.tmp\n")
    (root / ".ignore").write_text("!keep.tmp\nignored_by_dot_ignore.txt\n")
    for name in ("a.txt", "excluded.txt", "x.tmp", "keep.tmp", "ignored_by_dot_ignore.txt", "global.bak"):
        (root / name).write_text(name)
    (root / "docs").mkdir()
    (root / "docs" / "g.txt").write_text("g")
    (root.parent / "global_ignore").write_text("*.bak\n")


def odd_names_tree(root):
    """Non-UTF-8, tab, newline and space names, deep nesting."""
    root.mkdir(parents=True)
    broot = os.fsencode(root)
    for name in (b"caf\xe9.txt", b"tab\tname.txt", b"new\nline.txt", b"sp ace.txt", b"ok.txt"):
        with open(os.path.join(broot, name), "wb") as f:
            f.write(b"x")
    deep = root
    for i in range(12):
        deep = deep / f"d{i}"
    deep.mkdir(parents=True)
    (deep / "leaf.txt").write_text("leaf")


TREES = {"gitignore": gitignore_tree, "repo": repo_tree, "odd_names": odd_names_tree}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_walkers_agree(tmp_path, monkeypatch, tree):
    if not native.fastwalk_available():
        pytest.fail("g++ is in this environment, so the port's walker must build")
    monkeypatch.setenv("PERCEIVE_TPU_GLOBAL_GITIGNORE", str(tmp_path / "tree" / ".." / "global_ignore"))
    root = tmp_path / "tree"
    if tree == "repo":
        root.mkdir()
    TREES[tree](root)

    port = sorted(native.fastwalk(str(root)))
    assert port == sorted(jax_fastwalk(str(root)))
    got = []
    FileScanner(1, str(root), {})._scan_python(str(root), got.append)
    python = sorted((i.external_id, i.metadata.mtime, i.metadata.atime) for i in got)
    assert python == [e for e in port if _utf8_path(e[0])]
    assert python, "the walk found nothing"
    # the scanner's native path emits exactly the Python walk's items
    native_items = []
    FileScanner(1, str(root), {}).scan(native_items.append)
    assert sorted((i.external_id, i.metadata.mtime, i.metadata.atime) for i in native_items) == python


def test_library_is_the_ports_own(tmp_path):
    assert native.fastwalk_available()
    so = native.library_path()
    assert so.parent == REPO / "perceive_tpu_torch" / "_build" and so.exists()
    assert native._lib._name == str(so)
    # builds racing on one name all land a loadable library (temp name + os.replace)
    out = tmp_path / "race.so"
    results = []
    threads = [threading.Thread(target=lambda: results.append(native._build(out))) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [True] * 3 and out.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["race.so"]


def test_falls_back_to_python_walk_without_gxx(tmp_path):
    """No toolchain and no built library: fastwalk() is None, and the fs
    scanner walks in Python (a host helper, not a device kernel)."""
    root = tmp_path / "tree"
    gitignore_tree(root)
    code = (
        "import sys\n"
        "from perceive_tpu_torch import native\n"
        "native.BUILD_DIR = native.Path(sys.argv[2])\n"
        "native.library_path = lambda: native.BUILD_DIR / 'x.so'\n"
        "from perceive_tpu_torch.sources.fs import FileScanner\n"
        "assert native.fastwalk(sys.argv[1]) is None and not native.fastwalk_available()\n"
        "got = []\n"
        "FileScanner(1, sys.argv[1], {}).scan(got.append)\n"
        "print(sorted(i.external_id[len(sys.argv[1]) + 1:] for i in got))\n"
    )
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code, str(root), str(tmp_path / "build")],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(sorted(["a.txt", "keep.log", "build/in.txt", "sub/b.md", "sub/inner/d.txt"]))
