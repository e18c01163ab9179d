"""`doctor`: environment self-check, port of perceive_tpu/cli/doctor.py.

The doctor walks every dependency the serving stack needs and prints a
✓/!/✗ line for each, exiting non-zero only on hard failures.  The port's
dependencies are the GPU (CUDA, the card, its power limit), the CUDA
toolkit's ``nvcc`` that builds the kernels at their first launch, the
kernel library built for today's sources, the checkpoints, the compiled
tokenizer (g++), the native walker and the database with its snapshot
manifest.

Deliberately does NOT build AppState: no model load, no device matrix:
each check is independent and cheap, so the doctor works precisely when
the app doesn't.
"""

from __future__ import annotations

import sqlite3
import subprocess
import time
import zipfile
from pathlib import Path

from .state import DEFAULT_DEVICE

OK, WARN, FAIL = "ok", "warn", "fail"
_MARK = {OK: "  ✓", WARN: "  !", FAIL: "  ✗"}


class _Report:
    def __init__(self) -> None:
        self.rows: list[tuple[str, str, str]] = []

    def add(self, status: str, name: str, detail: str = "") -> None:
        self.rows.append((status, name, detail))
        print(f"{_MARK[status]} {name}" + (f": {detail}" if detail else ""), flush=True)

    @property
    def failed(self) -> bool:
        return any(s == FAIL for s, _, _ in self.rows)


def _power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0].strip() if out else None


def _kernel_smoke(device) -> str:
    """Build (or load) the kernel library and launch K1 once on a small
    matrix; its answer must equal the plain version's.  Returns a detail
    line; raises on a failed build, launch or comparison."""
    import torch

    from ..ops import _cuda, topk

    t0 = time.perf_counter()
    _cuda.library()
    t_build = time.perf_counter() - t0
    g = torch.Generator(device="cpu").manual_seed(0)
    n, d, k = 4096, 128, 16
    m = torch.randn((n, d), generator=g).to(device=device, dtype=torch.bfloat16)
    src = (torch.arange(n, dtype=torch.int32) % 3).to(device)
    q = torch.randn((1, d), generator=g).to(device)
    allowed = torch.full((topk.MAX_FILTER,), -9, dtype=torch.int32)
    allowed[0] = topk.ALLOW_ALL
    allowed = allowed.to(device)
    launches = topk.LAUNCHES
    vals, rows = topk.scan_topk(m, src, q, allowed, k)
    torch.cuda.synchronize(device)
    if topk.LAUNCHES == launches:
        raise RuntimeError("scan_topk launched no kernel")
    pv, pr = topk.scan_topk_plain(m, src, q, allowed, k)
    err = float((vals - pv).abs().max())
    if not torch.equal(rows, pr) or err > 1e-3:
        raise RuntimeError(f"K1 disagrees with its plain version (max_abs_err {err:.3g})")
    return f"library in {t_build:.1f}s, one K1 launch equals its plain version (max_abs_err {err:.3g})"


def _check_device(rep: _Report, device=DEFAULT_DEVICE) -> None:
    try:
        import torch

        dev = torch.device(device)
        if dev.type == "cpu":
            rep.add(OK, "device", f"cpu, torch {torch.__version__}")
            rep.add(WARN, "device platform",
                    "CPU — fine for tests, not for production latency (the "
                    f"entry points run on {DEFAULT_DEVICE})")
            return
        if not torch.cuda.is_available():
            rep.add(FAIL, "device", f"CUDA unavailable (torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}): the entry points raise on {dev}")
            return
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        props = torch.cuda.get_device_properties(index)
        rep.add(OK, "device", f"{torch.cuda.device_count()} CUDA device(s); {dev}: {props.name}, "
                f"{props.total_memory / 2**30:.1f} GiB, torch {torch.__version__}, CUDA {torch.version.cuda}")
        limit = _power_limit()
        if limit:
            rep.add(OK, "power limit", limit)
        else:
            rep.add(WARN, "power limit", "nvidia-smi unavailable: the card's power limit is unknown")
        from ..ops import _cuda

        try:
            rep.add(OK, "nvcc", _cuda._nvcc())
        except RuntimeError as e:
            rep.add(WARN, "nvcc", f"{e} (a library built before still loads)")
        try:
            rep.add(OK, "kernel build+launch", _kernel_smoke(dev))
        except Exception as e:  # noqa: BLE001
            rep.add(FAIL, "kernel build+launch", str(e))
    except Exception as e:  # noqa: BLE001
        rep.add(FAIL, "device", f"torch unavailable: {e}")


def _check_models(rep: _Report) -> None:
    from ..models.registry import ModelType, checkpoint_path, model_data_dir

    root = model_data_dir()
    present = [mt.value for mt in ModelType if checkpoint_path(mt)]
    if present:
        rep.add(OK, "checkpoints", f"{len(present)} under {root}: "
                + ", ".join(present[:4]) + ("…" if len(present) > 4 else ""))
    else:
        rep.add(WARN, "checkpoints",
                f"none under {root} — the CLI falls back to a random-weight "
                "encoder (rankings meaningless); run python -m "
                "perceive_tpu_torch.tools.install_models on a networked machine")
    try:
        from ..models.tokenize import TextTokenizer  # noqa: F401
        from ..models.tokenizer_json import pipeline_from_json  # noqa: F401

        rep.add(OK, "tokenizer", "WordPiece, byte-level BPE and Unigram checkpoints read "
                "(models/tokenize.py, models/tokenizer_json.py)")
    except Exception as e:  # noqa: BLE001
        rep.add(FAIL, "tokenizer", str(e))


_OPTIONAL = {
    "zstandard": "markdown with front matter and fetched pages cannot be stored",
    "lxml": "fetched web pages are not parsed",
    "yaml": "front matter is not parsed",
}


def _check_native(rep: _Report) -> None:
    # the compiled tokenizer has no fallback: without it no model loads
    try:
        from ..native import tokenizer as native_tokenizer

        native_tokenizer.library()
        rep.add(OK, "tokenizer library", f"loaded {native_tokenizer.library_path().name}")
    except (RuntimeError, OSError) as e:
        rep.add(FAIL, "tokenizer library", f"{e} — no model loads without it")
    try:
        from .. import native

        if native.fastwalk_available():
            rep.add(OK, "native walker", "fastwalk loaded")
        else:
            rep.add(WARN, "native walker",
                    "C++ fastwalk unavailable (no g++?); Python fallback is "
                    "correct but slower on huge trees")
    except Exception as e:  # noqa: BLE001
        rep.add(WARN, "native walker", f"{e} (Python fallback active)")
    # the connectors import each of these at its first use, so a machine
    # without one still runs: only the files that need it fail (the JAX
    # package's doctor fails on a missing zstandard)
    for mod, loses in _OPTIONAL.items():
        try:
            __import__(mod)
            rep.add(OK, mod)
        except Exception as e:  # noqa: BLE001
            rep.add(WARN, mod, f"import failed: {e} — {loses}")


def _check_db(rep: _Report, db_path: str | None) -> None:
    from ..paths import database_path

    path = Path(db_path) if db_path else database_path()
    if not Path(path).exists():
        rep.add(WARN, "database", f"{path} does not exist yet (created on "
                "first `source add`)")
        return
    try:
        conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        try:
            integ = conn.execute("PRAGMA integrity_check").fetchone()[0]
            if integ != "ok":
                rep.add(FAIL, "database integrity", integ)
                return
            mode = conn.execute("PRAGMA journal_mode").fetchone()[0]
            n_sources = conn.execute("SELECT COUNT(*) FROM sources").fetchone()[0]
            n_items = conn.execute("SELECT COUNT(*) FROM items").fetchone()[0]
            n_emb = conn.execute("SELECT COUNT(*) FROM item_embeddings").fetchone()[0]
            rep.add(OK, "database",
                    f"{path} ({mode}), {n_sources} sources, {n_items} items, "
                    f"{n_emb} embeddings")
            try:
                shards = conn.execute(
                    "SELECT model_id, model_version, path, rows "
                    "FROM vector_shards"
                ).fetchall()
            except sqlite3.OperationalError:
                # a reference-built perceive database has the same core
                # tables but no vector_shards manifest — valid input for
                # `import-db`, so don't FAIL the whole database check on it
                rep.add(WARN, "snapshot",
                        "no vector_shards table — a reference (pre-import) "
                        "database; run `import-db` to bring it in")
                shards = []
            for mid, mv, spath, srows in shards:
                if not Path(spath).exists():
                    rep.add(WARN, "snapshot",
                            f"model {mid} v{mv}: manifest points at missing "
                            f"{spath} — startup falls back to a full (slower) "
                            "rebuild from SQLite")
                    continue
                total = conn.execute(
                    "SELECT COUNT(*) FROM item_embeddings WHERE model_id = ? "
                    "AND model_version = ?", (mid, mv)
                ).fetchone()[0]
                backlog = max(0, total - srows)
                detail = f"model {mid} v{mv}: {srows} rows in {spath}"
                # format probe from the zip directory alone (no data read):
                # v1 bases (or payload-less v2) stream+re-quantize at load;
                # a fresh `snapshot` upgrades them to the adopt fast path
                # (save_snapshot skips the delta shortcut on pre-v2 bases,
                # so one re-save really does rewrite the base)
                try:
                    with zipfile.ZipFile(spath) as zf:
                        members = set(zf.namelist())
                    # (bf16/f32 v2 bases carry no q_ members by design —
                    # only the missing fmt marker means a v1 base)
                    old_fmt = "fmt.npy" not in members
                except Exception:  # noqa: BLE001 — corrupt/truncated zip
                    # startup will hit the same error and silently fall back
                    # to a full rebuild: surface it here, same class as the
                    # missing-file WARN above
                    rep.add(WARN, "snapshot", detail + " is unreadable "
                            "(corrupt/truncated zip) — startup falls back to "
                            "a full (slower) rebuild; run `snapshot` to "
                            "rewrite it")
                    continue
                if backlog > max(1000, srows // 4):
                    extra = (" (also a v1 base — the same `snapshot` run "
                             "upgrades it to the fast-adopt format)"
                             if old_fmt else "")
                    rep.add(WARN, "snapshot", detail + f", ~{backlog} newer "
                            "rows replay from SQLite at startup — run "
                            "`snapshot` to refresh" + extra)
                elif old_fmt:
                    # WARN, not an OK-line suffix: the v1 base costs the
                    # same slow-startup class as the replay backlog above,
                    # and grep/CI consumers only see `!` rows
                    rep.add(WARN, "snapshot", detail + " is a v1 base — run "
                            "`snapshot` once to upgrade to the fast-adopt "
                            "format")
                else:
                    rep.add(OK, "snapshot", detail)
            # every blob of one (model_id, model_version) must be the same
            # byte length (one vector dim): mixed lengths mean corruption
            # or rows written by a different-dim encoder under the same
            # identity — Searcher.build would crash on them at startup
            for mid, mv, lo_len, hi_len in conn.execute(
                """SELECT model_id, model_version,
                          MIN(LENGTH(embedding)), MAX(LENGTH(embedding))
                   FROM item_embeddings GROUP BY model_id, model_version"""
            ).fetchall():
                if lo_len != hi_len:
                    rep.add(WARN, "embedding dims",
                            f"model {mid} v{mv}: blob sizes vary "
                            f"({lo_len}-{hi_len} bytes) — mixed-dimension "
                            "rows under one model identity; delete the "
                            "stray rows or re-scan")
            orphans = conn.execute(
                """SELECT COUNT(*) FROM items
                   LEFT JOIN item_embeddings ie ON ie.item_id = items.id
                   WHERE items.skipped IS NULL AND items.hidden_at IS NULL
                     AND ie.item_id IS NULL"""
            ).fetchone()[0]
            if orphans:
                rep.add(WARN, "unembedded items",
                        f"{orphans} live items have no embedding row — a scan "
                        "was interrupted; re-run `source scan` to finish")
        finally:
            conn.close()
    except Exception as e:  # noqa: BLE001
        rep.add(FAIL, "database", f"{path}: {e}")


def _check_kernel_cache(rep: _Report) -> None:
    from ..ops import _cuda

    lib = _cuda.library_path()
    if lib.exists():
        rep.add(OK, "kernel cache", str(lib))
    else:
        have = sorted(p.name for p in _cuda.BUILD_DIR.glob("libperceive_kernels_*.so")) \
            if _cuda.BUILD_DIR.is_dir() else []
        rep.add(WARN, "kernel cache",
                f"no library for these sources under {_cuda.BUILD_DIR} "
                f"({len(have)} for other sources) — the first launch builds "
                "it with nvcc, one process per source in parallel")


def doctor(db_path: str | None = None, device=DEFAULT_DEVICE) -> int:
    """Run all checks; returns a process exit code (0 unless a FAIL)."""
    rep = _Report()
    print("perceive-tpu-torch doctor", flush=True)
    _check_device(rep, device)
    _check_models(rep)
    _check_native(rep)
    _check_db(rep, db_path)
    _check_kernel_cache(rep)
    fails = sum(1 for s, _, _ in rep.rows if s == FAIL)
    warns = sum(1 for s, _, _ in rep.rows if s == WARN)
    print(f"{len(rep.rows)} checks: {fails} failed, {warns} warnings", flush=True)
    return 1 if rep.failed else 0
