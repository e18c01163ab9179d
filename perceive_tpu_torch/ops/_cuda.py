"""Build and load the port's CUDA kernels (``perceive_tpu_torch/csrc/*.cu``).

Each ``.cu`` source compiles with ``nvcc`` for Hopper (``sm_90a``) into an
object file, all of them at once in parallel processes, and the objects link
into ONE shared library with a plain C interface, loaded through
``ctypes``.  The build runs
on the first launch only — importing this module needs no compiler — and
lands in ``perceive_tpu_torch/_build/`` under a name keyed by a hash of the
sources and flags, so a second process loads the library without
rebuilding.  No PyTorch headers are compiled (a build takes seconds).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
# seconds the last build in this process took (None: loaded from the cache
# or not built yet) and the path of its compiler log
build_seconds = None
build_log = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build(out: Path) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = out.with_name(f"{out.stem}.{src.stem}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    logs, failed = [], []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        logs.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{text[-4000:]}")
    tmp = out.with_suffix(f".{tag}")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stderr[-4000:]}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = out.with_suffix(".log")
    log.write_text("\n".join(logs))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    build_seconds = time.perf_counter() - t0
    build_log = log


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f, z = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
    lib.perceive_scan_flat_rows.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p, p]
    lib.perceive_scan_flat_rows.restype = i
    lib.perceive_scan_topk_slab.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p]
    lib.perceive_scan_topk_slab.restype = i
    lib.perceive_scan_slab_bf16.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p]
    lib.perceive_scan_slab_bf16.restype = i
    lib.perceive_scan_flat_int8t.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p, p]
    lib.perceive_scan_flat_int8t.restype = i
    lib.perceive_scan_topk_int8t_slab.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p]
    lib.perceive_scan_topk_int8t_slab.restype = i
    lib.perceive_scan_flat_int4.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p, p]
    lib.perceive_scan_flat_int4.restype = i
    lib.perceive_keys_select_workspace.argtypes = [i, i]
    lib.perceive_keys_select_workspace.restype = z
    lib.perceive_scan_slab_int4.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p]
    lib.perceive_scan_slab_int4.restype = i
    lib.perceive_int2_scores.argtypes = [p, i, p, p, p, p, p, i, i, i, i, p, p]
    lib.perceive_int2_scores.restype = i
    lib.perceive_int2_tiletop.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, p, p, p]
    lib.perceive_int2_tiletop.restype = i
    lib.perceive_select_topk.argtypes = [p, i, i, i, p, p, p, p, p]
    lib.perceive_select_topk.restype = i
    lib.perceive_select_topk_workspace.argtypes = [i, i]
    lib.perceive_select_topk_workspace.restype = z
    lib.perceive_scan_topk_max_k.argtypes = []
    lib.perceive_scan_topk_max_k.restype = i
    lib.perceive_scan_topk_max_dim.argtypes = []
    lib.perceive_scan_topk_max_dim.restype = i
    lib.perceive_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
    lib.perceive_attention.restype = i
    lib.perceive_attention_smem.argtypes = [i, i, i]
    lib.perceive_attention_smem.restype = z
    lib.perceive_cuda_error_string.argtypes = [i]
    lib.perceive_cuda_error_string.restype = ctypes.c_char_p


def library_path() -> Path:
    """Where the kernel library of today's sources is built."""
    return BUILD_DIR / f"libperceive_kernels_{source_key()}.so"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            _declare(lib)
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().perceive_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def stream_of(t) -> int:
    """The current stream of a CUDA tensor's device, as the C side takes it
    (the raw handle, without building a ``torch.cuda.Stream``: a text
    query's scan launches in well under a millisecond)."""
    import torch

    index = t.device.index
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device() if index is None else index)
