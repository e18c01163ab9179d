"""Native (C++) host-runtime components, bound via ctypes.

Port of perceive_tpu/native/__init__.py: ``fastwalk`` — the parallel
gitignore-aware directory walker (reference `ignore` crate, fs.rs:42-45),
used by the fs connector's scan.  The compiled tokenizer, which builds the
same way but has no fallback, is ``native.tokenizer``.

The shared object builds with g++ the first time it's needed, into
``perceive_tpu_torch/_build/`` under a name keyed by a hash of the source
and flags (as ``ops/_cuda.py`` keys the kernel library), written to a
temporary name and moved into place with ``os.replace`` so that processes
building at the same moment never load a partial file.  Every consumer
falls back to the pure-Python walk when no toolchain is available: this is
a host helper, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "fastwalk.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libfastwalk_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
            capture_output=True, text=True, timeout=120,
        )
    except (OSError, subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return False
    if proc.returncode != 0:
        print(f"fastwalk build failed:\n{proc.stderr}", file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.fw_walk.restype = ctypes.POINTER(ctypes.c_char)
        lib.fw_walk.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.fw_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        _lib = lib
        return _lib


def fastwalk_available() -> bool:
    return _load() is not None


def fastwalk(
    root: str, *, threads: int = 8, respect_gitignore: bool = True
) -> Optional[list[tuple[str, int, int]]]:
    """Walk ``root`` in parallel; [(path, mtime, atime)] for regular files,
    hidden and gitignored entries pruned.  None when the native library is
    unavailable (callers use the Python walk)."""
    lib = _load()
    if lib is None:
        return None
    out_len = ctypes.c_longlong(0)
    buf = lib.fw_walk(
        os.fspath(root).encode(), int(threads), int(respect_gitignore), ctypes.byref(out_len)
    )
    if not buf:
        return None
    try:
        data = ctypes.string_at(buf, out_len.value).decode("utf-8", "surrogateescape")
    finally:
        lib.fw_free(buf)
    entries = []
    # records are "mtime\tatime\tpath\0": the NUL terminator and path-last
    # layout keep filenames containing tabs/newlines parseable
    for rec in data.split("\0"):
        if not rec:
            continue
        mtime, atime, path = rec.split("\t", 2)
        entries.append((path, int(mtime), int(atime)))
    return entries
