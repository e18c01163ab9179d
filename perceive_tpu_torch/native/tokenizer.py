"""The compiled tokenizer: ``tokenizer.cpp`` built by g++ and bound through
ctypes.

``NativeTokenizer(plain)`` is built from a plain pipeline object, a
``models.tokenize.WordPieceTokenizer`` or a ``models.tokenizer_json.Pipeline``:
it serializes the tables that object has already parsed and checked (vocab,
merge ranks, pieces and scores, the charsmap, the component list) into the
engine once, so ``tokenizer.json`` is parsed in one place and whatever the
plain version refuses the engine never sees.  Each batch is one call that
holds no interpreter lock; text crosses as UTF-32 code points (lone
surrogates survive), and ids, type ids, special-token masks and offsets
(code-point indices of the original ``str``) come back as flat int32 arrays
with row splits.  The engine equals its plain version token for token; a
text that makes the plain version raise makes the engine raise the same
exception type.

The library builds at its first use, never at import: into
``perceive_tpu_torch/_build/`` under a name keyed by a hash of this
source, the C++ source, the compiler flags, ``unicodedata.unidata_version``
and the table generator's sources (``unicode_tables.source_texts``); under
an ``fcntl.flock`` on a lock file there, so that processes starting
together wait for one build; written to a temporary name and moved into
place with ``os.replace``.  There is no fallback: a failed build or load
raises RuntimeError with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
import unicodedata
import weakref
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np

from . import unicode_tables

_SRC = Path(__file__).resolve().parent / "tokenizer.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread")

MAGIC = 0x544B4E31
# error kinds of tk_result_error
E_UNK_MISSING, E_NO_UNK_ID, E_SURROGATE, E_INDEX, E_DECODE = 1, 2, 3, 4, 5
# component kinds, as tokenizer.cpp numbers them
_NORMS = {"NFD": 1, "NFKD": 2, "NFC": 3, "NFKC": 4, "StripAccents": 5, "Lowercase": 6, "Replace": 7,
          "Precompiled": 8, "BertNormalizer": 9}
_PRES = {"ByteLevel": 1, "WhitespaceSplit": 2, "Metaspace": 3}
_SCHEMES = {"always": 0, "first": 1, "never": 2}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # the g++ seconds of this process's build (None: it loaded a built library)

_p = ctypes.c_void_p
_i32p, _i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)


def source_key() -> str:
    h = hashlib.sha256(" ".join((CXX, *GXX_FLAGS)).encode())
    h.update(_SRC.read_bytes())
    h.update(unicodedata.unidata_version.encode())
    for text in unicode_tables.source_texts():
        h.update(text.encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libtokenizer_{source_key()}.so"


def _build(so: Path) -> None:
    """Generate the tables and compile, under the build directory's lock (a
    process that finds the library built by the one before it returns).
    The engine compiles while the tables are generated; the tables' own
    source compiles with the link."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "tokenizer.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return
        t0 = time.perf_counter()
        tag = f"{os.getpid()}.{threading.get_ident()}"
        decl, data = so.with_name(f"{so.stem}_tables.h"), so.with_name(f"{so.stem}_tables.cpp")
        obj, tmp = so.with_name(f"{so.stem}.{tag}.o"), so.with_name(f"{so.name}.{tag}.tmp")
        unicode_tables.write(decl, unicode_tables.declarations())
        try:
            try:
                engine = subprocess.Popen([CXX, *GXX_FLAGS, "-c", "-include", str(decl), str(_SRC), "-o", str(obj)],
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            except OSError as e:
                raise RuntimeError(f"the tokenizer library did not build ({CXX}: {e})") from e
            try:
                unicode_tables.write(data, unicode_tables.definitions())
            finally:
                _, err = engine.communicate(timeout=600)
            if engine.returncode != 0:
                raise RuntimeError(f"the tokenizer library did not build ({CXX} exited {engine.returncode}):\n{err}")
            link = subprocess.run([CXX, *GXX_FLAGS, "-shared", str(obj), str(data), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=600)
            if link.returncode != 0:
                raise RuntimeError(f"the tokenizer library did not link ({CXX} exited {link.returncode}):\n"
                                   f"{link.stderr}")
            os.replace(tmp, so)
        finally:
            obj.unlink(missing_ok=True)
            tmp.unlink(missing_ok=True)
        build_seconds = round(time.perf_counter() - t0, 2)


def library() -> ctypes.CDLL:
    """The loaded library, built first where it is missing; raises
    RuntimeError when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            raise RuntimeError(f"the tokenizer library did not load: {e}") from e
        lib.tk_unidata.restype = ctypes.c_char_p
        lib.tk_unidata.argtypes = []
        lib.tk_new.restype = _p
        lib.tk_new.argtypes = [_i32p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        lib.tk_free.restype = None
        lib.tk_free.argtypes = [_p]
        lib.tk_encode.restype = _p
        lib.tk_encode.argtypes = [_p, ctypes.c_void_p, _i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                                  ctypes.c_int32]
        lib.tk_result_tokens.restype = ctypes.c_int64
        lib.tk_result_tokens.argtypes = [_p]
        lib.tk_result_error.restype = ctypes.c_int32
        lib.tk_result_error.argtypes = [_p, _i64p]
        lib.tk_result_copy.restype = None
        lib.tk_result_copy.argtypes = [_p, _i64p, _i32p, _i32p, ctypes.c_void_p, _i32p]
        lib.tk_result_free.restype = None
        lib.tk_result_free.argtypes = [_p]
        if lib.tk_unidata().decode() != unicodedata.unidata_version:
            raise RuntimeError(f"{so} holds Unicode {lib.tk_unidata().decode()} tables; this Python has "
                               f"{unicodedata.unidata_version}")
        _lib = lib
        return _lib


# -- the program: a plain pipeline's tables as one int32 array ---------------------------


class _Program:
    def __init__(self):
        self.parts: list[np.ndarray] = []

    def ints(self, *values) -> None:
        self.parts.append(np.asarray(values, dtype=np.int64).astype(np.int32))

    def array(self, values) -> None:
        self.parts.append(np.asarray(values, dtype=np.int64).astype(np.int32).ravel())

    def doubles(self, values) -> None:
        self.parts.append(np.frombuffer(np.asarray(values, dtype="<f8").tobytes(), dtype="<i4"))

    def strs(self, items: Sequence[str]) -> None:
        """n, the n lengths in code points, then the code points."""
        self.ints(len(items))
        self.array(np.fromiter(map(len, items), np.int64, len(items)))
        self.parts.append(np.frombuffer("".join(items).encode("utf-32-le", "surrogatepass"), dtype="<i4"))

    def ids(self, table: dict) -> None:
        """A str -> id table: its strings, then their ids in order."""
        self.strs(list(table))
        self.array(np.fromiter(table.values(), np.int64, len(table)))

    def blob(self, data: bytes) -> None:
        self.ints(len(data))
        self.parts.append(np.frombuffer(data + b"\0" * (-len(data) % 4), dtype="<i4"))

    def done(self) -> np.ndarray:
        return np.ascontiguousarray(np.concatenate(self.parts), dtype=np.int32)


def _flat(step) -> list:
    """A normalizer or pre-tokenizer as its list of components (a Sequence
    flattened: the plain Sequence of pre-tokenizers drops empty pieces
    after each step, as the engine does after every step)."""
    if step is None:
        return []
    desc = getattr(step, "native", None)
    if desc is None:
        from ..models.tokenizer_json import CharsMap

        if isinstance(step, CharsMap):
            return [("Precompiled", step)]
        raise TypeError(f"{step!r} is not a component the compiled tokenizer knows")
    if desc[0] == "Sequence":
        return [d for s in desc[1] for d in _flat(s)]
    return [desc]


def _added(w: _Program, patterns: list) -> None:
    w.strs([pat for pat, _ in patterns])
    for _, tok in patterns:
        w.ints(tok.id, tok.single_word, tok.lstrip, tok.rstrip)


def program(plain) -> np.ndarray:
    """The engine's program for one plain pipeline object."""
    from ..models import tokenizer_json as tj
    from ..models.tokenize import WordPieceTokenizer

    w = _Program()
    w.ints(MAGIC)
    if isinstance(plain, WordPieceTokenizer):
        w.ints(0, plain.lowercase, plain.unk_id, plain.cls_id, plain.sep_id, plain.max_chars)
        w.strs([plain.prefix])
        w.ids(plain.vocab)
    elif isinstance(plain, tj.Pipeline):
        w.ints(1)
        norms = _flat(plain.normalizer)
        w.ints(len(norms))
        for d in norms:
            kind = d[0]
            w.ints(_NORMS[kind])
            if kind == "Replace":
                w.strs([d[1]])
                w.strs([d[2]])
            elif kind == "Precompiled":
                w.ints(len(d[1].units))
                w.array(np.asarray(d[1].units, dtype=np.uint32).view(np.int32))
                w.blob(d[1].normalized)
            elif kind == "BertNormalizer":
                w.ints(d[1])
        pres = _flat(plain.pre_tokenizer)
        w.ints(len(pres))
        for d in pres:
            w.ints(_PRES[d[0]])
            if d[0] == "ByteLevel":
                w.ints(d[1], d[2])
                w.array([ord(tj.BYTES_CHAR[b]) for b in range(256)])
            elif d[0] == "Metaspace":
                w.strs([d[1]])
                w.ints(_SCHEMES[d[2]], d[3])
        model = plain.model
        if isinstance(model, tj.BPE):
            w.ints(1)
            w.ids(model.vocab)
            w.ints(model.unk_token is not None, -1 if model.unk_id is None else model.unk_id, model.fuse_unk,
                   model.ignore_merges)
            w.strs([model.prefix])
            w.strs([model.suffix])
            w.ints(len(model.merges))
            w.array([(a, b, rank, new) for (a, b), (rank, new) in model.merges.items()])
            w.strs(list(model.vocab_r.values()))
            w.array(list(model.vocab_r.keys()))
        elif isinstance(model, tj.Unigram):
            w.ints(2)
            w.ids(model.vocab)
            w.strs(list(model.scored))
            w.array([i for i, _ in model.scored.values()])
            w.doubles([s for _, s in model.scored.values()])
            w.ints(-1 if model.unk_id is None else model.unk_id)
            w.doubles([model.min_score - model.UNK_PENALTY])
            w.ints(model.max_len)
        else:
            raise TypeError(f"{type(model).__name__} is not a model the compiled tokenizer knows")
        post = plain.post
        w.ints(-1 if post.trim is None else int(post.trim), ord(tj.BYTES_CHAR[ord(" ")]))
        w.ints(len(post.pre), *(x for p in post.pre for x in p))
        w.ints(len(post.suf), *(x for p in post.suf for x in p))
        w.ints(post.type_id)
        _added(w, plain._raw)
        _added(w, plain._normalized)
    else:
        raise TypeError(f"{type(plain).__name__} is not a pipeline the compiled tokenizer knows")
    w.ints(MAGIC)
    return w.done()


# -- the engine -------------------------------------------------------------------------


class Encoded(NamedTuple):
    """A batch's encodings as flat arrays: text r's tokens are
    ``splits[r]:splits[r + 1]``; ``offsets`` is (tokens, 2)."""

    splits: np.ndarray
    ids: np.ndarray
    type_ids: np.ndarray
    special: np.ndarray
    offsets: np.ndarray

    def rows_cols(self) -> tuple[np.ndarray, np.ndarray]:
        """Each token's row and position in its row."""
        lens = np.diff(self.splits)
        rows = np.repeat(np.arange(len(lens)), lens)
        return rows, np.arange(len(self.ids)) - self.splits[rows]


class NativeTokenizer:
    """The compiled engine over one plain pipeline's tables.  Thread-safe:
    the tables are immutable, each call has its own state.  ``threads``:
    how many threads one large batch may be split over (the output does not
    depend on it)."""

    def __init__(self, plain, threads: Optional[int] = None):
        lib = library()
        prog = program(plain)
        err = ctypes.create_string_buffer(256)
        handle = lib.tk_new(prog.ctypes.data_as(_i32p), prog.size, err, len(err))
        if not handle:
            raise RuntimeError(f"the tokenizer engine refused its program: {err.value.decode()}")
        self._lib, self._handle = lib, handle
        self._finalizer = weakref.finalize(self, lib.tk_free, handle)
        self.plain = plain
        self.threads = threads or min(8, os.cpu_count() or 1)

    def encode_arrays(self, texts: Sequence[str], *, add_special_tokens: bool = True,
                      max_length: Optional[int] = None) -> Encoded:
        """One engine call for the whole batch."""
        lib = self._lib
        n = len(texts)
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.fromiter(map(len, texts), np.int64, n), out=starts[1:])
        cps = np.frombuffer("".join(texts).encode("utf-32-le", "surrogatepass") or b"\0\0\0\0", dtype=np.uint32)
        res = lib.tk_encode(self._handle, cps.ctypes.data, starts.ctypes.data_as(_i64p), n, int(add_special_tokens),
                            -1 if max_length is None else int(max_length), int(self.threads))
        if not res:
            raise MemoryError("the tokenizer engine could not allocate its result")
        try:
            index = ctypes.c_int64()
            kind = lib.tk_result_error(res, ctypes.byref(index))
            if kind:
                raise self._error(kind, texts[index.value])
            total = lib.tk_result_tokens(res)
            out = Encoded(np.empty(n + 1, np.int64), np.empty(total, np.int32), np.empty(total, np.int32),
                          np.empty(total, np.int8), np.empty((total, 2), np.int32))
            lib.tk_result_copy(res, out.splits.ctypes.data_as(_i64p), out.ids.ctypes.data_as(_i32p),
                               out.type_ids.ctypes.data_as(_i32p), out.special.ctypes.data,
                               out.offsets.ctypes.data_as(_i32p))
        finally:
            lib.tk_result_free(res)
        return out

    def encode_batch(self, texts: Sequence[str], *, add_special_tokens: bool = True,
                     max_length: Optional[int] = None, offsets: bool = True) -> list:
        """``models.tokenize.Encoding`` of each text (lists, as the plain
        versions give them).  ``offsets=False`` leaves every offset (0, 0),
        as the tokenizers library's ``encode_batch_fast`` does: building the
        tuples is most of this call's Python time."""
        from ..models.tokenize import Encoding

        e = self.encode_arrays(texts, add_special_tokens=add_special_tokens, max_length=max_length)
        ids, type_ids, special = e.ids.tolist(), e.type_ids.tolist(), e.special.tolist()
        at = e.splits.tolist()
        if not offsets:
            return [Encoding(ids[a:b], type_ids[a:b], [(0, 0)] * (b - a), special[a:b]) for a, b in zip(at, at[1:])]
        spans = list(zip(e.offsets[:, 0].tolist(), e.offsets[:, 1].tolist()))
        return [Encoding(ids[a:b], type_ids[a:b], spans[a:b], special[a:b]) for a, b in zip(at, at[1:])]

    def encode(self, text: str, *, add_special_tokens: bool = True, max_length: Optional[int] = None):
        return self.encode_batch([text], add_special_tokens=add_special_tokens, max_length=max_length)[0]

    def _error(self, kind: int, text: str) -> Exception:
        """The exception the plain version raises on ``text``."""
        if kind == E_UNK_MISSING:
            return ValueError(f"tokenizer.json: the unk_token {self.plain.model.unk_token!r} is not in the vocabulary")
        if kind == E_NO_UNK_ID:
            return ValueError("tokenizer.json: a Unigram model with no unk_id met an unknown char")
        if kind == E_SURROGATE:
            at = next((i for i, c in enumerate(text) if "\ud800" <= c <= "\udfff"), 0)
            return UnicodeEncodeError("utf-8", text, at, at + 1, "surrogates not allowed")
        if kind == E_INDEX:
            return IndexError("the charsmap or an alignment indexes past its end")
        if kind == E_DECODE:
            return UnicodeDecodeError("utf-8", b"", 0, 0, "a charsmap replacement is not UTF-8")
        return RuntimeError(f"the tokenizer engine failed (error kind {kind})")
