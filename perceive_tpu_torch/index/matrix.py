"""Device-resident embedding matrix with an id <-> row map (bf16, f32, int8,
int4 and int2 tiers).

Port of perceive_tpu/index/matrix.py for PyTorch.  One dense (capacity,
padded_dim) tensor on the device holds every embedding row, beside a
(capacity,) int32 tensor of per-row source ids (-1 for tombstones and the
unallocated tail) and, at the int8 tier, a (capacity,) f32 tensor of
per-row scales.  The int4 tier stores its rows transposed and packed, a
(padded_dim / 2, capacity) uint8 matrix (``_quantize4``), with its scales.
The int2 tier stores two matrices, both transposed: the (padded_dim / 4,
capacity) uint8 coarse matrix (``_quantize2``) and a fine companion, the
(padded_dim, capacity) int8 matrix (``_quantize``'s bytes) or, where the
device budget asks for it (``int2_fine_bits``), the int4 tier's packed
matrix, each with its (capacity,) f32 scales.  The host keeps the id maps
and an f32 mirror of the vectors; ``sync`` uploads what changed (a full
upload after growth or a retier, else the dirty rows, or columns, with
``index_copy_``).

The stored bytes and keys are the JAX package's: f32 little-endian BLOBs,
``chunk_key`` = item_id * CHUNK_STRIDE + chunk_idx, capacities a multiple
of ROW_ALIGN, widths padded to LANE_ALIGN, the same prefix-sweep ladder,
and the int8 tier's per-row symmetric quantization (``_quantize``), the
int4 tier's nibble packing (``_quantize4``) and the int2 tier's 2-bit
packing (``_quantize2``).  Snapshots are the JAX package's format v2, byte
for byte (``save_snapshot``): a zip of .npy members with the f32 rows and,
at the quantized tiers, the stored payload that ``adopt_snapshot`` copies
into the device layouts without re-quantizing; a delta file carries the
rows changed and the keys removed since its base.

Device updates happen in place on the current stream, so a sweep enqueued
before an update reads the old rows and one enqueued after reads the new
ones; ``reuse_gen`` still tells a search that a row changed owner between
its sweep and its host-side decode.
"""

from __future__ import annotations

import collections
import itertools
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

# Row and lane alignment inherited from the JAX package (TPU tiling); kept
# so both packages lay rows out alike.  Not yet measured on this card.
ROW_ALIGN = 512
LANE_ALIGN = 128

INT4 = "int4"
INT2 = "int2"

CHUNK_STRIDE = 4096

_SWEEP_ALIGN = 24576
_SWEEP_MIN = 98304


def sweep_rows_for(hwm: int, capacity: int) -> int:
    """Rows a query sweep covers: the smallest ladder value >= the live-row
    high-water mark ``hwm`` (ratio 9/8 steps), clamped to the capacity;
    small matrices sweep the whole capacity."""
    if capacity <= _SWEEP_MIN or hwm >= capacity:
        return capacity
    v = _SWEEP_MIN
    while v < hwm:
        v = _round_up(v + v // 8, _SWEEP_ALIGN)
    return min(v, capacity)


def chunk_key(item_id: int, chunk_idx: int = 0) -> int:
    if not 0 <= chunk_idx < CHUNK_STRIDE:
        raise ValueError(f"chunk_idx {chunk_idx} outside [0, {CHUNK_STRIDE})")
    return item_id * CHUNK_STRIDE + chunk_idx


def key_item(key: int) -> int:
    return key // CHUNK_STRIDE


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def auto_matrix_dtype(n_rows: int, padded_dim: int = 384):
    """Storage tier for a corpus of ``n_rows`` vectors of ``padded_dim``
    dims, by the JAX package's rule (bytes per row scale the row count by
    padded_dim/384).  The thresholds are inherited from TPU measurements
    and not yet measured on this card.  Returns torch.bfloat16 up to 1.5M
    effective rows, torch.int8 up to 4M (exact after the searcher's f32
    rerank), INT2 up to 24M (coarse-to-fine, reranked likewise), then INT4
    (packed 4-bit, reranked likewise)."""
    eff = n_rows * max(padded_dim, 1) / 384.0
    if eff <= 1_500_000:
        return torch.bfloat16
    if eff <= 4_000_000:
        return torch.int8
    if eff <= 24_000_000:
        return INT2
    return INT4


def serialize_embedding(vec: np.ndarray) -> bytes:
    """f32 little-endian BLOB, the stored form of every embedding."""
    return np.ascontiguousarray(vec, dtype="<f4").tobytes()


def deserialize_embedding(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, dtype="<f4").copy()


def _mem_available_bytes() -> Optional[int]:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def _mirror_ram_budget() -> int:
    """Bytes the host mirror may hold in RAM before spilling to a memory
    mapped file (PERCEIVE_TPU_MIRROR_RAM_GB overrides; default half of
    MemAvailable, clamped to [8, 64] GiB)."""
    env = os.environ.get("PERCEIVE_TPU_MIRROR_RAM_GB")
    if env is not None:
        try:
            return int(float(env) * 2**30)
        except ValueError:
            pass
    avail = _mem_available_bytes()
    if avail is None:
        return 8 * 2**30
    return max(8 * 2**30, min(avail // 2, 64 * 2**30))


def _mirror_spill_dir() -> Optional[str]:
    """Directory for spilled mirror files (PERCEIVE_TPU_MIRROR_DIR, default
    the app data dir, never the possibly RAM-backed temp dir)."""
    env = os.environ.get("PERCEIVE_TPU_MIRROR_DIR")
    if env:
        os.makedirs(env, exist_ok=True)
        return env
    try:
        from ..paths import data_dir

        return str(data_dir())
    except OSError:
        return None


def _mirror_np_dtype():
    """Host mirror element dtype (PERCEIVE_TPU_MIRROR_DTYPE: float32, or
    bfloat16 through ml_dtypes where that package is installed)."""
    name = os.environ.get("PERCEIVE_TPU_MIRROR_DTYPE", "float32").lower()
    if name in ("bf16", "bfloat16"):
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(np.float32)


class HostMirror:
    """Host-side mirror of the vector matrix (growth and exact reads go
    through it).  Starts in RAM and spills to a memory-mapped file once it
    would exceed the RAM budget; growth of a spilled mirror extends the file
    in place.  ``self.arr`` is replaced atomically, so lock-free readers see
    either the old or the new array, never a partial one."""

    def __init__(
        self,
        capacity: int,
        width: int,
        *,
        dtype: Optional[np.dtype] = None,
        ram_budget: Optional[int] = None,
        dir: Optional[str] = None,
    ):
        self.width = width
        self.dtype = np.dtype(dtype) if dtype is not None else _mirror_np_dtype()
        self.ram_budget = ram_budget if ram_budget is not None else _mirror_ram_budget()
        self.dir = dir
        self.path: Optional[str] = None  # set once spilled to disk
        self.arr = self._alloc(capacity)

    def _nbytes(self, capacity: int) -> int:
        return capacity * self.width * self.dtype.itemsize

    def _alloc(self, capacity: int) -> np.ndarray:
        if self._nbytes(capacity) <= self.ram_budget:
            return np.zeros((capacity, self.width), dtype=self.dtype)
        import tempfile

        fd, path = tempfile.mkstemp(
            suffix=".mirror", dir=self.dir if self.dir is not None else _mirror_spill_dir()
        )
        os.close(fd)
        self.path = path
        return np.memmap(path, dtype=self.dtype, mode="w+", shape=(capacity, self.width))

    def grow(self, new_cap: int) -> None:
        old = self.arr
        old_cap = old.shape[0]
        if self.path is None:
            if self._nbytes(new_cap) <= self.ram_budget:
                new = np.zeros((new_cap, self.width), dtype=self.dtype)
            else:
                new = self._alloc(new_cap)  # spill: RAM -> file-backed
            new[:old_cap] = old
            self.arr = new
            return
        old.flush()
        os.truncate(self.path, self._nbytes(new_cap))
        self.arr = np.memmap(self.path, dtype=self.dtype, mode="r+", shape=(new_cap, self.width))

    def read_f32(self, rows, ncols: Optional[int] = None) -> np.ndarray:
        """Rows (fancy index or slice) as an f32 COPY, first ``ncols``
        columns — never a view of the live buffer."""
        idx = rows if isinstance(rows, slice) else np.asarray(rows)
        if isinstance(idx, slice) or idx.dtype == bool:
            sel = self.arr[rows] if ncols is None else self.arr[rows, :ncols]
            return np.array(sel, dtype=np.float32, copy=True)
        # a gather copies already: a whole-row take, then the columns (a
        # second copy of a mixed index costs the rerank about 3x)
        sel = self.arr.take(idx.astype(np.intp, copy=False), axis=0)
        if ncols is not None and ncols < sel.shape[1]:
            sel = sel[:, :ncols]
        return np.ascontiguousarray(sel, dtype=np.float32)

    def write(self, rows, vals_f32: np.ndarray, dim: int) -> None:
        """Store f32 vectors (first ``dim`` columns; the pad tail stays 0)."""
        self.arr[rows, :dim] = vals_f32
        if self.width > dim:
            self.arr[rows, dim:] = 0.0

    def remap(self) -> None:
        """Flush and re-map a file-backed mirror, dropping the page
        residency a bulk build accumulated."""
        if self.path is None:
            return
        shape = self.arr.shape
        self.arr.flush()
        self.arr = np.memmap(self.path, dtype=self.dtype, mode="r+", shape=shape)

    def close(self) -> None:
        if self.path is not None:
            try:
                del self.arr
                os.unlink(self.path)
            except OSError:
                pass
            self.path = None

    def __del__(self):  # best-effort temp-file cleanup
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


# bytes per chunk of the adopt's mirror copy (_mirror_copy_from)
_MIRROR_COPY_CHUNK_BYTES = 64 * 2**20

# rows a transposed copy moves at a time: numpy's strided copy of a whole
# (1M, 384) int8 chunk into (384, N) columns runs about 15x slower
_TRANSPOSE_BLOCK_ROWS = 8192


# threads of the chunked host passes over the mirror (a full upload's
# quantizers, a snapshot's payload, a retier's statistics): numpy releases
# the GIL in them, and each chunk is computed as it would be on one thread
_HOST_WORKERS = min(8, os.cpu_count() or 1)


def _ordered_map(fn, items):
    """``fn(item)`` for each of ``items`` on up to _HOST_WORKERS threads,
    yielded in order, at most two a worker ahead of the consumer; ``items``
    is drawn from in the consumer's thread."""
    it = iter(items)
    if _HOST_WORKERS <= 1:
        yield from map(fn, it)
        return
    with ThreadPoolExecutor(_HOST_WORKERS) as ex:
        pending = collections.deque(ex.submit(fn, x) for x in itertools.islice(it, 2 * _HOST_WORKERS))
        while pending:
            res = pending.popleft().result()
            pending.extend(ex.submit(fn, x) for x in itertools.islice(it, 1))
            yield res


def _put_transposed(dst: np.ndarray, lo: int, rows: np.ndarray) -> None:
    """``dst[:, lo:lo + len(rows)] = rows.T``, a block of rows at a time."""
    for b in range(0, len(rows), _TRANSPOSE_BLOCK_ROWS):
        blk = rows[b : b + _TRANSPOSE_BLOCK_ROWS]
        dst[:, lo + b : lo + b + len(blk)] = blk.T


class SnapshotDeviceError(RuntimeError):
    """Copying an adopted snapshot's payload to the device failed.  Unlike a
    corrupt or foreign file, which falls back to a load from SQLite, this
    is a fault of the device (out of memory, a layout the checks missed)
    and reaches the caller."""


_STORED_DTYPES = (torch.bfloat16, torch.float32, torch.int8, INT4, INT2)


def _check_stored(dtype) -> None:
    if not any(dtype == t for t in _STORED_DTYPES):
        raise ValueError(f"unknown storage tier {dtype!r}; one of {_STORED_DTYPES}")


def _int2_fine_int8_budget(device: torch.device) -> int:
    """Device bytes the int2 tier's coarse + int8 companion pair may take
    (the JAX package's rule): PERCEIVE_TPU_INT2_FINE_INT8_GB, else 64% of
    the CUDA device's memory, else 10 GB."""
    env = os.environ.get("PERCEIVE_TPU_INT2_FINE_INT8_GB")
    if env is not None:
        try:
            return int(float(env) * 2**30)
        except ValueError:
            pass
    if device.type == "cuda":
        return int(0.64 * torch.cuda.mem_get_info(device)[1])
    return 10 * 2**30


def int2_fine_bits(capacity: int, padded_dim: int, device: torch.device, row_shards: int = 1) -> int:
    """Width of the int2 tier's fine companion, by the JAX package's policy:
    8 while coarse (0.25 B/dim) + int8 (1 B/dim) fit the budget, else 4
    (packed int4, the int4 tier's bytes); PERCEIVE_TPU_INT2_FINE = int8 |
    int4 pins it.  On an 80 GB card the budget holds about 113M rows of
    capacity at 384 dims.  ``row_shards``: the slots the rows are sharded
    over (``EmbeddingMatrix.row_shards``); the budget is one device's, so a
    sharded matrix compares one shard's capacity.  Slots that share a card
    each get the whole card's budget (a limit past ~113M rows a card)."""
    env = os.environ.get("PERCEIVE_TPU_INT2_FINE", "auto").lower()
    if env in ("int8", "8"):
        return 8
    if env in ("int4", "4"):
        return 4
    per_shard = -(-capacity // max(row_shards, 1))
    return 8 if per_shard * padded_dim * 1.25 <= _int2_fine_int8_budget(device) else 4


def _quantize(rows_f32: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8, byte for byte the JAX package's: scale =
    max|v| / 127 (min-clamped so all-zero rows stay representable), values
    rint(v / scale) clipped to [-127, 127].  Returns (int8 values, f32
    scales)."""
    scales = np.maximum(np.abs(rows_f32).max(axis=1), 1e-12) / 127.0
    q = np.clip(np.rint(rows_f32 / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales.astype(np.float32)


def _quantize4(rows_f32: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int4 packed two dims a byte, byte for byte the JAX
    package's: scale = max|v| / 7 (min-clamped), values rint(v / scale)
    clipped to [-7, 7]; byte j of the D = rows_f32.shape[1] padded dims
    holds dim j in the low nibble biased +8 (range [1, 15]) and dim j + D/2
    in the high nibble, two's complement.  Returns ((n, D/2) uint8, (n,)
    f32 scales); the device stores the transpose."""
    scales = np.maximum(np.abs(rows_f32).max(axis=1), 1e-12) / 7.0
    q = np.clip(np.rint(rows_f32 / scales[:, None]), -7, 7).astype(np.int8)
    d2 = rows_f32.shape[1] // 2
    lo = (q[:, :d2] + 8).astype(np.uint8)
    hi = (q[:, d2:] & 15).astype(np.uint8)
    return lo | (hi << 4), scales.astype(np.float32)


def _quantize2(rows_f32: np.ndarray, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-row uniform symmetric 2-bit, byte for byte the JAX package's:
    every dim snaps to {-3, -1, 1, 3} * s with s = max(rms / 2, eps), the
    rms over the first ``dim`` (unpadded) dims.  Byte j packs dims j, j+D/4,
    j+2D/4, j+3D/4 of the D = rows_f32.shape[1] padded dims: planes 0-2 as
    the crumb c (level 2c - 3), plane 3 as t = c - 2 in two's complement.
    Returns ((n, D/4) uint8, (n,) f32 scales); the device stores the
    transpose."""
    scales = np.maximum(
        np.sqrt(np.mean(rows_f32[:, :dim] ** 2, axis=1)) / 2.0, 1e-12
    )
    # pad dims quantize to a nonzero level (the grid has no 0), which is
    # harmless: queries are zero-padded, so pad lanes never score
    c = np.clip(
        np.round((rows_f32 / scales[:, None] + 3.0) / 2.0), 0, 3
    ).astype(np.uint8)
    d4 = rows_f32.shape[1] // 4
    t3 = (c[:, 3 * d4 :] - 2) & 3
    packed = (
        c[:, :d4]
        | (c[:, d4 : 2 * d4] << 2)
        | (c[:, 2 * d4 : 3 * d4] << 4)
        | (t3 << 6)
    )
    return packed, scales.astype(np.float32)


class EmbeddingMatrix:
    """Mutable device-resident vector store (bf16, f32, int8, int4 or int2
    rows).

    Host state: ``row_of`` (key -> row), ``item_ids`` / ``source_ids``
    (row -> ids), ``groups`` (item -> its chunk keys), the free-row list and
    the host mirror.  Device state: ``(capacity, padded_dim)`` vectors in
    the storage dtype, ``(capacity,)`` int32 source ids and, for int8,
    ``(capacity,)`` f32 row scales; for int4 the packed ``(padded_dim / 2,
    capacity)`` matrix and its scales; for int2 the coarse and companion
    matrices and their scales (module docstring).  All on ``device``
    (required: nothing here picks one).
    """

    def __init__(
        self,
        dim: int,
        *,
        device: torch.device | str,
        dtype: torch.dtype = torch.bfloat16,
        capacity: int = 4096,
        row_align: int = ROW_ALIGN,
    ):
        _check_stored(dtype)
        self.dim = dim
        self.padded_dim = _round_up(dim, LANE_ALIGN)
        self.dtype = dtype
        self.row_align = row_align
        self.capacity = _round_up(max(capacity, row_align), row_align)
        self.device = torch.device(device)
        self._lock = threading.RLock()
        # serializes save_snapshot as a whole (never held by queries)
        self._snapshot_io_lock = threading.Lock()

        self.rows = 0  # high-water mark of allocated rows
        self._free: list[int] = []
        # bumped whenever a freed row is handed to a new key (or rows move):
        # a search that swept before the change retries its decode
        self.reuse_gen = 0
        # bumped on every logical change (upsert, remove, compaction,
        # retier): a result cache keyed on it is valid while it stands
        self.mutation_gen = 0
        # high-water quantization stats for the rerank escalation margin:
        # the largest per-dim quantization step and the largest row norm
        # ever upserted at a quantized tier (never lowered on remove)
        self.scale_hw = 0.0
        self.norm_hw = 0.0
        # int2 tier only, set by the searcher's corpus self-audit
        # (Searcher.audit_coarse): whether the coarse pass may serve queries
        # (False routes every query to the companion sweep), the coarse
        # select (ops.int2.SELECTS: "exact", the audit's verdict, or
        # "tiletop", "window" or "threshold" pinned by a caller, with a
        # mutation_gen bump under the lock, until the next audit resets
        # it), and the adaptive coarse depth (0 = ops.int2.INT2_COARSE_FETCH)
        self.coarse_trusted = True
        self.coarse_select = "exact"
        self.coarse_fetch = 0
        self.row_of: dict[int, int] = {}
        # item id -> set of chunk keys (only for items with a non-zero chunk)
        self.groups: dict[int, set[int]] = {}
        self.multi_chunk_groups = 0
        self.item_ids = np.full(self.capacity, -1, dtype=np.int64)
        self.source_ids = np.full(self.capacity, -1, dtype=np.int32)
        self._mirror = HostMirror(self.capacity, self.padded_dim)
        self._dirty = True  # full upload needed (first sync / growth)
        self._dirty_rows: set[int] = set()
        # rows changed and keys removed since the last full snapshot (the
        # delta form); None = too much churn, the next save is a full base
        self._delta_rows: Optional[set[int]] = set()
        self._delta_removed: set[int] = set()
        self._device_vectors: Optional[torch.Tensor] = None
        self._device_source_ids: Optional[torch.Tensor] = None
        self._device_scales: Optional[torch.Tensor] = None  # int8, int4 and int2 tiers
        # int2 tier only: the (padded_dim, capacity) int8 companion or the
        # (padded_dim / 2, capacity) packed int4 one, and its scales
        self._device_fine: Optional[torch.Tensor] = None
        self._device_fine_scales: Optional[torch.Tensor] = None

    @property
    def packed4(self) -> bool:
        return isinstance(self.dtype, str) and self.dtype == INT4

    @property
    def packed2(self) -> bool:
        return isinstance(self.dtype, str) and self.dtype == INT2

    @property
    def quantized(self) -> bool:
        return self.packed4 or self.packed2 or self.dtype == torch.int8

    @property
    def quant_bits(self) -> int:
        """Bits per stored dim on the sweep path: 2 (coarse-to-fine), 4
        (packed), 8 (int8), 0 (not quantized)."""
        if self.packed2:
            return 2
        return 4 if self.packed4 else (8 if self.quantized else 0)

    @property
    def fine_bits(self) -> int:
        """Int2 tier only: width of the fine companion, 8 or 4 (the stored
        one once staged, else the ``int2_fine_bits`` policy); 0 for every
        other tier."""
        if not self.packed2:
            return 0
        if self._device_fine is not None:
            return 8 if self._device_fine.dtype == torch.int8 else 4
        return int2_fine_bits(self.capacity, self.padded_dim, self.device, self.row_shards)

    @property
    def row_shards(self) -> int:
        """Slots the rows are sharded over (ShardedEmbeddingMatrix); 1 here."""
        return 1

    # -- device views -------------------------------------------------------

    # rows per host->device chunk of a full upload (~100 MB of f32 at 384-d)
    _SYNC_CHUNK_ROWS = 65_536

    def sync(self) -> None:
        """Upload host state to the device if anything changed: the whole
        matrix after growth (chunked, so no corpus-sized host temporary),
        else only the dirty rows."""
        with self._lock:
            if not self._dirty and not self._dirty_rows:
                return
            full = (
                self._dirty
                or self._device_vectors is None
                or len(self._dirty_rows) * 4 > self.rows
            )
            if full and (self.packed2 or self.packed4):
                self._stage_full_transposed()
                self._device_source_ids = self._place(self.source_ids.copy())
                self._mirror.remap()
            elif full:
                self._device_vectors = self._device_scales = None  # release before allocating anew
                vecs = self._empty((self.padded_dim,), self.dtype)
                scales = self._empty((), torch.float32) if self.quantized else None

                def staged(lo):
                    hi = min(lo + self._SYNC_CHUNK_ROWS, self.capacity)
                    return lo, hi, *self._staged(self._mirror.read_f32(slice(lo, hi)))

                for lo, hi, chunk, sc in _ordered_map(staged, range(0, self.capacity, self._SYNC_CHUNK_ROWS)):
                    self._write_rows(vecs, lo, chunk)
                    if scales is not None:
                        self._write_rows(scales, lo, sc)
                self._device_vectors, self._device_scales = vecs, scales
                self._device_source_ids = self._place(self.source_ids.copy())
                self._mirror.remap()
            else:
                rows = np.fromiter(self._dirty_rows, dtype=np.int64)
                if self.packed2 or self.packed4:  # columns of the transposed matrices
                    vals = self._mirror.read_f32(rows)
                    if self.packed4:
                        parts = [(self._device_vectors, self._device_scales, *_quantize4(vals))]
                    else:
                        fine = _quantize(vals) if self.fine_bits == 8 else _quantize4(vals)
                        parts = [(self._device_vectors, self._device_scales, *_quantize2(vals, self.dim)),
                                 (self._device_fine, self._device_fine_scales, *fine)]
                    for dst, dst_scales, cols, sc in parts:
                        self._index_copy(dst, 1, rows, torch.from_numpy(np.ascontiguousarray(cols.T)))
                        self._index_copy(dst_scales, 0, rows, torch.from_numpy(sc))
                else:
                    vals, sc = self._staged(self._mirror.read_f32(rows))
                    self._index_copy(self._device_vectors, 0, rows, vals)
                    if sc is not None:
                        self._index_copy(self._device_scales, 0, rows, sc)
                self._index_copy(self._device_source_ids, 0, rows, torch.from_numpy(self.source_ids[rows].copy()))
            self._dirty = False
            self._dirty_rows.clear()

    def _stage_full_transposed(self) -> None:
        """Full upload of the transposed tiers: the mirror quantizes, in row
        chunks, into the packed int4 matrix (int4 tier) or into the coarse
        matrix and its companion (int2 tier: int8, or packed int4 with the
        int4 tier's bytes, as ``int2_fine_bits`` decides now), host arrays
        then one copy each to the device."""
        cap, chunk, d = self.capacity, self._SYNC_CHUNK_ROWS, self.padded_dim
        self._device_vectors = self._device_scales = None  # release before allocating anew
        self._device_fine = self._device_fine_scales = None
        # (quantizer, packed width, byte type) of the sweep matrix, then of
        # the int2 tier's companion
        if self.packed4:
            layouts = [(_quantize4, d // 2, np.uint8)]
        else:
            layouts = [(lambda v: _quantize2(v, self.dim), d // 4, np.uint8),
                       (_quantize, d, np.int8) if int2_fine_bits(cap, d, self.device, self.row_shards) == 8
                       else (_quantize4, d // 2, np.uint8)]
        staged = [(np.empty((width, cap), dtype=dt), np.empty((cap,), np.float32)) for _, width, dt in layouts]

        def stage(lo):  # disjoint columns of the host arrays
            hi = min(lo + chunk, cap)
            vals = self._mirror.read_f32(slice(lo, hi))
            for (quantize, _, _), (m, sc) in zip(layouts, staged):
                packed, sc[lo:hi] = quantize(vals)
                _put_transposed(m, lo, packed)

        for _ in _ordered_map(stage, range(0, cap, chunk)):
            pass
        (m, sc), *companion = [(self._place(m, 1), self._place(sc)) for m, sc in staged]
        self._device_vectors, self._device_scales = m, sc
        if companion:
            self._device_fine, self._device_fine_scales = companion[0]

    def _staged(self, rows_f32: np.ndarray):
        """Host f32 rows -> (rows in the storage dtype, f32 scales or None)
        as CPU tensors."""
        if self.quantized:
            q, scales = _quantize(rows_f32)
            return torch.from_numpy(q), torch.from_numpy(scales)
        return torch.from_numpy(rows_f32).to(self.dtype), None

    # -- placement: one device here; ShardedEmbeddingMatrix splits the
    # capacity axis of every device tensor over its slots ------------------

    def _place(self, arr: np.ndarray, axis: int = 0, adopted: bool = False):
        """A host array whose ``axis`` is the capacity, on the device; the
        arrays of an adopted snapshot raise SnapshotDeviceError on failure."""
        return _to_device(arr, self.device) if adopted else torch.from_numpy(arr).to(self.device)

    def _empty(self, tail: tuple, dtype):
        """An uninitialized (capacity, *tail) device tensor."""
        return torch.empty((self.capacity, *tail), dtype=dtype, device=self.device)

    def _write_rows(self, dst, lo: int, vals: torch.Tensor) -> None:
        """Rows lo .. lo + len(vals) of a row-major device tensor, from host rows."""
        dst[lo : lo + len(vals)].copy_(vals)

    def _index_copy(self, dst, axis: int, rows: np.ndarray, vals: torch.Tensor) -> None:
        """``dst.index_copy_(axis, rows, vals)`` from host rows and values."""
        dst.index_copy_(axis, torch.from_numpy(rows).to(self.device), vals.to(self.device))

    def device_view(self):
        """(vectors, source_ids, scales) device tensors, synced, captured
        under the lock; scales is None below the int8 tier.  At the int4
        tier vectors is the packed (padded_dim / 2, capacity) matrix; at the
        int2 tier vectors and scales are (coarse, companion) pairs.  A
        sharded matrix gives a list of per-shard tensors in place of each."""
        with self._lock:
            self.sync()
            if self.packed2:
                return ((self._device_vectors, self._device_fine), self._device_source_ids,
                        (self._device_scales, self._device_fine_scales))
            return self._device_vectors, self._device_source_ids, self._device_scales

    @property
    def sweep_rows(self) -> int:
        """Row count a query sweep must cover (prefix of the capacity)."""
        return sweep_rows_for(self.rows, self.capacity)

    def host_vectors_for(self, rows) -> np.ndarray:
        """f32 host mirror rows, copied under the lock."""
        with self._lock:
            return self._mirror.read_f32(rows, self.dim)

    @property
    def _host_vectors(self) -> np.ndarray:
        return self._mirror.arr

    @property
    def tier_name(self) -> str:
        """``bfloat16``, ``float32``, ``int8``, ``int4``, ``int2+int8fine``
        or ``int2+int4fine``."""
        name = str(self.dtype).removeprefix("torch.")
        return f"{name}+int{self.fine_bits}fine" if self.packed2 else name

    # -- mutation ------------------------------------------------------------

    def _grow(self, need: int) -> None:
        new_cap = self.capacity
        while new_cap < need:
            new_cap *= 2
        if new_cap == self.capacity:
            return
        self._dirty = True
        self.item_ids = np.concatenate(
            [self.item_ids, np.full(new_cap - self.capacity, -1, dtype=np.int64)]
        )
        self.source_ids = np.concatenate(
            [self.source_ids, np.full(new_cap - self.capacity, -1, dtype=np.int32)]
        )
        self._mirror.grow(new_cap)
        self.capacity = new_cap

    def upsert(self, item_ids: Sequence[int], source_ids: Sequence[int], vectors: np.ndarray) -> None:
        """Insert or overwrite a batch of rows keyed by chunk key."""
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected (N, {self.dim}) vectors, got {vectors.shape}")
        item_ids = np.asarray(list(item_ids), dtype=np.int64)
        source_ids = np.asarray(list(source_ids), dtype=np.int32)
        uniq = np.unique(item_ids)
        if len(uniq) < len(item_ids):  # dedupe within batch, keep last occurrence
            last = {int(i): idx for idx, i in enumerate(item_ids)}
            keep = np.fromiter(last.values(), dtype=np.int64)
            item_ids, source_ids, vectors = item_ids[keep], source_ids[keep], vectors[keep]
        with self._lock:
            self._grow(self.rows + max(0, len(item_ids) - len(self._free)))
            get = self.row_of.get
            rows = np.fromiter(
                (get(int(i), -1) for i in item_ids), dtype=np.int64, count=len(item_ids)
            )
            new = rows < 0
            n_new = int(new.sum())
            if n_new:
                n_reuse = min(len(self._free), n_new)
                if n_reuse:
                    self.reuse_gen += 1
                reused = self._free[len(self._free) - n_reuse :]
                del self._free[len(self._free) - n_reuse :]
                fresh = np.concatenate(
                    [
                        np.asarray(reused, dtype=np.int64),
                        np.arange(self.rows, self.rows + n_new - n_reuse, dtype=np.int64),
                    ]
                )
                rows[new] = fresh
                self.rows += n_new - n_reuse
                self.row_of.update(zip(item_ids[new].tolist(), fresh.tolist()))
            for k in item_ids.tolist():
                iid = k // CHUNK_STRIDE
                g = self.groups.get(iid)
                if g is None:
                    k0 = iid * CHUNK_STRIDE
                    if k == k0:
                        continue  # single chunk-0 item: implicit group
                    g = {k0} if k0 in self.row_of else set()
                    self.groups[iid] = g
                before = len(g)
                g.add(k)
                if before == 1 and len(g) == 2:
                    self.multi_chunk_groups += 1
            self.item_ids[rows] = item_ids
            self.source_ids[rows] = source_ids
            self._mirror.write(rows, vectors, self.dim)
            if not self._dirty:
                self._dirty_rows.update(rows.tolist())
            self._note_delta(rows)
            if len(item_ids):
                self.mutation_gen += 1
            if self.quantized and len(vectors):
                self._note_quant_stats(vectors)

    def _drop_key(self, key: int) -> None:
        g = self.groups.get(key // CHUNK_STRIDE)
        if g is not None:
            before = len(g)
            g.discard(key)
            if before == 2 and len(g) == 1:
                self.multi_chunk_groups -= 1
            if not g:
                del self.groups[key // CHUNK_STRIDE]

    def remove(self, item_ids: Sequence[int]) -> int:
        """Tombstone rows by key.  Returns how many existed."""
        n = 0
        with self._lock:
            for key in item_ids:
                row = self.row_of.pop(key, None)
                if row is not None:
                    self._drop_key(key)
                    self.source_ids[row] = -1
                    self.item_ids[row] = -1
                    if not self._dirty:
                        self._dirty_rows.add(int(row))
                    self._note_delta((int(row),))
                    self._note_removed(key)
                    self._free.append(int(row))
                    n += 1
            if n:
                self.mutation_gen += 1
            self._maybe_compact()
        return n

    # compaction trigger: tombstones outnumber live rows by this floor
    _COMPACT_MIN = 4096

    def _maybe_compact(self) -> None:
        live = len(self.row_of)
        if self.rows - live >= max(self._COMPACT_MIN, live):
            self.compact()

    def compact(self) -> int:
        """Move the live rows stranded past the live count into tombstoned
        rows below it and lower the high-water mark.  Bumps ``reuse_gen``
        like a row reuse.  Returns rows moved."""
        with self._lock:
            live = len(self.row_of)
            moved = 0
            if self.rows > live:
                srcs = live + np.nonzero(self.item_ids[live : self.rows] >= 0)[0]
                dsts = np.nonzero(self.item_ids[:live] < 0)[0][: len(srcs)]
                if len(srcs):
                    self.reuse_gen += 1
                    self.mutation_gen += 1
                    arr = self._mirror.arr
                    arr[dsts] = arr[srcs]
                    keys = self.item_ids[srcs]
                    self.item_ids[dsts] = keys
                    self.source_ids[dsts] = self.source_ids[srcs]
                    self.item_ids[srcs] = -1
                    self.source_ids[srcs] = -1
                    self.row_of.update(zip(keys.tolist(), dsts.tolist()))
                    if not self._dirty:
                        self._dirty_rows.update(dsts.tolist())
                        self._dirty_rows.update(srcs.tolist())
                    self._note_delta(dsts)
                    self._note_delta(srcs)
                    moved = len(srcs)
                self.rows = live
            self._free = [int(r) for r in np.nonzero(self.item_ids[: self.rows] < 0)[0]]
            return moved

    def _note_delta(self, rows) -> None:
        """Track rows changed since the last full snapshot; past the churn
        threshold the sets drop and the next save is a full base."""
        if self._delta_rows is None:
            return
        self._delta_rows.update(int(r) for r in rows)
        self._delta_overflow_check()

    def _note_removed(self, key: int) -> None:
        """Track a key removed since the last full snapshot: a delta must
        carry removals, or ``load_snapshot`` (which has no database to
        reconcile against) would resurrect the item."""
        if self._delta_rows is None:
            return
        self._delta_removed.add(int(key))
        self._delta_overflow_check()

    def _delta_overflow_check(self) -> None:
        if (
            self._delta_rows is not None
            and len(self._delta_rows) + len(self._delta_removed)
            > min(max(self.rows, 1024) // 4, 2_000_000)
        ):
            self._delta_rows = None
            self._delta_removed = set()

    def _note_quant_stats(self, vectors: np.ndarray) -> None:
        """Raise the high-water quantization step and row norm with a batch
        of f32 rows: the step is max|v| / 127 at int8, max|v| / 7 at int4,
        the row RMS at int2 (its grid {-3, -1, 1, 3} * rms / 2 has step
        rms)."""
        step, norm = self._quant_stats(vectors)
        self.scale_hw = max(self.scale_hw, step)
        self.norm_hw = max(self.norm_hw, norm)

    def _quant_stats(self, vectors: np.ndarray) -> tuple[float, float]:
        """(quantization step, largest row norm) of a batch of f32 rows."""
        if self.packed2:
            step = float(np.sqrt((vectors**2).mean(axis=1)).max())
        else:
            step = float(np.abs(vectors).max()) / (7.0 if self.packed4 else 127.0)
        return step, float(np.linalg.norm(vectors, axis=1).max())

    def retier(self, dtype) -> None:
        """Switch the storage dtype (bfloat16, float32, int8, INT4, INT2);
        the next sync restages every row from the host mirror, and the
        quantization stats are recomputed from it for the new tier's step.
        A fresh int2 tier trusts its coarse pass until the searcher's
        self-audit says otherwise."""
        _check_stored(dtype)
        with self._lock:
            if dtype == self.dtype:
                return
            self.reuse_gen += 1
            self.mutation_gen += 1  # sweep scores change between tiers
            self.dtype = dtype
            self._device_scales = self._device_fine = self._device_fine_scales = None
            self.coarse_trusted, self.coarse_select, self.coarse_fetch = True, "exact", 0
            self._dirty = True
            self._dirty_rows.clear()
            if self.quantized:
                # rows stored at a wider tier never touched the stats
                self.scale_hw = self.norm_hw = 0.0

                def stats(lo):
                    return self._quant_stats(
                        self._mirror.read_f32(slice(lo, min(lo + self._SYNC_CHUNK_ROWS, self.rows)), self.dim))

                for step, norm in _ordered_map(stats, range(0, self.rows, self._SYNC_CHUNK_ROWS)):
                    self.scale_hw = max(self.scale_hw, step)
                    self.norm_hw = max(self.norm_hw, norm)

    def clear(self) -> None:
        """Drop every row and the delta tracking (a failed snapshot load
        falls back to a rebuild from SQLite, which must not inherit the
        partly loaded rows)."""
        with self._lock:
            self.rows = 0
            self._free.clear()
            self.row_of.clear()
            self.groups.clear()
            self.multi_chunk_groups = 0
            self.item_ids[:] = -1
            self.source_ids[:] = -1
            self._dirty = True
            self._dirty_rows.clear()
            # None, not fresh sets: the rebuild's mutations are not relative
            # to any base on disk, and a delta written against the old base
            # would omit the removals recorded only in the discarded state
            self._delta_rows = None
            self._delta_removed = set()
            # every row index is open to reuse again: in-flight searches retry
            self.reuse_gen += 1
            self.mutation_gen += 1

    def keys_of_group(self, item_id: int) -> list[int]:
        """All chunk keys currently stored for an item."""
        g = self.groups.get(item_id)
        if g is not None:
            return list(g)
        k0 = item_id * CHUNK_STRIDE
        return [k0] if k0 in self.row_of else []

    def remove_source(self, source_id: int) -> int:
        """Drop every row of a source."""
        with self._lock:
            rows = np.nonzero(self.source_ids[: self.rows] == source_id)[0]
            if len(rows) == 0:
                return 0
            keys = self.item_ids[rows].tolist()
            self.source_ids[rows] = -1
            self.item_ids[rows] = -1
            if not self._dirty:
                self._dirty_rows.update(rows.tolist())
            self._note_delta(rows)
            for key in keys:
                self.row_of.pop(key, None)
                self._drop_key(key)
                self._note_removed(key)
            self._free.extend(int(r) for r in rows)
            self.mutation_gen += 1
            self._maybe_compact()
            return len(rows)

    def __len__(self) -> int:
        return len(self.row_of)

    # -- snapshots (format v2, the vector_shards manifest) ----------------------

    @property
    def dtype_name(self) -> str:
        """The ``tier`` string a snapshot stores and ``adopt_snapshot`` gates
        on, the JAX package's: ``bfloat16``, ``float32``, ``int8``, ``int4``
        or ``int2`` (never ``tier_name``'s ``int2+int8fine``)."""
        return self.dtype if isinstance(self.dtype, str) else str(self.dtype).removeprefix("torch.")

    def save_snapshot(self, path: str, *, incremental: bool = True, payload: bool = True) -> str:
        """Persist the matrix to ``path`` (an .npz) for a fast startup.
        Returns "full" or "delta".

        * **full** (format v2): the f32 rows, and with ``payload`` at a
          quantized tier the stored payload (tier bytes and scales), which a
          reload at the same tier adopts as is.  Written in row chunks with
          the lock held per chunk copy only, never across file writes: rows
          changed after their chunk was copied are newer than the manifest's
          max_seq and replay on load, and a tombstone reused mid-save (which
          could pair a vector with the wrong key) fails the publish check,
          so the save retries and finally holds the lock throughout.
        * **delta**: with a base on disk and little churn since, only the
          rows changed and keys removed since the base go to ``path +
          ".delta"`` (cumulative, replaced at each save).
        * Both assemble at a temp path and ``os.replace``: a crash mid-save
          leaves the previous snapshot whole.  Each base carries a random
          ``base_token`` and each delta its base's token, so a delta is only
          ever applied to the base it extends.
        """
        # two concurrent saves would share the temp file
        with self._snapshot_io_lock:
            return self._save_snapshot_locked(path, incremental=incremental, payload=payload)

    def _save_snapshot_locked(self, path: str, *, incremental: bool, payload: bool = True) -> str:
        delta_path = path + ".delta"
        with self._lock:
            has_delta_tracking = self._delta_rows is not None
        token, fmt, tier = self._snapshot_base_info(path)
        if incremental and has_delta_tracking and token is not None:
            if payload and (fmt < 2 or tier != self.dtype_name):
                # a pre-v2 base, or one of another tier (a retier since):
                # a delta would extend a base that adopt refuses, so write
                # a full base in the current tier instead
                pass
            # _write_delta re-checks the tracking under its lock: an
            # overflow racing the check above demotes to a full save
            elif self._write_delta(delta_path, token):
                return "delta"
        new_token = os.urandom(16).hex()
        for attempt in range(3):
            if self._write_full_snapshot(path, locked=attempt == 2, token=new_token, payload=payload):
                break
        # a leftover delta belongs to the previous base (its token no longer
        # matches, so a load ignores it even if this unlink never happens)
        if os.path.exists(delta_path):
            os.unlink(delta_path)
        return "full"

    @staticmethod
    def _snapshot_base_info(path: str):
        """(base_token, fmt, tier) of a base from one parse of its zip
        directory; (None, 0, None) for a missing, legacy or corrupt file."""
        token, fmt, tier = None, 0, None
        try:
            with np.load(path) as z:
                files = set(getattr(z, "files", []))
                if "base_token" in files:
                    token = str(z["base_token"])
                if "fmt" in files:
                    fmt = int(z["fmt"])
                if "tier" in files:
                    tier = str(z["tier"])
        except Exception:  # noqa: BLE001 — any unreadable base counts as none
            pass
        return token, fmt, tier

    @classmethod
    def _snapshot_token(cls, path: str):
        return cls._snapshot_base_info(path)[0]

    @staticmethod
    def _replace_into(path: str, write_fn) -> None:
        """Assemble a file at a temp sibling, then atomically replace."""
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            write_fn(tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _write_full_snapshot(self, path: str, *, locked: bool, token: str, payload: bool = True) -> bool:
        """Stream a full base.  True when it was published, False when a
        tombstone reuse raced the stream (nothing on disk was replaced; the
        caller retries).

        The delta tracking restarts in the same lock acquisition that
        captures the row state: a remove landing during the stream must
        reach the next delta, since the captured base still holds its key.
        An attempt that does not publish merges the old sets back, so the
        old base's delta stays cumulative."""
        import contextlib
        import zipfile

        from numpy.lib import format as npf

        outer = self._lock if locked else contextlib.nullcontext()
        with outer:
            with self._lock:
                gen = self.reuse_gen
                rows = self.rows
                item_ids = self.item_ids[:rows].copy()
                source_ids = self.source_ids[:rows].copy()
                scale_hw, norm_hw = self.scale_hw, self.norm_hw
                old_delta_rows = self._delta_rows
                old_delta_removed = self._delta_removed
                self._delta_rows = set()
                self._delta_removed = set()

            published = False
            try:

                def stream_quantized(zf, name: str, descr: str, width: int, quant_fn) -> np.ndarray:
                    """One payload member: mirror row chunks (the full padded
                    width: the quantizers cut their planes out of it)
                    quantized under short locks and written; returns the
                    per-row scales.  A row changed mid-stream diverges here
                    as in the f32 member and replays over both on load."""
                    scales = np.empty((rows,), np.float32)
                    with zf.open(name + ".npy", "w", force_zip64=True) as f:
                        npf.write_array_header_1_0(
                            f, {"descr": descr, "fortran_order": False, "shape": (rows, width)}
                        )

                        def read(lo):  # in this thread, which may hold the lock throughout
                            hi = min(lo + self._SYNC_CHUNK_ROWS, rows)
                            with self._lock:
                                return lo, hi, self._mirror.read_f32(slice(lo, hi))

                        def quantized(part):
                            lo, hi, chunk = part
                            return lo, hi, *quant_fn(chunk)

                        starts = range(0, rows, self._SYNC_CHUNK_ROWS)
                        for lo, hi, q, s in _ordered_map(quantized, map(read, starts)):
                            f.write(np.ascontiguousarray(q).tobytes())
                            scales[lo:hi] = s
                    return scales

                def write(tmp: str) -> None:
                    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
                        for name, arr in (
                            ("dim", np.int64(self.dim)),
                            ("fmt", np.int64(2)),
                            ("tier", np.str_(self.dtype_name)),
                            ("scale_hw", np.float32(scale_hw)),
                            ("norm_hw", np.float32(norm_hw)),
                            ("base_token", np.str_(token)),
                            ("item_ids", item_ids),
                            ("source_ids", source_ids),
                        ):
                            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                                npf.write_array(f, np.asarray(arr), allow_pickle=False)
                        # the f32 rows stream chunk by chunk under a short lock
                        with zf.open("vectors.npy", "w", force_zip64=True) as f:
                            npf.write_array_header_1_0(
                                f, {"descr": "<f4", "fortran_order": False, "shape": (rows, self.dim)}
                            )
                            for lo in range(0, rows, self._SYNC_CHUNK_ROWS):
                                hi = min(lo + self._SYNC_CHUNK_ROWS, rows)
                                with self._lock:
                                    chunk = self._mirror.read_f32(slice(lo, hi), self.dim)
                                f.write(np.ascontiguousarray(chunk).tobytes())
                        if payload and self.quantized and rows:
                            pd = self.padded_dim
                            if self.packed2:
                                fb = int2_fine_bits(self.capacity, pd, self.device, self.row_shards)
                                names = [
                                    ("q_coarse", "|u1", pd // 4, lambda v: _quantize2(v, self.dim)),
                                    ("q_fine", "|i1" if fb == 8 else "|u1", pd if fb == 8 else pd // 2,
                                     _quantize if fb == 8 else _quantize4),
                                ]
                            elif self.packed4:
                                names = [("q_vectors", "|u1", pd // 2, _quantize4)]
                            else:  # int8
                                names = [("q_vectors", "|i1", pd, _quantize)]
                            for name, descr, width, fn in names:
                                s = stream_quantized(zf, name, descr, width, fn)
                                with zf.open(name + "_scales.npy", "w", force_zip64=True) as f:
                                    npf.write_array(f, s, allow_pickle=False)

                tmp = f"{path}.tmp.{os.getpid()}"
                try:
                    write(tmp)
                    # every reuse_gen bump holds the lock, so an unchanged gen
                    # here proves no tombstone was reused before the replace
                    with self._lock:
                        if self.reuse_gen == gen:
                            os.replace(tmp, path)
                            published = True
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            finally:
                if not published:
                    with self._lock:
                        if old_delta_rows is None:
                            # tracking had overflowed before the capture: stay
                            # in forced-full-save mode
                            self._delta_rows = None
                            self._delta_removed = set()
                        elif self._delta_rows is not None:
                            self._delta_rows |= old_delta_rows
                            self._delta_removed |= old_delta_removed
                            self._delta_overflow_check()
            return published

    def _write_delta(self, delta_path: str, token: str) -> bool:
        """Cumulative delta since the last full base: the (chunk keys,
        source ids, f32 rows) of every row changed since it and the keys
        removed since it, applied on load by remove-then-upsert (so row
        numbers need not match the base's).  Carries the base's token.

        The changed rows, the removed keys and the row contents are captured
        under one lock acquisition: a remove between two acquisitions could
        miss ``removed_keys`` while the base still holds the key.  Returns
        False (nothing written; the caller saves a full base) when the
        tracking overflowed since the caller's check."""
        with self._lock:
            if self._delta_rows is None:
                return False
            idx = np.asarray(sorted(self._delta_rows), dtype=np.int64)
            removed = sorted(self._delta_removed)
            item_ids = self.item_ids[idx].copy()
            source_ids = self.source_ids[idx].copy()
            vectors = self._mirror.read_f32(idx, self.dim)

        import zipfile

        from numpy.lib import format as npf

        def write_zip(tmp: str) -> None:
            with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
                for name, arr in (
                    ("dim", np.int64(self.dim)),
                    ("base_token", np.str_(token)),
                    ("item_ids", item_ids),
                    ("source_ids", source_ids),
                    ("vectors", vectors),
                    ("removed_keys", np.asarray(removed, dtype=np.int64)),
                ):
                    with zf.open(name + ".npy", "w", force_zip64=True) as f:
                        npf.write_array(f, np.asarray(arr), allow_pickle=False)

        self._replace_into(delta_path, write_zip)
        return True

    # rows per chunk when streaming snapshot members back in (1M x 384 f32 is
    # ~1.5 GB of transient, whatever the corpus size)
    _LOAD_CHUNK_ROWS = 1_048_576

    @staticmethod
    def _member_mmap(path: str, name: str, fh=None):
        """Read-only memmap over the data bytes of a ZIP_STORED 2-D .npy
        member, or None when the member is absent, compressed or of another
        layout.  The zip reader copies in small chunks and checks every
        byte's CRC; the members written here are stored, so their bytes lie
        contiguous in the file.  No CRC check on this path: the snapshot is
        a cache over SQLite, and the structural checks (token, dim, shapes)
        still apply.

        ``fh``: an open binary handle on the snapshot.  When given, both the
        zip directory and the mapping use it, so every byte comes from one
        inode even if ``path`` is replaced meanwhile (the callers thread one
        handle through every member read: a base is never a mix of two
        saves)."""
        import struct
        import zipfile

        from numpy.lib import format as npf

        f = None
        try:
            with zipfile.ZipFile(fh if fh is not None else path) as zf:
                info = zf.getinfo(name + ".npy")
                if info.compress_type != zipfile.ZIP_STORED:
                    return None
            f = fh if fh is not None else open(path, "rb")
            f.seek(info.header_offset)
            hdr = f.read(30)  # the local header (its name and extra lengths
            # can differ from the central directory's)
            if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
                return None
            nlen, elen = struct.unpack("<HH", hdr[26:30])
            f.seek(info.header_offset + 30 + nlen + elen)
            version = npf.read_magic(f)
            if version == (1, 0):
                shape, fortran, descr = npf.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, descr = npf.read_array_header_2_0(f)
            else:
                return None
            if fortran or len(shape) != 2:
                return None
            return np.memmap(f, dtype=np.dtype(descr), mode="r", offset=f.tell(), shape=shape)
        except Exception:  # noqa: BLE001 — the caller falls back to zipfile reads
            return None
        finally:
            if f is not None and fh is None:
                f.close()

    @classmethod
    def _iter_snapshot_member(cls, path: str, name: str, want_dtype, chunk_rows: int, fh=None):
        """(lo, hi, rows) chunks of a 2-D .npy member, never the whole array
        at once.  Chunks of the mapped path are read-only views: consumers
        copy them into their destination, one file-to-destination copy."""
        import zipfile

        from numpy.lib import format as npf

        want = np.dtype(want_dtype)
        mapped = cls._member_mmap(path, name, fh)
        if mapped is not None and mapped.dtype == want:
            rows = mapped.shape[0]
            for lo in range(0, rows, chunk_rows):
                hi = min(lo + chunk_rows, rows)
                yield lo, hi, mapped[lo:hi]
            return
        with zipfile.ZipFile(fh if fh is not None else path) as zf, zf.open(name + ".npy") as f:
            version = npf.read_magic(f)
            if version == (1, 0):
                shape, fortran, descr = npf.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, descr = npf.read_array_header_2_0(f)
            else:  # an unknown format: np.load reads it whole
                if fh is not None:
                    fh.seek(0)
                data = np.load(fh if fh is not None else path)[name]
                yield 0, data.shape[0], np.asarray(data, dtype=want)
                return
            rows, dim = shape
            if fortran or np.dtype(descr) != want:
                data = np.frombuffer(f.read(), dtype=descr).reshape(shape)
                yield 0, rows, data.astype(want, copy=False)
                return
            row_bytes = dim * want.itemsize
            for lo in range(0, rows, chunk_rows):
                hi = min(lo + chunk_rows, rows)
                buf = f.read((hi - lo) * row_bytes)
                yield lo, hi, np.frombuffer(buf, dtype=want).reshape(hi - lo, dim)

    @classmethod
    def _iter_snapshot_vectors(cls, path: str, chunk_rows: int, fh=None):
        """(lo, hi, f32 rows) chunks of the ``vectors`` member."""
        return cls._iter_snapshot_member(path, "vectors", "<f4", chunk_rows, fh)

    @staticmethod
    def _snapshot_member_shape(path: str, name: str, fh=None):
        """Shape of one .npy member from its header alone; None when the
        member is absent or unreadable."""
        import zipfile

        from numpy.lib import format as npf

        try:
            with zipfile.ZipFile(fh if fh is not None else path) as zf, zf.open(name + ".npy") as f:
                version = npf.read_magic(f)
                if version == (1, 0):
                    return npf.read_array_header_1_0(f)[0]
                if version == (2, 0):
                    return npf.read_array_header_2_0(f)[0]
        except Exception:  # noqa: BLE001
            pass
        return None

    def adopt_snapshot(self, path: str) -> bool:
        """Restore a format-v2 base into this fresh, empty matrix as stored:
        the row layout (tombstones, row numbers, free list) is copied as is
        and the device tensors come from the payload members, with no
        per-row upsert and no quantization pass.  Returns False, changing
        nothing but the capacity, when the base is v1 or foreign, its tier
        or dim differs from this matrix's, its int2 companion is not the
        width ``int2_fine_bits`` gives on this device, or the matrix already
        holds rows: the caller then streams the f32 rows through ``upsert``,
        which handles all of those.

        Rows that changed while the base was written diverge from its
        payload as from its f32 member; the seq replay or the delta heals
        both (Searcher._load_snapshot).  Every byte is read through one open
        handle, so a concurrent save replacing ``path`` cannot mix two bases
        into the adopted state."""
        try:
            fh = open(path, "rb")
        except OSError:
            return False
        with fh:
            return self._adopt_snapshot_fh(path, fh)

    def _adopt_snapshot_fh(self, path: str, fh) -> bool:
        fh.seek(0)  # np.load sniffs the zip magic from the current position
        z = np.load(fh)
        files = set(getattr(z, "files", []))
        # exact-version gate: a later format may re-encode the payload under
        # the same member names
        if "fmt" not in files or int(z["fmt"]) != 2:
            return False
        if int(z["dim"]) != self.dim or str(z["tier"]) != self.dtype_name:
            return False
        item_ids = np.asarray(z["item_ids"], np.int64)
        source_ids = np.asarray(z["source_ids"], np.int32)
        n = int(len(item_ids))
        pd = self.padded_dim
        with self._lock:
            if self.rows or self.row_of:
                return False
            # grow first, then check the payload against the capacity the
            # growth policy really gives (an empty grown matrix stays valid)
            self._grow(max(n, 1))
            if self.quantized and n:
                if self.packed2:
                    if not {"q_coarse", "q_coarse_scales", "q_fine", "q_fine_scales"} <= files:
                        return False
                    fb = int2_fine_bits(self.capacity, pd, self.device, self.row_shards)
                    if self._snapshot_member_shape(path, "q_fine", fh) != (n, pd if fb == 8 else pd // 2):
                        return False  # the stored companion is not this device's
                    if self._snapshot_member_shape(path, "q_coarse", fh) != (n, pd // 4):
                        return False
                else:
                    if not {"q_vectors", "q_vectors_scales"} <= files:
                        return False
                    want_w = pd // 2 if self.packed4 else pd
                    if self._snapshot_member_shape(path, "q_vectors", fh) != (n, want_w):
                        return False
            self.item_ids[:n] = item_ids
            self.source_ids[:n] = source_ids
            self.rows = n
            live_mask = source_ids >= 0
            live_rows = np.flatnonzero(live_mask)
            keys = item_ids[live_mask]
            self.row_of = dict(zip(keys.tolist(), live_rows.tolist()))
            # the chunk-group index, by upsert's rule: only items with a key
            # off chunk 0 get an entry
            gm: dict[int, set] = {}
            for k in keys[keys % CHUNK_STRIDE != 0].tolist():
                gm.setdefault(k // CHUNK_STRIDE, set()).add(int(k))
            for iid, g in gm.items():
                k0 = iid * CHUNK_STRIDE
                if k0 in self.row_of:
                    g.add(k0)
            self.groups = gm
            self.multi_chunk_groups = sum(1 for g in gm.values() if len(g) > 1)
            self._free = np.flatnonzero(~live_mask).tolist()
            if "scale_hw" in files:
                self.scale_hw = float(z["scale_hw"])
                self.norm_hw = float(z["norm_hw"])
            # the f32 mirror pass (page-in and copy) runs on a worker thread
            # while this one stages the payload and copies it to the device.
            # Both read through positionless memmaps of the one handle, so
            # the threads never share a file position; the mirror belongs to
            # this adopt alone (the lock is held and the matrix was empty),
            # and a worker's exception re-raises here after the join.  The
            # mirror source is resolved on this thread, since locating the
            # member seeks the handle; a vectors member that cannot be
            # mapped is copied afterwards by the streaming reader.
            t_dev = time.perf_counter()
            mapped = self._member_mmap(path, "vectors", fh)
            if mapped is not None and mapped.dtype != np.dtype("<f4"):
                mapped = None
            mirror_err: list[BaseException] = []

            def _mirror_pass() -> None:
                try:
                    self._mirror_copy_from(mapped)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    mirror_err.append(e)

            mt = None
            if mapped is not None:
                mt = threading.Thread(target=_mirror_pass, name="adopt-mirror")
                mt.start()
            try:
                if self.quantized and n:
                    self._adopt_device(z, path, n, fh)
                    self._device_source_ids = self._place(self.source_ids.copy(), adopted=True)
                    self._dirty = False
                    self._dirty_rows.clear()
                else:
                    # bf16 and f32 store no payload: the first sync casts the mirror
                    self._dirty = True
            finally:
                t_stage = time.perf_counter()
                if mt is not None:
                    mt.join()
            if mirror_err:
                raise mirror_err[0]
            if mapped is None:
                for lo, hi, vecs in self._iter_snapshot_vectors(path, self._LOAD_CHUNK_ROWS, fh):
                    self._mirror.write(slice(lo, hi), vecs, self.dim)
            if os.environ.get("PERCEIVE_TPU_DEBUG_STARTUP"):
                print(
                    f"adopt phases: stage+copy {t_stage - t_dev:.2f}s  mirror-wait "
                    f"{time.perf_counter() - t_stage:.2f}s  overlapped={mapped is not None}  (n={n})",
                    file=sys.stderr,
                )
            self._mirror.remap()  # drop a spilled mirror's bulk-load page residency
            self.mutation_gen += 1
        return True

    def _mirror_copy_from(self, mapped) -> None:
        """Copy the snapshot's f32 ``vectors`` member (a positionless
        memmap) into the host mirror.  A plain chunk loop waits on a page
        fault per source page, and per destination page of a spilled
        mirror; so ``madvise`` (MADV_SEQUENTIAL over the member, WILLNEED
        per chunk ahead of its copy) and a few workers
        (PERCEIVE_TPU_MIRROR_THREADS, default 4) taking chunks off one
        counter: numpy's copy releases the GIL, so the workers overlap
        their IO waits even on one core.  Workers write disjoint rows of a
        mirror no one else holds during the adopt."""
        import mmap as _mmapmod

        rows_m = int(mapped.shape[0])
        if rows_m == 0:
            return
        rowbytes = int(mapped.shape[1]) * mapped.dtype.itemsize
        chunk = max(1, _MIRROR_COPY_CHUNK_BYTES // max(rowbytes, 1))
        mm = getattr(mapped, "_mmap", None)
        base_off = 0
        if mm is not None:
            try:
                base_off = int(mapped.offset) % _mmapmod.ALLOCATIONGRANULARITY
                mm.madvise(_mmapmod.MADV_SEQUENTIAL)
            except (AttributeError, ValueError, OSError):
                mm = None  # advisory only

        def _advise(lo: int, hi: int) -> None:
            if mm is None:
                return
            try:
                ps = _mmapmod.PAGESIZE
                start = base_off + lo * rowbytes
                end = min(base_off + hi * rowbytes, len(mm))
                start -= start % ps
                if end > start:
                    mm.madvise(_mmapmod.MADV_WILLNEED, start, end - start)
            except (ValueError, OSError):
                pass

        nchunks = -(-rows_m // chunk)
        try:
            nthreads = int(os.environ.get("PERCEIVE_TPU_MIRROR_THREADS", "4"))
        except ValueError:
            nthreads = 4
        nthreads = max(1, min(nthreads, nchunks))

        def _copy_chunk(ci: int) -> None:
            lo = ci * chunk
            hi = min(lo + chunk, rows_m)
            _advise(lo, hi)
            self._mirror.write(slice(lo, hi), mapped[lo:hi], self.dim)

        if nthreads == 1:
            for ci in range(nchunks):
                _copy_chunk(ci)
            return
        counter = iter(range(nchunks))
        clock = threading.Lock()
        errs: list[BaseException] = []

        def _worker() -> None:
            while True:
                with clock:
                    ci = next(counter, None)
                if ci is None or errs:
                    return
                try:
                    _copy_chunk(ci)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errs.append(e)
                    return

        workers = [threading.Thread(target=_worker, name=f"adopt-mirror-{i}") for i in range(nthreads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        if errs:
            raise errs[0]

    def _adopt_device(self, z, path: str, n: int, fh=None) -> None:
        """The device tensors from the payload members: the host arrays
        that ``_stage_full_transposed`` (int4, int2) or ``sync`` (int8)
        would stage, then one copy each to the device.  Int8 is row-major
        (capacity, padded_dim); int4 the (padded_dim / 2, capacity) packed
        matrix; int2 the (padded_dim / 4, capacity) coarse matrix and its
        int8 (padded_dim, capacity) or packed int4 (padded_dim / 2,
        capacity) companion.  Rows past ``n`` hold what the quantizer makes
        of the mirror's zero rows there, as a staging from the mirror
        would; their source id is -1, so they never score."""
        cap, pd = self.capacity, self.padded_dim
        chunk = self._LOAD_CHUNK_ROWS
        zero = np.zeros((1, pd), np.float32)

        def scales_of(name, tail):
            s = np.empty((cap,), np.float32)
            s[:n] = z[name]
            s[n:] = tail
            return self._place(s, adopted=True)

        def transposed(name, width, dtype, quantize):
            q0, s0 = quantize(zero)
            staged = np.empty((width, cap), dtype)
            for lo, hi, q in self._iter_snapshot_member(path, name, dtype, chunk, fh):
                _put_transposed(staged, lo, q)
            staged[:, n:] = q0.T
            return self._place(staged, 1, adopted=True), scales_of(name + "_scales", s0[0])

        if self.packed2:
            fine_w = self._snapshot_member_shape(path, "q_fine", fh)[1]
            fine = (np.int8, _quantize) if fine_w == pd else (np.uint8, _quantize4)
            self._device_vectors, self._device_scales = transposed(
                "q_coarse", pd // 4, np.uint8, lambda v: _quantize2(v, self.dim)
            )
            self._device_fine, self._device_fine_scales = transposed("q_fine", fine_w, *fine)
        elif self.packed4:
            self._device_vectors, self._device_scales = transposed("q_vectors", pd // 2, np.uint8, _quantize4)
        else:  # int8, row-major
            q0, s0 = _quantize(zero)
            staged = np.empty((cap, pd), np.int8)
            for lo, hi, q in self._iter_snapshot_member(path, "q_vectors", np.int8, chunk, fh):
                staged[lo:hi] = q
            staged[n:] = q0
            self._device_vectors = self._place(staged, adopted=True)
            self._device_scales = scales_of("q_vectors_scales", s0[0])

    @classmethod
    def load_snapshot(cls, path: str, *, device: torch.device | str, dtype=torch.bfloat16) -> "EmbeddingMatrix":
        """A new matrix on ``device`` from a base and its delta: adopted at
        the base's tier, else the f32 rows streamed through ``upsert``.
        Raises ValueError when a delta exists but cannot be trusted."""
        with open(path, "rb") as fh:
            z = np.load(fh)
            dim = int(z["dim"])
            token = str(z["base_token"]) if "base_token" in getattr(z, "files", []) else None
            # the row count from the member header: the ids themselves are
            # read only by the streaming fallback
            shape = cls._snapshot_member_shape(path, "item_ids", fh)
            rows = int(shape[0]) if shape else len(z["item_ids"])
            m = cls(dim, device=device, dtype=dtype, capacity=max(rows, 1))
            if not m._adopt_snapshot_fh(path, fh):
                item_ids, source_ids = z["item_ids"], z["source_ids"]
                for lo, hi, vecs in cls._iter_snapshot_vectors(path, cls._LOAD_CHUNK_ROWS, fh):
                    live = source_ids[lo:hi] >= 0
                    if not live.any():
                        continue
                    m.upsert(
                        item_ids[lo:hi][live].tolist(),
                        source_ids[lo:hi][live].tolist(),
                        vecs[live] if not live.all() else vecs,
                    )
        if m.apply_snapshot_delta(path, token) < 0:
            # a delta exists but cannot be trusted: the bare base could lack
            # the rows it carried and hold keys removed since, and there is
            # no database here to rebuild from
            raise ValueError(
                f"snapshot delta {path}.delta is unusable (corrupt or unverifiable); "
                "delete it or rebuild from the database"
            )
        return m

    def apply_snapshot_delta(self, base_path: str, base_token: Optional[str] = None) -> int:
        """Apply ``base_path + ".delta"`` when it exists and carries the
        base's token.  Returns the live rows applied; 0 when there is no
        delta or it is provably stale (its token names another base: a
        newer base holds all an older delta carried); -1 when a delta
        exists but cannot be trusted (corrupt, another dim, or a tokenless
        legacy base), in which case the caller must rebuild from SQLite,
        since delta saves advanced the manifest's max_seq past its rows.
        Removals apply first, so a key removed and re-added ends live.

        ``base_token``: the token read through the same handle the base was
        loaded through; reading it again from ``base_path`` could see a
        newer base, whose delta must not land on the older base's rows."""
        delta_path = str(base_path) + ".delta"
        if not os.path.exists(delta_path):
            return 0
        if base_token is None:
            base_token = self._snapshot_token(base_path)
        try:
            z = np.load(delta_path)
            if int(z["dim"]) != self.dim:
                return -1
            files = getattr(z, "files", [])
            if base_token is None or "base_token" not in files:
                return -1
            if str(z["base_token"]) != base_token:
                return 0
            if "removed_keys" in files:
                gone = [int(k) for k in z["removed_keys"]]
                if gone:
                    self.remove(gone)
            live = z["source_ids"] >= 0
            keys = z["item_ids"][live].tolist()
            if keys:
                self.upsert(keys, z["source_ids"][live].tolist(), z["vectors"][live])
            return len(keys)
        except Exception:  # noqa: BLE001 — a corrupt delta
            return -1


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array of an adopted snapshot on ``device``; a failure is
    the device's (SnapshotDeviceError), never a reason to rebuild."""
    try:
        t = torch.from_numpy(arr).to(device)
    except Exception as e:  # noqa: BLE001 — re-raised as the device's fault
        raise SnapshotDeviceError(f"copying an adopted {arr.shape} {arr.dtype} array to {device} failed: {e}") from e
    if tuple(t.shape) != arr.shape:
        raise SnapshotDeviceError(f"adopted array {arr.shape} arrived as {tuple(t.shape)} on {device}")
    return t


class ShardedEmbeddingMatrix(EmbeddingMatrix):
    """The matrix row-sharded over mesh slots (the JAX package's matrix
    under ``rows_sharding``).  Host state is the base class's, global and
    unchanged: the mirror, the ids, ``row_of``, the free list, the deltas.
    Each device tensor becomes a list with one tensor of its own per slot,
    holding the contiguous block of ``n_local = capacity / S`` rows (the
    columns of the transposed tiers) that starts at global row ``s *
    n_local``: each shard is an allocation of its own, as TMA and K5 want.
    Capacity and ``row_align`` are multiples of ROW_ALIGN * S, so growth
    (which moves rows between shards) restages every shard whole, and a
    base saved at any shard count adopts at any other."""

    def __init__(self, dim: int, *, devices, dtype=torch.bfloat16, capacity: int = 0):
        self.devices = [torch.device(d) for d in devices]
        s = len(self.devices)
        super().__init__(dim, device=self.devices[0], dtype=dtype, capacity=max(capacity, ROW_ALIGN * s),
                         row_align=ROW_ALIGN * s)

    @property
    def row_shards(self) -> int:
        return len(self.devices)

    @property
    def n_local(self) -> int:
        return self.capacity // len(self.devices)

    @property
    def fine_bits(self) -> int:
        if self.packed2 and self._device_fine is not None:
            return 8 if self._device_fine[0].dtype == torch.int8 else 4
        return super().fine_bits

    def _pieces(self, lo: int, hi: int):
        """(shard, global lo, global hi) of the shards that rows lo .. hi
        fall in."""
        nl = self.n_local
        for s in range(lo // nl, -(-hi // nl)):
            yield s, max(lo, s * nl), min(hi, (s + 1) * nl)

    def _place(self, arr: np.ndarray, axis: int = 0, adopted: bool = False):
        nl = self.n_local
        out = []
        for s, dev in enumerate(self.devices):
            part = np.ascontiguousarray(arr[s * nl : (s + 1) * nl] if axis == 0 else arr[:, s * nl : (s + 1) * nl])
            out.append(_to_device(part, dev) if adopted else torch.from_numpy(part).to(dev))
        return out

    def _empty(self, tail: tuple, dtype):
        return [torch.empty((self.n_local, *tail), dtype=dtype, device=dev) for dev in self.devices]

    def _write_rows(self, dst, lo: int, vals: torch.Tensor) -> None:
        nl = self.n_local
        for s, a, b in self._pieces(lo, lo + len(vals)):
            dst[s][a - s * nl : b - s * nl].copy_(vals[a - lo : b - lo])

    def _index_copy(self, dst, axis: int, rows: np.ndarray, vals: torch.Tensor) -> None:
        nl = self.n_local
        shard = rows // nl
        for s in np.unique(shard).tolist():
            pos = np.flatnonzero(shard == s)
            dev = self.devices[s]
            dst[s].index_copy_(axis, torch.from_numpy(rows[pos] - s * nl).to(dev),
                               vals.index_select(axis, torch.from_numpy(pos)).to(dev))
