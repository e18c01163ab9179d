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
packing (``_quantize2``).  Snapshots are later work (ROADMAP.md queue 1).

Device updates happen in place on the current stream, so a sweep enqueued
before an update reads the old rows and one enqueued after reads the new
ones; ``reuse_gen`` still tells a search that a row changed owner between
its sweep and its host-side decode.
"""

from __future__ import annotations

import os
import threading
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
        sel = self.arr[rows] if ncols is None else self.arr[rows, :ncols]
        return np.array(sel, dtype=np.float32, copy=True)

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


def int2_fine_bits(capacity: int, padded_dim: int, device: torch.device) -> int:
    """Width of the int2 tier's fine companion, by the JAX package's policy:
    8 while coarse (0.25 B/dim) + int8 (1 B/dim) fit the budget, else 4
    (packed int4, the int4 tier's bytes); PERCEIVE_TPU_INT2_FINE = int8 |
    int4 pins it.  On an 80 GB card the budget holds about 113M rows of
    capacity at 384 dims."""
    env = os.environ.get("PERCEIVE_TPU_INT2_FINE", "auto").lower()
    if env in ("int8", "8"):
        return 8
    if env in ("int4", "4"):
        return 4
    return 8 if capacity * padded_dim * 1.25 <= _int2_fine_int8_budget(device) else 4


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
        return int2_fine_bits(self.capacity, self.padded_dim, self.device)

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
                self._device_source_ids = torch.from_numpy(self.source_ids.copy()).to(self.device)
                self._mirror.remap()
            elif full:
                self._device_vectors = self._device_scales = None  # release before allocating anew
                vecs = torch.empty((self.capacity, self.padded_dim), dtype=self.dtype, device=self.device)
                scales = torch.empty((self.capacity,), dtype=torch.float32, device=self.device) if self.quantized else None
                for lo in range(0, self.capacity, self._SYNC_CHUNK_ROWS):
                    hi = min(lo + self._SYNC_CHUNK_ROWS, self.capacity)
                    chunk, sc = self._staged(self._mirror.read_f32(slice(lo, hi)))
                    vecs[lo:hi].copy_(chunk)
                    if scales is not None:
                        scales[lo:hi].copy_(sc)
                self._device_vectors, self._device_scales = vecs, scales
                self._device_source_ids = torch.from_numpy(self.source_ids.copy()).to(self.device)
                self._mirror.remap()
            else:
                rows = np.fromiter(self._dirty_rows, dtype=np.int64)
                idx = torch.from_numpy(rows).to(self.device)
                if self.packed2 or self.packed4:  # columns of the transposed matrices
                    vals = self._mirror.read_f32(rows)
                    if self.packed4:
                        parts = [(self._device_vectors, self._device_scales, *_quantize4(vals))]
                    else:
                        fine = _quantize(vals) if self.fine_bits == 8 else _quantize4(vals)
                        parts = [(self._device_vectors, self._device_scales, *_quantize2(vals, self.dim)),
                                 (self._device_fine, self._device_fine_scales, *fine)]
                    for dst, dst_scales, cols, sc in parts:
                        dst.index_copy_(1, idx, torch.from_numpy(np.ascontiguousarray(cols.T)).to(self.device))
                        dst_scales.index_copy_(0, idx, torch.from_numpy(sc).to(self.device))
                else:
                    vals, sc = self._staged(self._mirror.read_f32(rows))
                    self._device_vectors.index_copy_(0, idx, vals.to(self.device))
                    if sc is not None:
                        self._device_scales.index_copy_(0, idx, sc.to(self.device))
                srcs = torch.from_numpy(self.source_ids[rows].copy()).to(self.device)
                self._device_source_ids.index_copy_(0, idx, srcs)
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
                       (_quantize, d, np.int8) if int2_fine_bits(cap, d, self.device) == 8
                       else (_quantize4, d // 2, np.uint8)]
        staged = [(np.empty((width, cap), dtype=dt), np.empty((cap,), np.float32)) for _, width, dt in layouts]
        for lo in range(0, cap, chunk):
            hi = min(lo + chunk, cap)
            vals = self._mirror.read_f32(slice(lo, hi))
            for (quantize, _, _), (m, sc) in zip(layouts, staged):
                packed, scales = quantize(vals)
                m[:, lo:hi], sc[lo:hi] = packed.T, scales
        (m, sc), *companion = [(torch.from_numpy(m).to(self.device), torch.from_numpy(sc).to(self.device))
                               for m, sc in staged]
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

    def device_view(self):
        """(vectors, source_ids, scales) device tensors, synced, captured
        under the lock; scales is None below the int8 tier.  At the int4
        tier vectors is the packed (padded_dim / 2, capacity) matrix; at the
        int2 tier vectors and scales are (coarse, companion) pairs."""
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
                    moved = len(srcs)
                self.rows = live
            self._free = [int(r) for r in np.nonzero(self.item_ids[: self.rows] < 0)[0]]
            return moved

    def _note_quant_stats(self, vectors: np.ndarray) -> None:
        """Raise the high-water quantization step and row norm with a batch
        of f32 rows: the step is max|v| / 127 at int8, max|v| / 7 at int4,
        the row RMS at int2 (its grid {-3, -1, 1, 3} * rms / 2 has step
        rms)."""
        if self.packed2:
            step = float(np.sqrt((vectors**2).mean(axis=1)).max())
        else:
            step = float(np.abs(vectors).max()) / (7.0 if self.packed4 else 127.0)
        self.scale_hw = max(self.scale_hw, step)
        self.norm_hw = max(self.norm_hw, float(np.linalg.norm(vectors, axis=1).max()))

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
                for lo in range(0, self.rows, self._SYNC_CHUNK_ROWS):
                    v = self._mirror.read_f32(slice(lo, min(lo + self._SYNC_CHUNK_ROWS, self.rows)), self.dim)
                    if len(v):
                        self._note_quant_stats(v)

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
            for key in keys:
                self.row_of.pop(key, None)
                self._drop_key(key)
            self._free.extend(int(r) for r in rows)
            self.mutation_gen += 1
            self._maybe_compact()
            return len(rows)

    def __len__(self) -> int:
        return len(self.row_of)
