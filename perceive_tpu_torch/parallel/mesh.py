"""Device mesh and placement rules.

Port of perceive_tpu/parallel/mesh.py.  JAX drives a mesh from one process
(single controller); so does the port: a ``Mesh`` is a (data, model) grid
of ``torch.device`` slots, and one process places tensors on them and
launches each slot's kernels itself.  No ``torch.distributed``: the CLI,
the REPL and the server are single processes with no launcher.

  * ``data``  — data parallelism for the ingest encode (token batches split
    over the data slots), and together with ``model`` the row axis of the
    sharded corpus matrix;
  * ``model`` — tensor parallelism for the encoder tower (attention heads
    and FFN columns): the Megatron split of ``param_specs``.

The corpus rows shard over every slot in row-major order (``Mesh.flat``),
as JAX's ``P(("data", "model"))`` flattens the grid.  Slots may share a
device only when the caller passes them explicitly (``make_mesh(devices=
[torch.device("cpu")] * 8)`` in the tests, ``[cuda:0] * 4`` on one card).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
# Corpus rows shard over every slot (both axes flattened)
ROWS_AXES = (DATA_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of device slots."""

    devices: tuple  # tuple of rows (data), each a tuple of devices (model)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self) -> tuple:
        """Every slot in row-major (data, model) order: the row shards' order."""
        return tuple(d for row in self.devices for d in row)

    @property
    def lead(self) -> torch.device:
        """Slot (0, 0): where merged results and single queries live."""
        return self.devices[0][0]


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    model_parallel: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (n / model_parallel, model_parallel) mesh over ``devices`` (default:
    every visible CUDA device once; without CUDA this raises, there is no
    CPU fallback).  ``n_devices`` takes the first n and raises when fewer
    exist."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() needs CUDA; pass devices= explicitly (e.g. [torch.device('cpu')] * 8)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"asked for {n_devices} devices but only {len(devices)} available; pass devices= explicitly "
                "(repeated slots of one device) instead of silently under-provisioning"
            )
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0 or n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = tuple(tuple(devices[r * model_parallel : (r + 1) * model_parallel]) for r in range(n // model_parallel))
    return Mesh(grid)


def device_scope(dev: torch.device):
    """Make ``dev`` the current CUDA device for the block (a kernel launches
    on the current device's context); a no-op for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


# -- encoder tensor-parallel param splits -------------------------------------

# The axis of each layer leaf (leading axis: the layer) split over the model
# slots: column-parallel into attention and the FFN, row-parallel out (the
# JAX package's _LAYER_SPECS, PartitionSpecs with MODEL_AXIS at this axis).
_LAYER_SPECS = {
    "q_w": 2, "k_w": 2, "v_w": 2,
    "q_b": 1, "k_b": 1, "v_b": 1,
    "o_w": 1,
    "ffn_in_w": 2, "ffn_in_b": 1,
    "ffn_out_w": 1,
}


def param_specs(params) -> dict:
    """The split axis of every leaf of an encoder param tree, or None where
    the leaf is replicated (embeddings, layernorms, the biases of the
    row-parallel matmuls)."""
    return {
        group: {name: (_LAYER_SPECS.get(name) if group == "layers" else None) for name in sub}
        for group, sub in params.items()
    }


def shard_params(params, mesh: Mesh) -> list:
    """The encoder param tree placed on the mesh: a grid like
    ``mesh.devices`` of trees, slot (i, j) holding block j of every split
    leaf (``param_specs``) and every replicated leaf whole, on its device."""
    specs = param_specs(params)
    mp = mesh.shape[MODEL_AXIS]

    def leaf(t, axis, j, dev):
        if axis is not None:
            if t.shape[axis] % mp:
                raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split {mp} ways")
            t = t.chunk(mp, dim=axis)[j].contiguous()
        return t.to(dev)

    return [
        [
            {g: {n: leaf(t, specs[g][n], j, dev) for n, t in sub.items()} for g, sub in params.items()}
            for j, dev in enumerate(row)
        ]
        for row in mesh.devices
    ]


# -- placement helpers (the JAX package's NamedShardings) -----------------------


def replicated(t: torch.Tensor, mesh: Mesh) -> dict:
    """``t`` on every distinct device of the mesh, one copy each, keyed by
    device: the counterpart of ``NamedSharding(mesh, P())``."""
    return {dev: t.to(dev, non_blocking=True) for dev in dict.fromkeys(mesh.flat)}


def batch_sharding(t: torch.Tensor, mesh: Mesh) -> list:
    """(B, ...) split into contiguous blocks over the data slots, each on
    its row's slot (i, 0): ``P("data", None)``.  B must divide evenly."""
    d = mesh.shape[DATA_AXIS]
    if t.shape[0] % d:
        raise ValueError(f"batch of {t.shape[0]} does not split over {d} data slots")
    return [part.to(row[0], non_blocking=True) for part, row in zip(t.chunk(d), mesh.devices)]


def rows_sharding(t: torch.Tensor, mesh: Mesh, axis: int = 0) -> list:
    """The capacity axis ``axis`` of ``t`` split into one contiguous block
    per slot, in ``Mesh.flat`` order, each a tensor of its own on its slot's
    device: ``P(("data", "model"), None)`` for (N, D) rows, ``P(None,
    ("data", "model"))`` (``axis=1``) for the transposed (D, N) tiers."""
    s = mesh.size
    if t.shape[axis] % s:
        raise ValueError(f"{t.shape[axis]} rows do not split over {s} slots")
    n = t.shape[axis] // s
    return [t.narrow(axis, i * n, n).contiguous().to(dev) for i, dev in enumerate(mesh.flat)]


def rows_1d_sharding(t: torch.Tensor, mesh: Mesh) -> list:
    """(N,) per-row arrays (source ids, scales) split like the rows."""
    return rows_sharding(t, mesh, 0)
