"""Multi-device search and encode (port of perceive_tpu/parallel): a mesh
of device slots driven by one process, the row-sharded ShardedSearcher,
and the encoder's data- and tensor-parallel placement (Model.shard_over)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ROWS_AXES,
    Mesh,
    batch_sharding,
    make_mesh,
    param_specs,
    replicated,
    rows_1d_sharding,
    rows_sharding,
    shard_params,
)
from .search import ShardedSearcher, sharded_scan_topk

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "ROWS_AXES",
    "Mesh",
    "ShardedSearcher",
    "batch_sharding",
    "make_mesh",
    "param_specs",
    "replicated",
    "rows_1d_sharding",
    "rows_sharding",
    "shard_params",
    "sharded_scan_topk",
]
