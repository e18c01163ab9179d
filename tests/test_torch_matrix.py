"""The port's EmbeddingMatrix host state against the JAX package's, step by
step through one upsert / remove / re-upsert / source-removal sequence
(exact equality: the bookkeeping is integer logic), plus its device
tensors against the host mirror."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.index.matrix import EmbeddingMatrix as JaxMatrix
from perceive_tpu.index.matrix import chunk_key as jax_chunk_key
from perceive_tpu.index.matrix import sweep_rows_for as jax_sweep_rows_for
from perceive_tpu_torch.index.matrix import EmbeddingMatrix, chunk_key, sweep_rows_for

DIM = 48


def _state(m):
    return {
        "row_of": dict(m.row_of),
        "item_ids": m.item_ids.tolist(),
        "source_ids": m.source_ids.tolist(),
        "rows": m.rows,
        "capacity": m.capacity,
        "sweep_rows": m.sweep_rows,
        "reuse_gen": m.reuse_gen,
        "multi_chunk_groups": m.multi_chunk_groups,
        "groups": {k: sorted(v) for k, v in m.groups.items()},
        "free": list(m._free),
        "len": len(m),
    }


def _steps(rng):
    def vecs(n):
        return rng.standard_normal((n, DIM)).astype(np.float32)

    keys = [chunk_key(i) for i in range(1, 700)]
    yield "upsert", (keys, [i % 3 for i in range(len(keys))], vecs(len(keys)))
    chunked = [chunk_key(5000, c) for c in range(6)] + [chunk_key(5001, c) for c in range(2)]
    yield "upsert", (chunked, [1] * len(chunked), vecs(len(chunked)))
    yield "remove", (keys[10:300] + [chunk_key(5000, 3), chunk_key(424242)],)
    yield "upsert", (keys[20:60] + [chunk_key(9000 + i) for i in range(300)], [2] * 340, vecs(340))
    yield "upsert", ([chunk_key(7), chunk_key(7)], [0, 1], vecs(2))  # in-batch duplicate
    yield "remove", ([chunk_key(5001, 1)],)
    yield "remove_source", (2,)
    yield "upsert", ([chunk_key(20000 + i) for i in range(5000)], [0] * 5000, vecs(5000))
    yield "remove", ([chunk_key(20000 + i) for i in range(4900)],)  # triggers compaction
    yield "remove_source", (1,)


def test_host_state_matches_jax_step_by_step():
    port = EmbeddingMatrix(DIM, dtype=torch.bfloat16, device="cpu")
    ref = JaxMatrix(DIM, dtype=jnp.bfloat16)
    assert _state(port) == _state(ref)
    for op, args in _steps(np.random.default_rng(0)):
        a, b = getattr(port, op)(*args), getattr(ref, op)(*args)
        assert a == b, op
        assert _state(port) == _state(ref), op
        np.testing.assert_array_equal(port._host_vectors[: port.rows], ref._host_vectors[: ref.rows])


def test_chunk_key_and_sweep_ladder_match():
    for item, ci in ((0, 0), (7, 3), (123456, 4095)):
        assert chunk_key(item, ci) == jax_chunk_key(item, ci)
    with pytest.raises(ValueError):
        chunk_key(1, 4096)
    for hwm, cap in ((0, 4096), (90_000, 131072), (800_000, 1 << 20), (950_000, 1 << 20), (5_000_000, 1 << 23)):
        assert sweep_rows_for(hwm, cap) == jax_sweep_rows_for(hwm, cap)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_device_tensors_follow_host(dtype):
    rng = np.random.default_rng(1)
    m = EmbeddingMatrix(DIM, dtype=dtype, device="cpu")
    v = rng.standard_normal((600, DIM)).astype(np.float32)
    m.upsert([chunk_key(i) for i in range(600)], [0] * 600, v)
    vecs, src = m.device_view()
    assert vecs.shape == (m.capacity, m.padded_dim) and vecs.dtype == dtype
    torch.testing.assert_close(vecs[:600, :DIM], torch.from_numpy(v).to(dtype))
    # incremental sync: a few rows change in place
    m.remove([chunk_key(3)])
    m.upsert([chunk_key(1000)], [2], v[:1] * 2)
    vecs, src = m.device_view()
    assert int(src[3]) == 2 and m.row_of[chunk_key(1000)] == 3
    torch.testing.assert_close(vecs[3, :DIM], torch.from_numpy(v[0] * 2).to(dtype))
    np.testing.assert_array_equal(src.numpy(), m.source_ids)


def test_quantized_tiers_raise():
    with pytest.raises(NotImplementedError):
        EmbeddingMatrix(DIM, dtype=torch.int8, device="cpu")
    m = EmbeddingMatrix(DIM, device="cpu")
    with pytest.raises(NotImplementedError):
        m.retier("int2")
