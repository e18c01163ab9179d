"""The port's EmbeddingMatrix host state against the JAX package's, step by
step through one upsert / remove / re-upsert / source-removal sequence
(exact equality: the bookkeeping is integer logic), plus its device
tensors against the host mirror, at the bf16, f32 and int8 tiers (and
the int4 tier's construction and retiers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.index.matrix import EmbeddingMatrix as JaxMatrix
from perceive_tpu.index.matrix import chunk_key as jax_chunk_key
from perceive_tpu.index.matrix import sweep_rows_for as jax_sweep_rows_for
from perceive_tpu_torch.index.matrix import EmbeddingMatrix, _quantize, chunk_key, sweep_rows_for

DIM = 48


def _state(m):
    return {
        "mutation_gen": m.mutation_gen,
        "scale_hw": m.scale_hw,
        "norm_hw": m.norm_hw,
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


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_host_state_matches_jax_step_by_step(dtype):
    port = EmbeddingMatrix(DIM, dtype=getattr(torch, dtype), device="cpu")
    ref = JaxMatrix(DIM, dtype=getattr(jnp, dtype))
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
    vecs, src, scales = m.device_view()
    assert vecs.shape == (m.capacity, m.padded_dim) and vecs.dtype == dtype and scales is None
    torch.testing.assert_close(vecs[:600, :DIM], torch.from_numpy(v).to(dtype))
    # incremental sync: a few rows change in place
    m.remove([chunk_key(3)])
    m.upsert([chunk_key(1000)], [2], v[:1] * 2)
    vecs, src, _ = m.device_view()
    assert int(src[3]) == 2 and m.row_of[chunk_key(1000)] == 3
    torch.testing.assert_close(vecs[3, :DIM], torch.from_numpy(v[0] * 2).to(dtype))
    np.testing.assert_array_equal(src.numpy(), m.source_ids)


def test_quantized_tiers_raise():
    """int8, int4 and int2 are stored: an int4 matrix builds and stages its
    packed (padded_dim / 2, capacity) bytes, a matrix retiers into and out
    of int4; an unknown tier raises, at construction and on a retier."""
    m4 = EmbeddingMatrix(DIM, dtype="int4", device="cpu")
    m4.upsert([chunk_key(1)], [0], np.ones((1, DIM), np.float32))
    packed, _, scales = m4.device_view()
    assert m4.packed4 and m4.quant_bits == 4 and m4.tier_name == "int4"
    assert packed.dtype == torch.uint8 and packed.shape == (m4.padded_dim // 2, m4.capacity)
    assert scales.shape == (m4.capacity,)
    with pytest.raises(ValueError, match="unknown storage tier"):
        EmbeddingMatrix(DIM, dtype="fp8", device="cpu")
    m = EmbeddingMatrix(DIM, device="cpu")
    m.retier(torch.int8)
    assert m.quantized and m.quant_bits == 8
    m.retier("int2")
    assert m.quantized and m.quant_bits == 2 and m.packed2
    m.retier("int4")
    assert m.quantized and m.quant_bits == 4 and m.packed4 and not m.packed2
    m.retier(torch.bfloat16)
    assert not m.quantized and m.quant_bits == 0
    with pytest.raises(ValueError):
        m.retier("int3")
    assert EmbeddingMatrix(DIM, dtype="int2", device="cpu").tier_name == "int2+int8fine"


def test_device_is_required():
    with pytest.raises(TypeError):
        EmbeddingMatrix(DIM)  # noqa: the port never picks a device


def _int8_pair(rng, n=700):
    port = EmbeddingMatrix(DIM, dtype=torch.int8, device="cpu")
    ref = JaxMatrix(DIM, dtype=jnp.int8)
    v = rng.standard_normal((n, DIM)).astype(np.float32)
    v[3] = 0.0  # an all-zero row keeps its floor scale
    v[5, 7] = 1e4  # a row dominated by one dim
    keys = [chunk_key(i) for i in range(n)]
    for m in (port, ref):
        m.upsert(keys, [i % 3 for i in range(n)], v)
    return port, ref, v, keys


def test_int8_stored_bytes_equal_jax():
    """The device int8 rows and f32 scales are the JAX package's, byte for
    byte: after a full staging, and after a dirty-row scatter."""
    rng = np.random.default_rng(2)
    port, ref, v, keys = _int8_pair(rng)
    for step in range(2):
        pv, psrc, pscales = port.device_view()
        rv, rsrc, rscales = ref.device_view()
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(pscales.numpy(), np.asarray(rscales))
        np.testing.assert_array_equal(psrc.numpy(), np.asarray(rsrc))
        assert pv.dtype == torch.int8 and pscales.dtype == torch.float32
        w = rng.standard_normal((5, DIM)).astype(np.float32) * 3
        for m in (port, ref):  # few rows: the next sync scatters them
            m.upsert(keys[10:15], [1] * 5, w)
            m.remove(keys[20 + 2 * step : 22 + 2 * step])
        assert not port._dirty and len(port._dirty_rows) == 7
    q_port, s_port = _quantize(v)
    q_ref, s_ref = ref._quantize(v)
    np.testing.assert_array_equal(q_port, q_ref)
    np.testing.assert_array_equal(s_port, s_ref)


def test_retier_follows_jax():
    """bf16 -> int8 -> f32 -> int8: generations, quantization stats and the
    restaged bytes match the JAX package's."""
    rng = np.random.default_rng(3)
    port = EmbeddingMatrix(DIM, dtype=torch.bfloat16, device="cpu")
    ref = JaxMatrix(DIM, dtype=jnp.bfloat16)
    v = rng.standard_normal((900, DIM)).astype(np.float32)
    for m in (port, ref):
        m.upsert([chunk_key(i) for i in range(900)], [0] * 900, v)
    for dt in ("int8", "float32", "int8"):
        port.retier(getattr(torch, dt))
        ref.retier(getattr(jnp, dt))
        assert _state(port) == _state(ref), dt
        assert port.tier_name == ref.tier_name == dt
        pv, _, pscales = port.device_view()
        rv, _, rscales = ref.device_view()
        np.testing.assert_array_equal(pv.float().numpy(), np.asarray(rv, np.float32))
        if dt == "int8":
            np.testing.assert_array_equal(pscales.numpy(), np.asarray(rscales))
