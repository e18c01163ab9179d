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
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

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


def _tensors(m):
    """Every device tensor and the quantization stats of ``m``, on the host."""
    vecs, src, scales = m.device_view()
    flat = [*(vecs if isinstance(vecs, tuple) else (vecs,)), src,
            *(scales if isinstance(scales, tuple) else (scales,))]
    return [t.float().numpy() for t in flat if t is not None], (m.scale_hw, m.norm_hw)


@pytest.mark.parametrize("tier", ["bfloat16", "int8", "int4", "int2"])
def test_threaded_host_passes_equal_serial(tier, tmp_path, monkeypatch):
    """The mirror's chunked host passes (the full upload, a retier's
    statistics, a snapshot's quantized payload) give the same device bytes,
    stats and snapshot members on worker threads as on one, over many
    chunks."""
    import perceive_tpu_torch.index.matrix as mx

    monkeypatch.setattr(EmbeddingMatrix, "_SYNC_CHUNK_ROWS", 64)
    rng = np.random.default_rng(7)
    v = rng.standard_normal((1000, DIM)).astype(np.float32) * rng.uniform(0.1, 3, (1000, 1)).astype(np.float32)
    got = {}
    for workers in (1, 4):
        monkeypatch.setattr(mx, "_HOST_WORKERS", workers)
        m = EmbeddingMatrix(DIM, dtype=torch.float32, device="cpu")
        m.upsert([chunk_key(i) for i in range(1000)], [i % 3 for i in range(1000)], v)
        m.retier(getattr(torch, tier) if tier in ("bfloat16", "int8") else tier)
        tensors, stats = _tensors(m)
        path = str(tmp_path / f"snap{workers}.npz")
        assert m.save_snapshot(path) == "full"
        with np.load(path) as z:
            members = {k: z[k] for k in z.files if k != "base_token"}
        got[workers] = tensors, stats, members
    (t1, s1, z1), (t4, s4, z4) = got[1], got[4]
    assert s1 == s4
    assert len(t1) == len(t4)
    for a, b in zip(t1, t4):
        np.testing.assert_array_equal(a, b)
    assert z1.keys() == z4.keys()
    for k in z1:
        np.testing.assert_array_equal(z1[k], z4[k], err_msg=k)


def test_ordered_map_keeps_order_and_raises(monkeypatch):
    """Results come back in the order of the items, with a bounded window;
    a worker's exception reaches the consumer."""
    import perceive_tpu_torch.index.matrix as mx

    monkeypatch.setattr(mx, "_HOST_WORKERS", 3)
    drawn = []

    def items():
        for i in range(50):
            drawn.append(i)
            yield i

    out = []
    for r in mx._ordered_map(lambda i: i * i, items()):
        out.append(r)
        assert len(drawn) <= len(out) + 2 * 3  # at most two a worker ahead
    assert out == [i * i for i in range(50)]

    def boom(i):
        if i == 7:
            raise ValueError("chunk 7")
        return i

    with pytest.raises(ValueError, match="chunk 7"):
        list(mx._ordered_map(boom, range(20)))


def test_chunk0_batches_join_existing_groups():
    """Batches of chunk-0 keys only (upsert's fast path) still join the
    groups that later chunks made first, as in the JAX package."""
    rng = np.random.default_rng(4)
    port = EmbeddingMatrix(DIM, dtype=torch.float32, device="cpu")
    ref = JaxMatrix(DIM, dtype=jnp.float32)
    steps = [
        [chunk_key(6000, 1), chunk_key(6000, 2), chunk_key(6001, 3)],  # groups without their chunk 0
        [chunk_key(i) for i in range(1, 50)],  # chunk 0 only, no group among them
        [chunk_key(6000), chunk_key(70)],  # chunk 0 only, one joins a group
        [chunk_key(6001), chunk_key(6000)],
    ]
    for keys in steps:
        v = rng.standard_normal((len(keys), DIM)).astype(np.float32)
        for m in (port, ref):
            m.upsert(keys, [0] * len(keys), v)
        assert _state(port) == _state(ref), keys
    assert sorted(port.groups[6000]) == [chunk_key(6000, c) for c in range(3)]


@pytest.mark.parametrize("spilled", [False, True])
def test_mirror_reads_are_copies_of_the_rows(spilled, tmp_path):
    """``read_f32`` gives the rows and columns asked for as an f32 copy, for
    a slice, int indices (a list, an array, negative, none) and a mask, in
    RAM and spilled to a file."""
    from perceive_tpu_torch.index.matrix import HostMirror

    mirror = HostMirror(64, 8, ram_budget=0 if spilled else None, dir=str(tmp_path))
    assert (mirror.path is not None) == spilled
    mirror.arr[:] = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    mask = np.zeros(64, dtype=bool)
    mask[[3, 9, 40]] = True
    for rows in (slice(5, 20), [7, 2, 7], np.array([63, 0, 31]), [-1, -64], [], mask):
        for ncols in (None, 8, 5):
            got = mirror.read_f32(rows, ncols)
            want = np.asarray(mirror.arr)[rows][:, : ncols or 8].astype(np.float32)
            assert got.dtype == np.float32 and got.flags.c_contiguous
            np.testing.assert_array_equal(got, want)
            assert not np.shares_memory(got, mirror.arr)
    mirror.close()
