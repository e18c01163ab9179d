"""The port's packed-int4 tier (nibble packing, unpack, scores, K9's plain
version through the flat and slab routes, the int2 pipeline over the int4
companion, the matrix's device bytes) against the JAX package's, on the
CPU.

Same seeded numpy inputs to both.  The JAX Pallas kernel runs in
interpret mode (``scan_topk_pallas_int4``) and the composed int2 pipeline
with ``engine="xla"``, as the JAX package's own tests run them here.  No
tolerance anywhere:
  * packing, scales, the unpack of random bytes (a low nibble of 0
    included) and the scores: bit for bit;
  * the scans: scores bit for bit against the Pallas kernel and rows
    equal outside exact score ties; against the XLA reference (``lax.top_k``
    of the masked ``xla_scores_int4``, lower row first) scores and rows bit
    for bit, ties included;
  * the int2 pipeline over the int4 companion: vals, rows and floor bit
    for bit;
  * device bytes after staging, column scatters, removals and retiers
    between every tier: equal, with the same quantization stats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.index.matrix import INT2 as JAX_INT2
from perceive_tpu.index.matrix import INT4 as JAX_INT4
from perceive_tpu.index.matrix import EmbeddingMatrix as JaxMatrix
from perceive_tpu.index.searcher import _scan_topk_xla_int4
from perceive_tpu.ops import topk as jax_topk
from perceive_tpu_torch.index.matrix import INT2, INT4, EmbeddingMatrix, _quantize2, _quantize4
from perceive_tpu_torch.ops import int2, topk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

N, D = 4096, 128  # one compiled shape of the JAX references for every case


def _unit(x):
    return (x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)).astype(np.float32)


def _allowed(ids=None):
    a = np.full(16, -9, dtype=np.int32)
    if ids is None:
        a[0] = topk.ALLOW_ALL
    else:
        a[: len(ids)] = ids
    return a


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


@pytest.mark.parametrize("dim", [128, 100])
def test_quantize4_bit_exact(dim):
    """Bytes and scales equal JAX's, with zero rows, huge and tiny rows,
    values on the half steps, and (at dim 100) the zero pad dims."""
    rng = np.random.default_rng(dim)
    rows = np.zeros((40, 128), np.float32)
    rows[:, :dim] = rng.standard_normal((40, dim)).astype(np.float32)
    rows[0] = 0.0
    rows[1, :dim] *= 3e4
    rows[2, :dim] *= 1e-20
    rows[3, :dim] = np.linspace(-7.5, 7.5, dim)
    got_p, got_s = _quantize4(rows)
    want_p, want_s = JaxMatrix(dim, dtype=JAX_INT4)._quantize4(rows)
    assert got_p.dtype == np.uint8 and got_s.dtype == np.float32 and got_p.shape == (40, 64)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_s, want_s)


def test_unpack_and_scores_bit_exact_on_random_bytes():
    """Every byte value decodes as JAX decodes it, a low nibble of 0 (-8,
    which ``_quantize4`` never writes) included; the scores follow."""
    rng = np.random.default_rng(1)
    packed = rng.integers(0, 256, (D // 2, 1024)).astype(np.uint8)
    packed[:, :256] = np.arange(256, dtype=np.uint8)[None, :]  # every byte value
    assert ((packed & 15) == 0).any()
    got = topk.unpack_int4(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_topk.unpack_int4_xla(jnp.asarray(packed))))
    assert got.min() == -8 and got.max() == 7
    scales = (rng.random(1024) + 0.5).astype(np.float32)
    q = _unit(rng.standard_normal((3, D)))
    qi8, qs = topk.quantize_queries(torch.from_numpy(q))
    np.testing.assert_array_equal(
        topk.scores_int4(*_t(packed, scales), qi8, qs).numpy(),
        np.asarray(jax_topk.xla_scores_int4(*_j(packed, scales, qi8.numpy(), qs.numpy()))))


def _int4_inputs(nq, seed, ties=False, random_bytes=False):
    rng = np.random.default_rng(seed)
    rows = _unit(rng.standard_normal((N, D)))
    if ties:  # each row 8 times over: exact score ties
        rows = np.tile(rows[: N // 8], (8, 1))
    packed, scales = _quantize4(rows)
    packed = np.ascontiguousarray(packed.T)
    if random_bytes:  # low nibbles of 0 included
        packed = rng.integers(0, 256, packed.shape).astype(np.uint8)
    src = rng.integers(0, 4, N).astype(np.int32)
    src[rng.random(N) < 0.1] = -1  # tombstones
    q = _unit(rng.standard_normal((nq, D)))
    return packed, scales, src, q


INT4_CASES = [
    # (nq, k, filter, n_sweep, ties, random bytes)
    (1, 16, None, 0, False, False),
    (1, 1024, [1, 3], 3072, False, True),
    (8, 16, [0, 2], 0, True, False),
    (8, 1024, None, 2560, False, False),
    (256, 16, None, 0, False, True),  # the slab route
    (256, 1024, [1], 3584, True, False),
    (300, 16, [0, 2], 1024, False, False),  # padded to 384: the slab route
]


@pytest.mark.parametrize("nq,k,filt,n_sweep,ties,random_bytes", INT4_CASES)
def test_int4_scan_matches_jax(nq, k, filt, n_sweep, ties, random_bytes):
    packed, scales, src, q = _int4_inputs(nq, nq + k, ties, random_bytes)
    allowed = _allowed(filt)
    gv, gr = (x.numpy() for x in topk.scan_topk_int4(*_t(packed, scales, src, q, allowed), k, n_sweep))
    want = jax_topk.scan_topk_pallas_int4(*_j(packed, scales, src, q, allowed), k, n_sweep)
    wv, wr = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_array_equal(gv, wv)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(gr[~fin], -1)
    for qi, j in zip(*np.nonzero((gr != wr) & fin)):  # the TPU kernel's tie order is no contract
        assert (wv[qi] == wv[qi, j]).sum() > 1
    xv, xr = _scan_topk_xla_int4(*_j(packed, scales, src, q, allowed), k, n_sweep)
    np.testing.assert_array_equal(gv, np.asarray(xv))
    np.testing.assert_array_equal(gr[fin], np.asarray(xr)[fin])  # ties: the lower row first
    if ties:
        same = (gv[:, 1:] == gv[:, :-1]) & np.isfinite(gv[:, 1:])
        assert same.any() and (gr[:, 1:][same] > gr[:, :-1][same]).all()
    # the kernel wrappers (here: their plain version) give the same
    qi8, qs = topk.quantize_queries(torch.from_numpy(q))
    wrapper = topk.scan_topk_int4_slab if nq >= 256 else topk.scan_topk_int4_flat
    v, r = wrapper(*_t(packed, scales, src), qi8, qs, torch.from_numpy(allowed), k, n_sweep)
    np.testing.assert_array_equal(v.numpy(), gv)
    np.testing.assert_array_equal(r.numpy(), gr)


def test_int4_plain_row_chunks_merge_exactly(monkeypatch):
    """The plain version's row chunks (one in the cases above, hundreds at
    25M rows) merge to the same top k: dense ties across chunks, a filter
    and a sweep prefix included."""
    packed, scales, src, q = _int4_inputs(5, 3, ties=True)
    packed, scales, src = np.concatenate([packed, packed], 1), np.tile(scales, 2), np.tile(src, 2)
    qi8, qs = topk.quantize_queries(torch.from_numpy(q))
    args = (*_t(packed, scales, src), qi8, qs, torch.from_numpy(_allowed([0, 1, 3])))
    for n_sweep in (0, 6144):
        whole = topk.scan_topk_int4_plain(*args, 300, n_sweep)
        monkeypatch.setattr(topk, "_PLAIN_BYTES", 1)  # chunks of 4,096 rows: two or more
        chunked = topk.scan_topk_int4_plain(*args, 300, n_sweep)
        monkeypatch.undo()
        assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])
        assert int((whole[1] >= N).sum()) > 0  # the second chunk contributed


@pytest.mark.parametrize("k,kc,filt,n_sweep", [(64, 1024, None, 0), (32, 512, [1, 2], 3072), (64, 4096, None, 0)])
def test_coarse_fine_int4_companion_matches_jax(k, kc, filt, n_sweep):
    """scan_int2_coarse_fine over the packed int4 companion against the
    JAX pipeline (engine="xla", fine_bits=4): fine scores, rows and the
    coarse floor bit for bit; the plain twin equals it."""
    rng = np.random.default_rng(k + kc)
    rows = _unit(rng.standard_normal((N, D)))
    p2, s2 = _quantize2(rows, D)
    p4, s4 = _quantize4(rows)
    p2, p4 = np.ascontiguousarray(p2.T), np.ascontiguousarray(p4.T)
    src = rng.integers(0, 4, N).astype(np.int32)
    src[rng.random(N) < 0.1] = -1
    q = _unit(rng.standard_normal((2, D)))
    allowed = _allowed(filt)
    got = int2.scan_int2_coarse_fine(*_t(p2, s2, p4, s4, src, q, allowed), k, k_coarse=kc, n_sweep=n_sweep)
    want = jax.jit(lambda *a: jax_topk.scan_int2_coarse_fine(
        *a, k, k_coarse=kc, engine="xla", n_sweep=n_sweep, fine_bits=4))(*_j(p2, s2, p4, s4, src, q, allowed))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    plain = int2.scan_int2_coarse_fine_plain(*_t(p2, s2, p4, s4, src, q, allowed), k, k_coarse=kc,
                                             n_sweep=n_sweep)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


# -- the matrix --------------------------------------------------------------------


def _device_bytes(m):
    """The device tensors of either package as numpy arrays (bf16 widened
    to f32, exactly)."""
    vectors, src, scales = m.device_view()
    flat = (*vectors, *scales, src) if isinstance(vectors, tuple) else (vectors, scales, src)
    out = []
    for x in flat:
        if isinstance(x, torch.Tensor):
            x = x.float() if x.dtype == torch.bfloat16 else x
            out.append(x.numpy())
        else:
            out.append(None if x is None else np.asarray(x).astype(np.float32)
                       if np.asarray(x).dtype == jnp.bfloat16 else np.asarray(x))
    return out


def _assert_same_bytes(p, j):
    for a, b in zip(_device_bytes(p), _device_bytes(j), strict=True):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tier_p,tier_j", [(INT4, JAX_INT4), (INT2, JAX_INT2)])
def test_int4_matrix_device_bytes_match_jax(monkeypatch, tier_p, tier_j):
    """The int4 tier, and the int2 tier with the int4 companion: the device
    bytes equal JAX's ``device_view`` after the full staging, after column
    scatters of a few dirty rows (upserts, a reused row, removals), and
    through retiers to and from every other tier."""
    monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE", "int4")
    rng = np.random.default_rng(7)
    d = 100  # padded to 128: pad lanes quantize too
    vecs = rng.standard_normal((3000, d)).astype(np.float32)
    p = EmbeddingMatrix(d, dtype=tier_p, device="cpu")
    j = JaxMatrix(d, dtype=tier_j)
    keys = list(range(3000))
    for m in (p, j):
        m.upsert(keys, [k % 3 for k in keys], vecs)
    assert p.quant_bits == j.quant_bits and p.tier_name == j.tier_name
    assert p.tier_name == ("int4" if tier_p == INT4 else "int2+int4fine")
    _assert_same_bytes(p, j)
    assert (p.scale_hw, p.norm_hw) == (j.scale_hw, j.norm_hw)
    more = rng.standard_normal((2, d)).astype(np.float32) * 4
    for m in (p, j):
        m.remove([7, 8, 11])
        m.upsert([5, 9000], [2, 1], more)  # 9000 reuses a freed row
    assert p._dirty_rows and not p._dirty
    _assert_same_bytes(p, j)
    assert (p.scale_hw, p.norm_hw) == (j.scale_hw, j.norm_hw)
    for tp, tj in ((torch.int8, jnp.int8), (INT4, JAX_INT4), (torch.bfloat16, jnp.bfloat16), (INT4, JAX_INT4),
                   (INT2, JAX_INT2), (INT4, JAX_INT4), (torch.float32, jnp.float32), (tier_p, tier_j)):
        p.retier(tp)
        j.retier(tj)
        assert p.tier_name == j.tier_name
        _assert_same_bytes(p, j)
        assert (p.scale_hw, p.norm_hw) == (j.scale_hw, j.norm_hw)
    assert p.mutation_gen == j.mutation_gen and p.reuse_gen == j.reuse_gen
