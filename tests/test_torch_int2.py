"""The port's int2 tier (coarse scores, exact select, fine phase, the
transposed int8 companion's scans, the matrix's device bytes) against the
JAX package's, on the CPU.

Same seeded numpy inputs to both.  The JAX Pallas kernels run in interpret
mode (``pallas_int2_scores``, ``scan_topk_pallas_int8t``) and the composed
pipeline with ``engine="xla"``, as the JAX package's own tests run them
here.  Tolerances:
  * 2-bit packing, scales and coarse scores: none, bit for bit;
  * int8 companion scans: scores bit for bit; rows equal outside exact
    score ties (the TPU kernel's tie order is no contract; the port's is
    the lower row first);
  * the exact select: the same set and floor as ``_select_topk_hier`` and
    ``lax.top_k`` (scores without ties at the boundary for the former);
  * the coarse-to-fine pipeline: vals, rows and floor bit for bit;
  * device bytes after staging, scatters, removals and retiers: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.index.matrix import INT2 as JAX_INT2
from perceive_tpu.index.matrix import EmbeddingMatrix as JaxMatrix
from perceive_tpu.ops import topk as jax_topk
from perceive_tpu_torch.index.matrix import INT2, EmbeddingMatrix, _quantize, _quantize2, int2_fine_bits
from perceive_tpu_torch.ops import int2, topk
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

N = 8192


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


# -- packing and scores ---------------------------------------------------------


@pytest.mark.parametrize("dim", [128, 100])
def test_quantize2_bit_exact(dim):
    """Bytes and scales equal JAX's, with zero rows, huge and tiny rows, and
    (at dim 100) the zero pad dims of a 128-wide mirror row."""
    rng = np.random.default_rng(dim)
    rows = np.zeros((40, 128), np.float32)
    rows[:, :dim] = rng.standard_normal((40, dim)).astype(np.float32)
    rows[0] = 0.0
    rows[1, :dim] *= 3e4
    rows[2, :dim] *= 1e-20
    rows[3, :dim] = np.linspace(-2, 2, dim)  # values on the grid's half steps
    got_p, got_s = _quantize2(rows, dim)
    want_p, want_s = JaxMatrix(dim, dtype=JAX_INT2)._quantize2(rows)
    assert got_p.dtype == np.uint8 and got_s.dtype == np.float32 and got_p.shape == (40, 32)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_s, want_s)


def _int2_inputs(n, d, nq, seed):
    rng = np.random.default_rng(seed)
    rows = _unit(rng.standard_normal((n, d)))
    p2, s2 = _quantize2(rows, d)
    f8, s8 = _quantize(rows)
    src = rng.integers(0, 4, n).astype(np.int32)
    src[rng.random(n) < 0.1] = -1
    q = _unit(rng.standard_normal((nq, d)))
    return rows, np.ascontiguousarray(p2.T), s2, np.ascontiguousarray(f8.T), s8, src, q


@pytest.mark.parametrize("nq,filt,n_sweep", [(1, None, 0), (3, [1, 3], 1536), (1, [0, 2], 5120), (8, None, 5120)])
def test_int2_scores_bit_exact(nq, filt, n_sweep):
    """unpack_int2 and scores_int2 equal the XLA reference; K5's plain
    version equals the Pallas kernel (interpret mode), masks included, also
    over a sweep of 5,120 rows: no multiple of K5's row tiles on the card
    (4,096 rows a tile up to 2 queries, 2,048 past that)."""
    _, p2, s2, _, _, src, q = _int2_inputs(8192 if n_sweep > 2048 else 2048, 128, nq, nq)
    qi8, qs = jax.jit(jax_topk.quantize_queries)(jnp.asarray(q))
    qi8_t, qs_t = _t(np.asarray(qi8), np.asarray(qs))
    np.testing.assert_array_equal(int2.unpack_int2(torch.from_numpy(p2)).numpy(),
                                  np.asarray(jax_topk.unpack_int2_xla(jnp.asarray(p2))))
    got = int2.scores_int2(*_t(p2, s2), qi8_t, qs_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_topk.xla_scores_int2(*_j(p2, s2), qi8, qs)))
    allowed = _allowed(filt)
    got = int2.int2_scores(*_t(p2, s2, src), qi8_t, qs_t, torch.from_numpy(allowed), n_sweep)
    n = n_sweep or p2.shape[1]
    want = jax_topk.pallas_int2_scores(jnp.asarray(p2), jnp.asarray(s2.reshape(1, -1)),
                                       jnp.asarray(src.reshape(1, -1)), qi8, qs, jnp.asarray(allowed),
                                       True, n_sweep)
    assert got.shape == (nq, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


INT8T_CASES = [
    # (d, nq, k, filter, n_sweep, ties)
    (128, 1, 16, None, 0, False),
    (128, 8, 64, [1, 3], 1536, False),
    (128, 8, 64, None, 0, True),
    (128, 256, 32, None, 0, False),  # K8's route
    (128, 300, 16, [0, 2], 1024, True),  # padded to 384: K8's route
]


@pytest.mark.parametrize("d,nq,k,filt,n_sweep,ties", INT8T_CASES)
def test_int8t_scan_matches_pallas_kernel(d, nq, k, filt, n_sweep, ties):
    rng = np.random.default_rng(nq + k)
    rows = _unit(rng.standard_normal((2048, d)))
    if ties:  # each row 8 times over: exact score ties
        rows = np.tile(rows[:256], (8, 1))
    f8, s8 = _quantize(rows)
    m8t = np.ascontiguousarray(f8.T)
    src = rng.integers(0, 4, 2048).astype(np.int32)
    src[rng.random(2048) < 0.1] = -1
    q = _unit(rng.standard_normal((nq, d)))
    allowed = _allowed(filt)
    got = topk.scan_topk_int8t(*_t(m8t, s8, src, q, allowed), k, n_sweep)
    want = jax_topk.scan_topk_pallas_int8t(*_j(m8t, s8, src, q, allowed), k, n_sweep)
    gv, gr = got[0].numpy(), got[1].numpy()
    wv, wr = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_array_equal(gv, wv)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(gr[~fin], -1)
    for qi, j in zip(*np.nonzero((gr != wr) & fin)):  # rows differ only inside exact ties
        assert (wv[qi] == wv[qi, j]).sum() > 1
    if ties:  # the port's tie rule: lower row first
        same = (gv[:, 1:] == gv[:, :-1]) & np.isfinite(gv[:, 1:])
        assert same.any() and (gr[:, 1:][same] > gr[:, :-1][same]).all()
    qi8, qs = topk.quantize_queries(torch.from_numpy(q))
    np.testing.assert_array_equal(
        topk.scores_int8t(*_t(m8t, s8), qi8, qs).numpy(),
        np.asarray(jax_topk.xla_scores_int8t(*_j(m8t, s8, qi8.numpy(), qs.numpy()))))


@pytest.mark.parametrize("kc", [1, 100, 1024, 4096])
def test_select_topk_plain_matches_jax(kc):
    """K6's plain version: the set and floor of ``_select_topk_hier`` and
    ``lax.top_k``, ordered by row; ties (here: a run of equal scores and the
    -inf rows) go to the lower row, as lax.top_k takes them."""
    rng = np.random.default_rng(kc)
    scores = rng.standard_normal((2, 8192)).astype(np.float32)
    scores[1, rng.random(8192) < 0.5] = -np.inf
    v, r, f = int2.select_topk(torch.from_numpy(scores), kc)
    assert (np.diff(r.numpy(), axis=1) > 0).all()
    for qi in range(2):
        tv, ti = jax.lax.top_k(jnp.asarray(scores[qi]), kc)
        assert set(r[qi].tolist()) == set(np.asarray(ti).tolist())
        assert f[qi] == np.asarray(tv)[-1]
        np.testing.assert_array_equal(v[qi].numpy(), scores[qi][r[qi].numpy()])
        if qi == 0 and 8192 // 128 >= kc:
            hv, hi = jax_topk._select_topk_hier(jnp.asarray(scores[qi]), kc)
            assert set(np.asarray(hi).tolist()) == set(r[qi].tolist()) and np.asarray(hv)[-1] == f[qi]
    ties = np.repeat(np.arange(64, dtype=np.float32), 128)[None]  # 128 rows of each score
    _, tr, tf = int2.select_topk(torch.from_numpy(ties), 200)
    np.testing.assert_array_equal(tr[0].numpy(), np.r_[62 * 128 : 62 * 128 + 72, 63 * 128 : 64 * 128])
    assert tf[0] == 62.0
    _, ar, af = int2.select_topk(torch.full((1, 300), -np.inf), 50)  # a filter that matches nothing
    np.testing.assert_array_equal(ar[0].numpy(), np.arange(50))
    assert af[0] == -np.inf


@pytest.mark.parametrize("k,kc,filt,n_sweep", [(64, 1024, None, 0), (32, 512, [1, 2], 6144),
                                                (16, 100, [0], 0), (64, 8192, None, 0)])
def test_coarse_fine_matches_jax(k, kc, filt, n_sweep):
    """scan_int2_coarse_fine against the JAX pipeline (engine="xla", int8
    companion): fine scores, rows and the coarse floor bit for bit (the
    floor is -inf when the whole sweep is fetched)."""
    _, p2, s2, f8, s8, src, q = _int2_inputs(N, 128, 4, k + kc)
    allowed = _allowed(filt)
    got = int2.scan_int2_coarse_fine(*_t(p2, s2, f8, s8, src, q, allowed), k, k_coarse=kc, n_sweep=n_sweep)
    want = jax.jit(lambda *a: jax_topk.scan_int2_coarse_fine(
        *a, k, k_coarse=kc, engine="xla", n_sweep=n_sweep, fine_bits=8))(*_j(p2, s2, f8, s8, src, q, allowed))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == torch.int32
    assert np.isfinite(got[2].numpy()).all() == (kc < (n_sweep or N))
    plain = int2.scan_int2_coarse_fine_plain(*_t(p2, s2, f8, s8, src, q, allowed), k, k_coarse=kc,
                                             n_sweep=n_sweep)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


def test_coarse_depth_matches_jax():
    for k, n, fetch in ((10, 10**6, 0), (3000, 10**6, 0), (10, 2000, 0), (64, 10**6, 1024)):
        assert int2.int2_coarse_depth(k, n, fetch) == jax_topk.int2_coarse_depth(k, n, fetch)
    assert int2.INT2_COARSE_FETCH == jax_topk.INT2_COARSE_FETCH


# -- the matrix --------------------------------------------------------------------


def _device_bytes(m):
    vectors, src, scales = m.device_view()
    if isinstance(vectors, tuple):
        return [np.asarray(x) for x in (*vectors, *scales, src)]
    return [np.asarray(x) for x in (vectors, scales, src)]


def _assert_same_bytes(p, j):
    for a, b in zip(_device_bytes(p), _device_bytes(j), strict=True):
        np.testing.assert_array_equal(a, b)


def test_int2_matrix_device_bytes_match_jax(monkeypatch):
    monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE", "int8")
    rng = np.random.default_rng(5)
    d = 100  # padded to 128: pad lanes quantize too
    vecs = rng.standard_normal((3000, d)).astype(np.float32)
    p = EmbeddingMatrix(d, dtype=INT2, device="cpu")
    j = JaxMatrix(d, dtype=JAX_INT2)
    keys = list(range(3000))
    for m in (p, j):
        m.upsert(keys, [k % 3 for k in keys], vecs)
    assert p.packed2 and p.quant_bits == 2 and p.fine_bits == 8 and p.tier_name == j.tier_name == "int2+int8fine"
    _assert_same_bytes(p, j)
    assert (p.scale_hw, p.norm_hw) == (j.scale_hw, j.norm_hw)
    more = rng.standard_normal((2, d)).astype(np.float32) * 4
    for m in (p, j):  # a few dirty rows: column scatters
        m.upsert([5, 9000], [2, 1], more)
        m.remove([7, 8, 11])
    assert p._dirty_rows and not p._dirty
    _assert_same_bytes(p, j)
    assert (p.scale_hw, p.norm_hw) == (j.scale_hw, j.norm_hw)
    for tier_p, tier_j in ((torch.int8, jnp.int8), (INT2, JAX_INT2), (torch.int8, jnp.int8)):
        p.retier(tier_p)
        j.retier(tier_j)
        _assert_same_bytes(p, j)
        assert (p.scale_hw, p.norm_hw) == (j.scale_hw, j.norm_hw)
    assert p.mutation_gen == j.mutation_gen


def test_int2_fine_bits_policy(monkeypatch):
    """The companion is int8 while coarse + int8 fit the budget, else the
    packed int4 one, which stages (``int2+int4fine``); the pin decides
    first."""
    monkeypatch.delenv("PERCEIVE_TPU_INT2_FINE", raising=False)
    monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE_INT8_GB", "1")
    cpu = torch.device("cpu")
    assert int2_fine_bits(4096, 384, cpu) == 8
    assert int2_fine_bits(4_000_000, 384, cpu) == 4
    monkeypatch.delenv("PERCEIVE_TPU_INT2_FINE_INT8_GB")
    assert int2_fine_bits(20_000_000, 384, cpu) == 8  # 9.6 GB of the 10 GB default
    monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE", "int4")
    m = EmbeddingMatrix(64, dtype=INT2, device="cpu")
    m.upsert([1], [0], np.ones((1, 64), np.float32))
    (coarse, fine), _, (_, fscales) = m.device_view()
    assert fine.dtype == torch.uint8 and fine.shape == (64, m.capacity) and fscales.shape == (m.capacity,)
    assert m.fine_bits == 4 and m.tier_name == "int2+int4fine"
