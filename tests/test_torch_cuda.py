"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU these skip.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py imports jax, which a GPU machine
need not have.)

The kernels build from perceive_tpu_torch/csrc on the first launch.
Tolerances: bf16/f32 scan scores 1e-4 (f32 sums in another order); the int8
scans (K3, K4, and K7, K8 over the transposed companion), the packed-int4
scans (K9, flat and slab) and the int2 coarse scores (K5) none: scores and
rows equal the plain version's bit for bit; the exact select (K6) returns the plain version's set, order and floor
exactly (``test_select_topk_matches_plain``: every route of its design, each case twice); the tiletop scores
(K10) equal theirs bit for bit, vals and rows (``test_int2_tiletop_bit_exact``: every tile size, M and query
tile, each case twice), and so do the tiletop, window and threshold pipelines; attention 1e-2 in bf16 against the f32 math on the same bf16
inputs, 1e-5 in f32.  The redesigned kernels have cases of their own: K2
(``test_scan_slab_bf16_*``: every sweep width and depth, scores that ascend
along the sweep, all-equal scores, a filter that keeps ~1% of the rows, a
sweep that ends inside a row tile), K1 (``test_scan_flat_bf16_*``: bf16
and f32, widths on the CUDA cores and on the tensor cores, every depth, the
same adversarial orders, the tie rule), K9's slab kernel
(``test_scan_slab_int4_*``: bit for bit at every width, the same
adversarial orders), K4 and K8 (``test_scan_slab_int8*``: bit for bit at
every width and at k 32, 33 and 8,192, a filtered ragged sweep, one
launch a sweep, the same adversarial orders, TMA's column rule), K7 and
K9 flat (``test_scan_topk_int8t_bit_exact``, ``test_scan_topk_int4_bit_exact``
at widths on both sides of each crossover and depths through the
multi-block pass 2; ``test_scan_flat_cols_*``: the adversarial orders,
every row masked, one live row at the sweep's end, dense ties at k =
8,192, TMA's column rule), K3 (``test_scan_flat_int8_*``: bit for bit
at widths on both sides of its crossover and at 64/65 and 255 queries,
depths 1 to 8,192 through the multi-block pass 2, both filters, dense
ties, a partial last tile, each case twice back to back), K5
(``test_int2_scores_widths_bit_exact``: 1, 3, 8 and 33 queries over a
prefix of the columns, twice back to back; ``test_int2_scores_refuses_*``)
and K11's
bf16 path
(``test_attention_bf16_tensor_cores``: S 100, 384 and 512, DH 16, 32 and
64, masks with whole padded key tiles, one kept key, or none).  The serve
layer has two: the doctor's build-and-launch check passes
(``test_doctor_device_checks_pass``), and one served ``/search`` on a
CUDA AppState returns the hits of ``scan_topk_plain`` over the same matrix
(``test_served_search_equals_plain_scan``).  The sharded searcher has one:
four slots on the card answer as the one-device searcher at every tier
(``test_sharded_searcher_on_four_slots_equals_one_device``).
"""

import pytest
import torch

from perceive_tpu_torch.ops import attention as attn
from perceive_tpu_torch.ops import int2, topk

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _allowed(dev, ids=None):
    a = torch.full((16,), -9, dtype=torch.int32, device=dev)
    if ids is None:
        a[0] = topk.ALLOW_ALL
    else:
        a[: len(ids)] = torch.tensor(ids, dtype=torch.int32)
    return a


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq,k,filt,n_sweep", [(1, 16, None, 0), (5, 100, [1], 20480), (40, 600, [0, 2], 0)])
def test_scan_topk_matches_plain(dev, dtype, nq, k, filt, n_sweep):
    g = torch.Generator(device=dev).manual_seed(nq + k)
    m = torch.randn((32768, 384), generator=g, device=dev)
    m = (m / m.norm(dim=1, keepdim=True)).to(dtype)
    src = torch.randint(0, 3, (32768,), generator=g, device=dev, dtype=torch.int32)
    src[torch.rand((32768,), generator=g, device=dev) < 0.2] = -1
    q = torch.randn((nq, 384), generator=g, device=dev)
    before = topk.LAUNCHES
    vk, rk = topk.scan_topk(m, src, q, _allowed(dev, filt), k, n_sweep)
    vp, rp = topk.scan_topk_plain(m, src, q, _allowed(dev, filt), k, n_sweep)
    torch.cuda.synchronize()
    assert topk.LAUNCHES == before + 1
    torch.testing.assert_close(vk, vp, atol=1e-4, rtol=0)
    # rows may differ only inside near ties
    diff = rk != rp
    if diff.any():
        near = (vp[:, 1:] - vp[:, :-1]).abs() <= 2e-4
        near = torch.nn.functional.pad(near, (1, 0)) | torch.nn.functional.pad(near, (0, 1))
        assert bool((~diff | near).all())


@pytest.mark.parametrize("b,s,nh,dh,dtype,tol", [
    (4, 384, 12, 32, torch.bfloat16, 1e-2),
    (2, 512, 12, 64, torch.bfloat16, 1e-2),
    (3, 100, 4, 16, torch.float32, 1e-5),
    (2, 512, 2, 32, torch.float32, 1e-5),
])
def test_attention_matches_plain(dev, b, s, nh, dh, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(s + dh)
    # v at half scale keeps |out| near 1, where one bf16 rounding is ~4e-3
    q, k, v = ((torch.randn((b, s, nh, dh), generator=g, device=dev) * sd).to(dtype) for sd in (1.0, 1.0, 0.5))
    lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None]).to(torch.int32)
    before = attn.LAUNCHES
    got = attn.attention(q, k, v, mask)
    want = attn.attention_plain(q.float(), k.float(), v.float(), mask)
    torch.cuda.synchronize()
    assert attn.LAUNCHES == before + 1
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)


def _int8_inputs(dev, n, nq, seed, dup=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((n, 384), generator=g, device=dev)
    if dup:  # every row 8 times over: dense exact ties
        v = v[: n // 8].repeat(8, 1)
    scales = torch.clamp(v.abs().amax(dim=1), min=1e-12) / 127.0
    m = torch.clamp(torch.round(v / scales[:, None]), -127, 127).to(torch.int8).contiguous()
    src = torch.randint(0, 3, (n,), generator=g, device=dev, dtype=torch.int32)
    src[torch.rand((n,), generator=g, device=dev) < 0.2] = -1
    qi8, qscale = topk.quantize_queries(torch.randn((nq, 384), generator=g, device=dev))
    return m, scales.float(), src, qi8, qscale


@pytest.mark.parametrize("kernel,nq", [("flat", 1), ("flat", 5), ("flat", 40), ("slab", 256), ("slab", 320)])
@pytest.mark.parametrize("k,filt,n_sweep", [(16, None, 0), (100, [1], 20480), (600, [0, 2], 0), (8192, None, 0)])
def test_scan_topk_int8_bit_exact(dev, kernel, nq, k, filt, n_sweep):
    m, scales, src, qi8, qscale = _int8_inputs(dev, 32768, nq, nq + k)
    fn = topk.scan_topk_int8_flat if kernel == "flat" else topk.scan_topk_int8_slab
    counter = "LAUNCHES_INT8" if kernel == "flat" else "LAUNCHES_INT8_SLAB"
    before = getattr(topk, counter)
    vk, rk = fn(m, scales, src, qi8, qscale, _allowed(dev, filt), k, n_sweep)
    vp, rp = topk.scan_topk_int8_plain(m, scales, src, qi8, qscale, _allowed(dev, filt), k, n_sweep)
    torch.cuda.synchronize()
    assert getattr(topk, counter) == before + 1
    assert torch.equal(vk, vp) and torch.equal(rk, rp)


K3_WIDTHS = [1, 2, 8, 9, 16, 17, 64, 65, 255]
K3_DEPTHS = [1, 16, 128, 512, 2048, 8192]


@pytest.mark.parametrize("nq", K3_WIDTHS)
@pytest.mark.parametrize("k", K3_DEPTHS)
@pytest.mark.parametrize("case", ["random", "2src", "dense_ties"])
def test_scan_flat_int8_widths_and_depths_bit_exact(dev, nq, k, case):
    """K3 (csrc/scan_flat_rows.cu) bit for bit with its plain version at
    widths on the CUDA cores and on K4's wgmma pass 1 (both sides of
    FLAT_ROWS_CORE_QUERIES["int8"] and of the 64-query tile), at depths
    through the multi-block pass 2, under no filter and a 2-source filter,
    on rows 8 times over (dense ties: lower row first), over a sweep whose
    last 128-row tile is partial; each sweep one launch, run twice back to
    back on reused workspaces with the same answer."""
    n = 40960
    n_sweep = n - 77
    m, scales, src, qi8, qscale = _int8_inputs(dev, n, nq, nq * 31 + k, dup=case == "dense_ties")
    allowed = _allowed(dev, [0, 2] if case == "2src" else None)
    before = topk.LAUNCHES_INT8
    first = topk.scan_topk_int8_flat(m, scales, src, qi8, qscale, allowed, k, n_sweep)
    second = topk.scan_topk_int8_flat(m, scales, src, qi8, qscale, allowed, k, n_sweep)
    vp, rp = topk.scan_topk_int8_plain(m, scales, src, qi8, qscale, allowed, k, n_sweep)
    torch.cuda.synchronize()
    assert topk.LAUNCHES_INT8 == before + 2
    for vk, rk in (first, second):
        assert torch.equal(vk, vp) and torch.equal(rk, rp)
    if case == "dense_ties" and k > 1:
        same = (vp[:, 1:] == vp[:, :-1]) & torch.isfinite(vp[:, 1:])
        assert bool(same.any()) and bool((rp[:, 1:][same] > rp[:, :-1][same]).all())


def test_scan_flat_int8_deep_wide_sweep_is_one_launch(dev):
    """255 queries at k = 8,192 over 2,064,384 rows: one K3 launch (the
    plan cuts its ranges to the workspace budget), bit for bit."""
    m, scales, src, qi8, qscale = _int8_inputs(dev, 2_064_384, 255, 5)
    before = topk.LAUNCHES_INT8
    vk, rk = topk.scan_topk_int8_flat(m, scales, src, qi8, qscale, _allowed(dev), 8192)
    vp, rp = topk.scan_topk_int8_plain(m, scales, src, qi8, qscale, _allowed(dev), 8192)
    torch.cuda.synchronize()
    assert topk.LAUNCHES_INT8 == before + 1
    assert torch.equal(vk, vp) and torch.equal(rk, rp)


@pytest.mark.parametrize("kernel", ["flat", "slab"])
def test_scan_topk_int8_ties_lower_row_first(dev, kernel):
    nq = 3 if kernel == "flat" else 256
    m, scales, src, qi8, qscale = _int8_inputs(dev, 8192, nq, 9, dup=True)
    fn = topk.scan_topk_int8_flat if kernel == "flat" else topk.scan_topk_int8_slab
    vk, rk = fn(m, scales, src, qi8, qscale, _allowed(dev), 64)
    vp, rp = topk.scan_topk_int8_plain(m, scales, src, qi8, qscale, _allowed(dev), 64)
    assert torch.equal(vk, vp) and torch.equal(rk, rp)
    same = vk[:, 1:] == vk[:, :-1]
    assert bool(same.any()) and bool((rk[:, 1:][same] > rk[:, :-1][same]).all())


@pytest.mark.parametrize("nq,k,filt,n_sweep", [(256, 16, None, 0), (320, 100, [1], 20480), (512, 600, [0, 2], 0)])
def test_scan_topk_slab_matches_plain(dev, nq, k, filt, n_sweep):
    g = torch.Generator(device=dev).manual_seed(nq + k)
    m = torch.randn((32768, 384), generator=g, device=dev)
    m = (m / m.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    src = torch.randint(0, 3, (32768,), generator=g, device=dev, dtype=torch.int32)
    src[torch.rand((32768,), generator=g, device=dev) < 0.2] = -1
    q = torch.randn((nq, 384), generator=g, device=dev)
    before = topk.LAUNCHES_SLAB
    vk, rk = topk.scan_topk(m, src, q, _allowed(dev, filt), k, n_sweep)  # routes to K2
    vp, rp = topk.scan_topk_plain(m, src, q, _allowed(dev, filt), k, n_sweep)
    torch.cuda.synchronize()
    assert topk.LAUNCHES_SLAB == before + 1
    torch.testing.assert_close(vk, vp, atol=1e-4, rtol=0)
    diff = rk != rp
    if diff.any():
        near = (vp[:, 1:] - vp[:, :-1]).abs() <= 2e-4
        near = torch.nn.functional.pad(near, (1, 0)) | torch.nn.functional.pad(near, (0, 1))
        assert bool((~diff | near).all())


def _assert_scan_close(got, want):
    """Scores within 1e-4 of the plain version's; rows equal except where
    the plain score lies within 2e-4 of a neighbour's or within 1e-4 of the
    last matching score (the band chip_smoke.compare_topk allows: f32 sums
    in another order may swap near ties, also across the k-th place)."""
    (vk, rk), (vp, rp) = got, want
    fin = torch.isfinite(vp)
    assert torch.equal(torch.isfinite(vk), fin)
    torch.testing.assert_close(vk, vp, atol=1e-4, rtol=0)
    assert bool((rk[~fin] == -1).all())
    diff = rk != rp
    if diff.any():
        near = (vp[:, 1:] - vp[:, :-1]).abs() <= 2e-4
        near = torch.nn.functional.pad(near, (1, 0)) | torch.nn.functional.pad(near, (0, 1))
        last = (fin.sum(dim=1, keepdim=True) - 1).clamp(min=0)
        near |= (vp - vp.gather(1, last)).abs() <= 1e-4
        assert bool((~diff | near).all()), f"{int((diff & ~near).sum())} rows outside the tie band"


def _bf16_rows(dev, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    m = torch.randn((n, 384), generator=g, device=dev)
    src = torch.randint(0, 3, (n,), generator=g, device=dev, dtype=torch.int32)
    src[torch.rand((n,), generator=g, device=dev) < 0.2] = -1
    return (m / m.norm(dim=1, keepdim=True)).to(torch.bfloat16), src, g


@pytest.mark.parametrize("nq", [256, 384, 2048])
@pytest.mark.parametrize("k", [1, 10, 32, 512, 8192])
def test_scan_slab_bf16_widths_and_depths(dev, nq, k):
    """K2 (csrc/scan_slab_rows.cu) at every sweep width and depth: 384
    queries go through scan_topk, which pads them to a slab multiple."""
    m, src, g = _bf16_rows(dev, 32768, nq + k)
    q = torch.randn((nq, 384), generator=g, device=dev)
    allowed = _allowed(dev, [0, 2] if k == 10 else None)
    before = topk.LAUNCHES_SLAB
    if nq == 384:
        got = topk.scan_topk(m, src, q, allowed, k)
    else:
        got = topk.scan_topk_slab(m, src, q, allowed, k)
    want = topk.scan_topk_plain(m, src, q, allowed, k)
    torch.cuda.synchronize()
    assert topk.LAUNCHES_SLAB > before
    _assert_scan_close(got, want)


@pytest.mark.parametrize("case", ["ascending", "all_equal", "filter_drops_99", "ragged_sweep"])
@pytest.mark.parametrize("k", [10, 32, 512])
def test_scan_slab_bf16_adversarial(dev, case, k):
    """K2's running thresholds on orders that defeat them: scores that
    ascend along the sweep (every tile raises tau), all-equal scores (the
    tie rule: lower rows first), a filter that keeps ~1% of the rows, and a
    sweep that ends inside a row tile."""
    n, nq = 65536, 256
    m, src, g = _bf16_rows(dev, n, 7 + k)
    q = torch.randn((nq, 384), generator=g, device=dev)
    allowed, n_sweep = _allowed(dev), 0
    if case == "ascending":
        u = torch.randn((384,), generator=g, device=dev)
        u = u / u.norm()
        m = (torch.linspace(0.01, 1.0, n, device=dev)[:, None] * u[None, :]).to(torch.bfloat16)
        q = u[None, :] + 0.05 * torch.randn((nq, 384), generator=g, device=dev)
        src = torch.zeros_like(src)
    elif case == "all_equal":
        m = torch.randint(-3, 4, (1, 384), generator=g, device=dev).to(torch.bfloat16).repeat(n, 1).contiguous()
        q = torch.randint(-3, 4, (nq, 384), generator=g, device=dev).float()
    elif case == "filter_drops_99":
        src = torch.where(torch.rand((n,), generator=g, device=dev) < 0.01, 0, 5).to(torch.int32)
        allowed = _allowed(dev, [0])
    else:
        n_sweep = 20_000 + 37
    got = topk.scan_topk_slab(m, src, q, allowed, k, n_sweep)
    want = topk.scan_topk_plain(m, src, q, allowed, k, n_sweep)
    torch.cuda.synchronize()
    _assert_scan_close(got, want)
    if case == "all_equal":
        assert torch.equal(got[1], want[1])
        first_rows = torch.nonzero(src >= 0).flatten()[:k].to(torch.int32)
        assert bool((got[1] == first_rows[None, :]).all())
    if case == "ragged_sweep":
        assert bool((got[1] < n_sweep).all())


@pytest.mark.parametrize("s", [100, 384, 512])
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("masks", ["padded", "one_key", "holes"])
def test_attention_bf16_tensor_cores(dev, s, dh, masks):
    """K11's bf16 path (mma.sync, cp.async ring, masked key tiles skipped)
    against the f32 math on the same bf16 inputs, 1e-2: "padded" rows keep
    a prefix (some under 64 tokens, so whole key tiles are padding),
    "one_key" rows keep one token, "holes" keeps random tokens but none in
    key tiles 0 and 2; in each, batch row 0 keeps no token at all (every
    key tile then counts)."""
    b, nh = 4, 3
    g = torch.Generator(device=dev).manual_seed(s * dh + len(masks))
    q, k, v = ((torch.randn((b, s, nh, dh), generator=g, device=dev) * sd).to(torch.bfloat16) for sd in (1.0, 1.0, 0.5))
    pos = torch.arange(s, device=dev)[None, :]
    if masks == "padded":
        lens = torch.tensor([0, 1, min(s, 40), s], device=dev)[:, None]
        mask = pos < lens
    elif masks == "one_key":
        mask = pos == torch.randint(0, s, (b, 1), generator=g, device=dev)
    else:
        mask = torch.rand((b, s), generator=g, device=dev) < 0.3
        mask &= ~((pos // 64 == 0) | (pos // 64 == 2))
    mask = mask.to(torch.int32)
    mask[0] = 0
    before = attn.LAUNCHES
    got = attn.attention(q, k, v, mask)
    want = attn.attention_plain(q.float(), k.float(), v.float(), mask)
    torch.cuda.synchronize()
    assert attn.LAUNCHES == before + 1
    torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=0)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros((1, 600, 2, 32), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attn.attention(x, x, x, torch.ones((1, 600), dtype=torch.int32, device=dev))
    m = torch.zeros((512, 384), device=dev, dtype=torch.bfloat16)
    src = torch.zeros(512, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        topk.scan_topk(m, src, torch.zeros((1, 384), device=dev), _allowed(dev), 9000)
    with pytest.raises(ValueError):
        topk.scan_topk(m, src.cpu(), torch.zeros((1, 384), device=dev), _allowed(dev), 4)
    with pytest.raises(TypeError):  # no slab kernel for f32
        topk.scan_topk_slab(m.float(), src, torch.zeros((256, 384), device=dev), _allowed(dev), 4)
    with pytest.raises(ValueError):  # slab rows must be a multiple of 128 bytes
        topk.scan_topk_slab(m[:, :32].contiguous(), src, torch.zeros((256, 32), device=dev), _allowed(dev), 4)
    # an empty matrix matches nothing, as in the plain version
    vals, rows = topk.scan_topk(m[:0], src[:0], torch.zeros((2, 384), device=dev), _allowed(dev), 4)
    assert torch.isinf(vals).all() and (rows == -1).all()


def _int2_inputs(dev, n, nq, seed, d=384, dup=False):
    """A packed (d/4, n) coarse matrix of random crumbs with row scales, the
    (d, n) int8 companion, source ids with 20% tombstones, int8 queries."""
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (d // 4, n), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
    fine = torch.randint(-127, 128, (d, n), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
    if dup:  # every column 8 times over: dense exact ties
        packed = packed[:, : n // 8].repeat(1, 8).contiguous()
        fine = fine[:, : n // 8].repeat(1, 8).contiguous()
    s2 = torch.rand((n,), generator=g, device=dev) + 0.5
    s8 = torch.rand((n,), generator=g, device=dev) + 0.5
    if dup:
        s2, s8 = s2[: n // 8].repeat(8), s8[: n // 8].repeat(8)
    src = torch.randint(0, 3, (n,), generator=g, device=dev, dtype=torch.int32)
    src[torch.rand((n,), generator=g, device=dev) < 0.2] = -1
    qi8, qscale = topk.quantize_queries(torch.randn((nq, d), generator=g, device=dev))
    return packed, s2, fine, s8, src, qi8, qscale


@pytest.mark.parametrize("nq,filt,n_sweep", [(1, None, 0), (8, [1], 20480), (13, [0, 2], 32764)])
def test_int2_scores_bit_exact(dev, nq, filt, n_sweep):
    packed, s2, _, _, src, qi8, qscale = _int2_inputs(dev, 32768, nq, nq)
    before = int2.LAUNCHES_SCORES
    got = int2.int2_scores(packed, s2, src, qi8, qscale, _allowed(dev, filt), n_sweep)
    want = int2.int2_scores_plain(packed, s2, src, qi8, qscale, _allowed(dev, filt), n_sweep)
    torch.cuda.synchronize()
    assert int2.LAUNCHES_SCORES == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("nq", [1, 3, 8, 33])
@pytest.mark.parametrize("filt,n_sweep", [(None, 32764), ([0, 2], 20000), ([1], 4099)])
def test_int2_scores_widths_bit_exact(dev, nq, filt, n_sweep):
    """K5 bit for bit at 1, 3, 8 and 33 queries (query tiles of 1, 4, 8 and
    8 + 1) over a prefix of a 32,768-column matrix (ld > n_sweep), whose
    last rows end a thread's rows part way (4,099: the scalar stores), run
    twice back to back with the same answer."""
    packed, s2, _, _, src, qi8, qscale = _int2_inputs(dev, 32768, nq, nq + n_sweep)
    before = int2.LAUNCHES_SCORES
    first = int2.int2_scores(packed, s2, src, qi8, qscale, _allowed(dev, filt), n_sweep)
    second = int2.int2_scores(packed, s2, src, qi8, qscale, _allowed(dev, filt), n_sweep)
    want = int2.int2_scores_plain(packed, s2, src, qi8, qscale, _allowed(dev, filt), n_sweep)
    torch.cuda.synchronize()
    assert int2.LAUNCHES_SCORES == before + 2
    assert first.shape == (nq, n_sweep) and torch.equal(first, want) and torch.equal(second, want)


def test_int2_scores_refuses_unaligned_columns(dev):
    """K5 reads 16 columns of a plane-row at once: a column count that is
    not a multiple of 16 raises instead of launching."""
    packed, s2, _, _, src, qi8, qscale = _int2_inputs(dev, 4100, 1, 3)
    with pytest.raises(ValueError):
        int2.int2_scores(packed, s2, src, qi8, qscale, _allowed(dev))


def _select_rows(dev, case, nq, n, seed):
    """(nq, n) scores for K6's routes: coarse-like (near 0, 5% masked),
    few finite (1,000 a row, the rest -inf: the kc-th key's bin of one value
    overflows the region past 65,536 -inf entries), all masked, 64 values
    all in one bin (a bin of several values that overflows), every score 8
    times over, or -0.0 beside +0.0 below 200 entries of 1.0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((nq, n), generator=g, device=dev) * 0.05
    x[torch.rand((nq, n), generator=g, device=dev) < 0.05] = float("-inf")
    if case == "few_finite":
        keep = torch.rand((nq, n), generator=g, device=dev) < 1000 / n
        x = torch.where(keep, torch.randn((nq, n), generator=g, device=dev), float("-inf"))
    elif case == "all_masked":
        x.fill_(float("-inf"))
    elif case == "one_bin":
        x = 1.0 + (torch.arange(n, device=dev) % 64).float()[None].repeat(nq, 1) * 2.0**-20
    elif case == "dense_ties":
        x = x[:, : max(1, n // 8)].repeat(1, 8)[:, :n].contiguous()
    elif case == "signed_zeros":
        x = torch.where(torch.rand((nq, n), generator=g, device=dev) < 0.5, -0.0, 0.0)
        x[:, torch.randperm(n, generator=g, device=dev)[:200]] = 1.0
    return x.contiguous()


# K6's routes: one round of 16,384 scores or many, K10's buffer (79,360);
# rows misaligned to 16 bytes (n % 4 != 0, Q > 1); kc from 1 to n; the
# region's overflows (one value in the kc-th key's bin, several values,
# the entries above its bin past the region at kc = n); the finish's
# counts past shared memory (more than 4,096 rounds)
SELECT_CASES = [
    ("random", 1, 4096, 1), ("random", 8, 4096, 4096), ("random", 33, 4099, 100),
    ("random", 1, 79360, 4096), ("random", 3, 131072, 16384), ("random", 2, 131073, 4096),
    ("random", 1, 3809280, 4096), ("random", 8, 3809280, 4096), ("random", 1, 3809280, 16384),
    ("random", 1, 3809280, 1), ("random", 33, 1000003, 1024), ("random", 2, 1048576, 1048576),
    ("few_finite", 1, 1048576, 4096), ("few_finite", 8, 100000, 4096), ("all_masked", 8, 1048576, 4096),
    ("all_masked", 1, 79360, 4096), ("one_bin", 1, 1048576, 4096), ("one_bin", 2, 1048576, 16384),
    ("dense_ties", 1, 3809280, 16384), ("dense_ties", 33, 65536, 4096), ("signed_zeros", 2, 300001, 5000),
    ("signed_zeros", 1, 4096, 300),
    ("random", 1, 67_200_000, 4096),  # past 4,096 rounds: the finish's counts in the workspace
]


@pytest.mark.parametrize("case,nq,n,kc", SELECT_CASES + [(c, 3, 65536, kc) for c in
                         ("int2_random", "int2_dense_ties", "int2_all_masked", "int2_kc_is_n", "int2_prefix")
                         for kc in (512, 1024, 4096)])
def test_select_topk_matches_plain(dev, case, nq, n, kc):
    """K6 against its plain version (set, row order, floor) on every route,
    twice back to back with the same answer."""
    if case.startswith("int2_"):  # K5's plain scores of a random int2 matrix
        packed, s2, _, _, src, qi8, qscale = _int2_inputs(dev, n, nq, kc, dup=case == "int2_dense_ties")
        allowed = _allowed(dev, [7] if case == "int2_all_masked" else None)
        scores = int2.int2_scores_plain(packed, s2, src, qi8, qscale, allowed, 40000 if case == "int2_prefix" else 0)
        if case == "int2_kc_is_n":
            scores = scores[:, :kc].contiguous()
    else:
        scores = _select_rows(dev, case, nq, n, kc + nq)
    before = int2.LAUNCHES_SELECT
    first = int2.select_topk(scores, kc)
    second = int2.select_topk(scores, kc)
    vp, rp, fp = int2.select_topk_plain(scores, kc)
    torch.cuda.synchronize()
    assert int2.LAUNCHES_SELECT == before + 2
    for vk, rk, fk in (first, second):
        assert torch.equal(rk, rp) and torch.equal(vk, vp) and torch.equal(fk, fp)
        assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))  # -0.0 stays -0.0
        assert bool((rk[:, 1:] > rk[:, :-1]).all())  # ordered by row
    if case in ("int2_dense_ties", "dense_ties"):
        assert bool((first[0] == first[2][:, None]).sum(dim=1).gt(1).any())


def test_select_topk_workspace_matches_its_plan(dev):
    """K6's workspace: per query, pass 1's histogram and tickets, the state,
    pass 2's histogram, the round table, the finish's counts past 4,096
    rounds and a region of min(n, 65,536) entries
    (tests/test_torch_select.py's plan)."""
    from perceive_tpu_torch.ops import _cuda

    lib = _cuda.library()
    for nq, n in ((1, 4096), (1, 79360), (1, 3809280), (8, 3809280), (33, 1000003), (2, 67_200_000)):
        rounds = ((n + 6) // 4 + 4095) // 4096  # rounds of 16,384 scores
        counts = rounds * 6 if rounds > 4096 else 0  # the finish's per-round counts past shared memory
        want = nq * ((4096 + 4) * 4 + 32 + 2048 * 4 + rounds * 16 + (counts + 3) // 4 * 16 + min(n, 65536) * 8)
        assert lib.perceive_select_topk_workspace(nq, n) == want


# K7's and K9 flat's widths: every CUDA-core tile (1, 2, 8, 16), both sides
# of each decode's crossover (FLAT_COLS_CORE_QUERIES) and of the 64-query
# tensor-core tile, and the widest flat sweep
FLAT_COLS_WIDTHS = [("flat", 1), ("flat", 2), ("flat", 7), ("flat", 8), ("flat", 9), ("flat", 16), ("flat", 17),
                    ("flat", 63), ("flat", 64), ("flat", 255), ("slab", 256), ("slab", 512)]
# depths with both filters: the sorted list (16), the bitwise compaction
# (128, 600), the multi-block pass 2 (600 and past), a sweep that is no
# multiple of 128 rows (20,037)
FLAT_COLS_DEPTHS = [(16, None, 0), (128, [1], 20480), (600, [0, 2], 0), (1024, [1], 20037), (8192, None, 0),
                    (8192, [0, 2], 20037)]


@pytest.mark.parametrize("kernel,nq", FLAT_COLS_WIDTHS)
@pytest.mark.parametrize("k,filt,n_sweep", FLAT_COLS_DEPTHS)
def test_scan_topk_int8t_bit_exact(dev, kernel, nq, k, filt, n_sweep):
    _, _, fine, s8, src, qi8, qscale = _int2_inputs(dev, 32768, nq, nq + k)
    fn = topk.scan_topk_int8t_flat if kernel == "flat" else topk.scan_topk_int8t_slab
    counter = "LAUNCHES_INT8T" if kernel == "flat" else "LAUNCHES_INT8T_SLAB"
    before = getattr(topk, counter)
    vk, rk = fn(fine, s8, src, qi8, qscale, _allowed(dev, filt), k, n_sweep)
    vp, rp = topk.scan_topk_int8t_plain(fine, s8, src, qi8, qscale, _allowed(dev, filt), k, n_sweep)
    torch.cuda.synchronize()
    assert getattr(topk, counter) == before + 1
    assert torch.equal(vk, vp) and torch.equal(rk, rp)


@pytest.mark.parametrize("kernel", ["flat", "slab"])
def test_scan_topk_int8t_ties_lower_row_first(dev, kernel):
    nq = 3 if kernel == "flat" else 256
    _, _, fine, s8, src, qi8, qscale = _int2_inputs(dev, 8192, nq, 9, dup=True)
    fn = topk.scan_topk_int8t_flat if kernel == "flat" else topk.scan_topk_int8t_slab
    vk, rk = fn(fine, s8, src, qi8, qscale, _allowed(dev), 64)
    vp, rp = topk.scan_topk_int8t_plain(fine, s8, src, qi8, qscale, _allowed(dev), 64)
    assert torch.equal(vk, vp) and torch.equal(rk, rp)
    same = vk[:, 1:] == vk[:, :-1]
    assert bool(same.any()) and bool((rk[:, 1:][same] > rk[:, :-1][same]).all())


@pytest.mark.parametrize("nq,k,kc", [(1, 128, 4096), (8, 64, 1024)])
def test_int2_pipeline_matches_plain(dev, nq, k, kc):
    packed, s2, fine, s8, src, _, _ = _int2_inputs(dev, 65536, nq, kc)
    q = torch.randn((nq, 384), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    args = (packed, s2, fine, s8, src, q, _allowed(dev), k)
    got = int2.scan_int2_coarse_fine(*args, k_coarse=kc)
    want = int2.scan_int2_coarse_fine_plain(*args, k_coarse=kc)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _int4_inputs(dev, n, nq, seed, d=384, dup=False):
    """A packed (d/2, n) int4 matrix of random bytes (every nibble value,
    a low nibble of 0 included), row scales, source ids with 20%
    tombstones, int8 queries."""
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (d // 2, n), generator=g, device=dev, dtype=torch.int32).to(torch.uint8)
    scales = torch.rand((n,), generator=g, device=dev) + 0.5
    if dup:  # every column 8 times over: dense exact ties
        packed = packed[:, : n // 8].repeat(1, 8).contiguous()
        scales = scales[: n // 8].repeat(8)
    src = torch.randint(0, 3, (n,), generator=g, device=dev, dtype=torch.int32)
    src[torch.rand((n,), generator=g, device=dev) < 0.2] = -1
    qi8, qscale = topk.quantize_queries(torch.randn((nq, d), generator=g, device=dev))
    return packed, scales, src, qi8, qscale


@pytest.mark.parametrize("kernel,nq", FLAT_COLS_WIDTHS)
@pytest.mark.parametrize("k,filt,n_sweep", FLAT_COLS_DEPTHS)
def test_scan_topk_int4_bit_exact(dev, kernel, nq, k, filt, n_sweep):
    packed, scales, src, qi8, qscale = _int4_inputs(dev, 32768, nq, nq + k)
    assert bool(((packed & 15) == 0).any())
    fn = topk.scan_topk_int4_flat if kernel == "flat" else topk.scan_topk_int4_slab
    counter = "LAUNCHES_INT4" if kernel == "flat" else "LAUNCHES_INT4_SLAB"
    before = getattr(topk, counter)
    vk, rk = fn(packed, scales, src, qi8, qscale, _allowed(dev, filt), k, n_sweep)
    vp, rp = topk.scan_topk_int4_plain(packed, scales, src, qi8, qscale, _allowed(dev, filt), k, n_sweep)
    torch.cuda.synchronize()
    assert getattr(topk, counter) == before + 1
    assert torch.equal(vk, vp) and torch.equal(rk, rp)


@pytest.mark.parametrize("kernel", ["flat", "slab"])
def test_scan_topk_int4_ties_lower_row_first(dev, kernel):
    nq = 3 if kernel == "flat" else 256
    packed, scales, src, qi8, qscale = _int4_inputs(dev, 8192, nq, 9, dup=True)
    fn = topk.scan_topk_int4_flat if kernel == "flat" else topk.scan_topk_int4_slab
    vk, rk = fn(packed, scales, src, qi8, qscale, _allowed(dev), 64)
    vp, rp = topk.scan_topk_int4_plain(packed, scales, src, qi8, qscale, _allowed(dev), 64)
    assert torch.equal(vk, vp) and torch.equal(rk, rp)
    same = vk[:, 1:] == vk[:, :-1]
    assert bool(same.any()) and bool((rk[:, 1:][same] > rk[:, :-1][same]).all())


@pytest.mark.parametrize("kernel", ["flat", "slab"])
@pytest.mark.parametrize("case", ["all_tombstoned", "filter_allows_nothing"])
def test_scan_topk_int4_matches_nothing(dev, kernel, case):
    """Every row masked: both kernels return (-inf, -1) in every slot, as
    the plain version does."""
    nq = 5 if kernel == "flat" else 256
    packed, scales, src, qi8, qscale = _int4_inputs(dev, 8192, nq, 4)
    if case == "all_tombstoned":
        src = torch.full_like(src, -1)
    allowed = _allowed(dev, [7] if case == "filter_allows_nothing" else None)
    fn = topk.scan_topk_int4_flat if kernel == "flat" else topk.scan_topk_int4_slab
    vk, rk = fn(packed, scales, src, qi8, qscale, allowed, 32)
    vp, rp = topk.scan_topk_int4_plain(packed, scales, src, qi8, qscale, allowed, 32)
    assert torch.equal(vk, vp) and torch.equal(rk, rp)
    assert bool(torch.isinf(vk).all()) and bool((rk == -1).all())


def test_scan_topk_int4_routes_and_checks(dev):
    packed, scales, src, _, _ = _int4_inputs(dev, 4096, 1, 5)
    q = torch.randn((300, 384), device=dev)
    before = (topk.LAUNCHES_INT4, topk.LAUNCHES_INT4_SLAB)
    topk.scan_topk_int4(packed, scales, src, q[:8], _allowed(dev), 16)
    topk.scan_topk_int4(packed, scales, src, q, _allowed(dev), 16)  # padded to 384: the slab kernel
    assert (topk.LAUNCHES_INT4, topk.LAUNCHES_INT4_SLAB) == (before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError):  # queries must be twice the packed width
        topk.scan_topk_int4(packed, scales, src, q[:, :192], _allowed(dev), 16)
    with pytest.raises(ValueError):
        topk.scan_topk_int4(packed.to(torch.int8), scales, src, q, _allowed(dev), 16)


@pytest.mark.parametrize("nq,k,kc", [(1, 128, 4096), (8, 64, 1024)])
def test_int2_pipeline_int4_companion_matches_plain(dev, nq, k, kc):
    packed2, s2, _, _, src, _, _ = _int2_inputs(dev, 65536, nq, kc)
    packed4, s4, _, _, _ = _int4_inputs(dev, 65536, 1, kc + 1)
    q = torch.randn((nq, 384), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    args = (packed2, s2, packed4, s4, src, q, _allowed(dev), k)
    got = int2.scan_int2_coarse_fine(*args, k_coarse=kc)
    want = int2.scan_int2_coarse_fine_plain(*args, k_coarse=kc)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nq,n,n_sweep,filt,kc,m_top,case", [
    (1, 98304, 0, None, 2048, 0, "random"),  # 8 tiles of 12,288 rows, M = 512 by the depth rule
    (2, 65536, 49152, [1], 0, 512, "dead_bins"),  # a sweep prefix of 4 x 12,288; lanes emptied by the filter
    (8, 40960, 0, [0, 2], 1024, 0, "random"),  # 5 tiles of 8,192
    (3, 36864, 0, None, 0, 384, "ties"),  # equal scores in a bin
    (512, 16384, 0, None, 0, 128, "random"),  # 4,096-row tiles at Q = 512
    (9, 20480, 0, [0, 1], 0, 256, "dead_bins"),  # 4,096-row tiles; a second query tile of one query
    (1, 10240, 0, None, 0, 384, "ties"),  # 2,048-row tiles: one part of 16 sublanes
    (2, 3072, 0, [2], 0, 128, "random"),  # 1,024-row tiles
    (8, 3584, 0, None, 0, 512, "random"),  # 512-row tiles
    (8, 49152, 24576, [0, 2], 0, 384, "ties"),  # 12,288 at Q = 8: 8 parts of 12 sublanes, a part's last pass of 4
    (1, 4194304, 3809280, None, 4096, 0, "random"),  # the main path's shape: 310 tiles, M = 256
    (8, 4194304, 3809280, [1], 4096, 0, "dead_bins"),
])
def test_int2_tiletop_bit_exact(dev, nq, n, n_sweep, filt, kc, m_top, case):
    """K10 against its plain version, vals and rows bit for bit, at every
    tile size (512 to 12,288 rows), M 128 to 512, 1 to 512 queries, twice
    back to back with the same answer."""
    packed, s2, _, _, src, qi8, qscale = _int2_inputs(dev, n, nq, nq + n, dup=case == "ties")
    if case == "dead_bins":  # lanes 0-4 hold only source 2, which the filter drops
        src[torch.arange(n, device=dev) % 128 < 5] = 2
    allowed = _allowed(dev, filt)
    before = int2.LAUNCHES_TILETOP
    first = int2.int2_tiletop(packed, s2, src, qi8, qscale, allowed, n_sweep, kc=kc, m_top=m_top)
    second = int2.int2_tiletop(packed, s2, src, qi8, qscale, allowed, n_sweep, kc=kc, m_top=m_top)
    vp, rp = int2.int2_tiletop_plain(packed, s2, src, qi8, qscale, allowed, n_sweep, kc=kc, m_top=m_top)
    torch.cuda.synchronize()
    assert int2.LAUNCHES_TILETOP == before + 2
    for vk, rk in (first, second):
        assert torch.equal(vk, vp) and torch.equal(rk, rp)
    if case == "dead_bins":
        assert bool(torch.isneginf(first[0]).any())


def test_int2_tiletop_refuses_unaligned_columns(dev):
    """K10 reads 16 columns of a plane-row at once, as K5 does: a column
    count that is not a multiple of 16 raises instead of launching."""
    packed, s2, _, _, src, qi8, qscale = _int2_inputs(dev, 4100, 1, 3)
    with pytest.raises(ValueError):
        int2.int2_tiletop(packed, s2, src, qi8, qscale, _allowed(dev), 4096, m_top=128)


@pytest.mark.parametrize("select", ["tiletop", "window", "threshold"])
@pytest.mark.parametrize("nq,k,kc", [(1, 128, 512), (8, 64, 256)])
def test_int2_pipeline_selects_match_plain(dev, select, nq, k, kc):
    packed, s2, fine, s8, src, _, _ = _int2_inputs(dev, 98304, nq, kc + 3)
    q = torch.randn((nq, 384), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    args = (packed, s2, fine, s8, src, q, _allowed(dev), k)
    before = int2.launch_counts()
    got = int2.scan_int2_coarse_fine(*args, k_coarse=kc, select=select)
    want = int2.scan_int2_coarse_fine_plain(*args, k_coarse=kc, select=select)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    after = int2.launch_counts()
    ran = {name for name in after if after[name] > before[name]}
    assert ran == ({"int2_tiletop", "select_topk"} if select == "tiletop" else {"int2_scores"})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq", [1, 5, 16, 40, 200])
@pytest.mark.parametrize("k", [1, 32, 600, 8192])
def test_scan_flat_bf16_widths_and_depths(dev, dtype, nq, k):
    """K1 (csrc/scan_flat_bf16.cu) at widths on the CUDA cores (1, 5, 16)
    and on the tensor cores (40, 200 at bf16), every depth, with a source
    filter and a sweep that ends inside a row tile on half the cases."""
    m, src, g = _bf16_rows(dev, 32768, nq + k)
    m = m.to(dtype)
    q = torch.randn((nq, 384), generator=g, device=dev)
    ragged = (nq + k) % 2 == 1
    allowed = _allowed(dev, [0, 2] if ragged else None)
    n_sweep = 20_000 + 37 if ragged else 0
    before = topk.LAUNCHES
    got = topk.scan_topk_flat(m, src, q, allowed, k, n_sweep)
    want = topk.scan_topk_plain(m, src, q, allowed, k, n_sweep)
    torch.cuda.synchronize()
    assert topk.LAUNCHES == before + 1
    _assert_scan_close(got, want)
    if ragged:
        assert bool((got[1] < n_sweep).all())


def _adversarial_bf16(dev, case, n, nq, seed):
    """(matrix, src, q, allowed, n_sweep) for the orders that defeat running
    thresholds: ascending scores, all-equal scores, a filter keeping ~1% of
    the rows, a sweep ending inside a row tile."""
    m, src, g = _bf16_rows(dev, n, seed)
    q = torch.randn((nq, 384), generator=g, device=dev)
    allowed, n_sweep = _allowed(dev), 0
    if case == "ascending":
        u = torch.randn((384,), generator=g, device=dev)
        u = u / u.norm()
        m = (torch.linspace(0.01, 1.0, n, device=dev)[:, None] * u[None, :]).to(torch.bfloat16)
        q = u[None, :] + 0.05 * torch.randn((nq, 384), generator=g, device=dev)
        src = torch.zeros_like(src)
    elif case == "all_equal":
        m = torch.randint(-3, 4, (1, 384), generator=g, device=dev).to(torch.bfloat16).repeat(n, 1).contiguous()
        q = torch.randint(-3, 4, (nq, 384), generator=g, device=dev).float()
    elif case == "filter_drops_99":
        src = torch.where(torch.rand((n,), generator=g, device=dev) < 0.01, 0, 5).to(torch.int32)
        allowed = _allowed(dev, [0])
    else:
        n_sweep = 20_000 + 37
    return m, src, q, allowed, n_sweep


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq", [1, 40])
@pytest.mark.parametrize("case", ["ascending", "all_equal", "filter_drops_99", "ragged_sweep"])
@pytest.mark.parametrize("k", [10, 32, 512])
def test_scan_flat_bf16_adversarial(dev, dtype, nq, case, k):
    """K1's running thresholds on the orders of
    ``test_scan_slab_bf16_adversarial``; all-equal scores must come out as
    the first live rows, lowest first (the tie rule)."""
    m, src, q, allowed, n_sweep = _adversarial_bf16(dev, case, 65536, nq, 11 + k)
    m = m.to(dtype)
    got = topk.scan_topk_flat(m, src, q, allowed, k, n_sweep)
    want = topk.scan_topk_plain(m, src, q, allowed, k, n_sweep)
    torch.cuda.synchronize()
    _assert_scan_close(got, want)
    if case == "all_equal":
        assert torch.equal(got[1], want[1])
        first_rows = torch.nonzero(src >= 0).flatten()[:k].to(torch.int32)
        assert bool((got[1] == first_rows[None, :]).all())
    if case == "ragged_sweep":
        assert bool((got[1] < n_sweep).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq", [4, 64])
def test_scan_flat_bf16_ties_lower_row_first(dev, dtype, nq):
    """Duplicated rows score equal bits in any summation order (small
    integers); K1 returns the plain version's rows, lower row first."""
    g = torch.Generator(device=dev).manual_seed(nq)
    base = torch.randint(-3, 4, (8, 384), generator=g, device=dev).to(dtype)
    m = base.repeat(512, 1).contiguous()
    src = torch.zeros((m.shape[0],), dtype=torch.int32, device=dev)
    src[5::7] = -1
    q = torch.randint(-3, 4, (nq, 384), generator=g, device=dev).float()
    got = topk.scan_topk_flat(m, src, q, _allowed(dev), 64)
    want = topk.scan_topk_plain(m, src, q, _allowed(dev), 64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    vk, rk = got
    same = vk[:, 1:] == vk[:, :-1]
    assert bool(same.any()) and bool((rk[:, 1:][same] > rk[:, :-1][same]).all())


@pytest.mark.parametrize("nq", [256, 512, 2048])
@pytest.mark.parametrize("k,filt,n_sweep", [(1, None, 0), (32, [1], 20037), (256, None, 0), (1024, [0, 2], 0),
                                            (8192, None, 0)])
def test_scan_slab_int4_widths_bit_exact(dev, nq, k, filt, n_sweep):
    """K9's slab kernel (csrc/scan_slab_cols.cu) bit for bit at every
    sweep width and depth: one launch."""
    packed, scales, src, qi8, qscale = _int4_inputs(dev, 32768, nq, nq + k)
    before = topk.LAUNCHES_INT4_SLAB
    vk, rk = topk.scan_topk_int4_slab(packed, scales, src, qi8, qscale, _allowed(dev, filt), k, n_sweep)
    vp, rp = topk.scan_topk_int4_plain(packed, scales, src, qi8, qscale, _allowed(dev, filt), k, n_sweep)
    torch.cuda.synchronize()
    assert topk.LAUNCHES_INT4_SLAB == before + 1
    assert torch.equal(vk, vp) and torch.equal(rk, rp)


@pytest.mark.parametrize("case", ["ascending", "all_equal", "filter_drops_99", "ragged_sweep"])
@pytest.mark.parametrize("k", [10, 32, 512])
def test_scan_slab_int4_adversarial(dev, case, k):
    """K9's slab kernel on the orders that defeat running thresholds, bit
    for bit: one packed column whose row scales ascend along the sweep
    (queries near its decoded values), every column equal (the tie rule:
    the first live rows, lowest first), a filter keeping ~1% of the rows, a
    sweep ending inside a row tile."""
    n, nq = 65536, 256
    packed, scales, src, qi8, qscale = _int4_inputs(dev, n, nq, 13 + k)
    allowed, n_sweep = _allowed(dev), 0
    g = torch.Generator(device=dev).manual_seed(k)
    if case in ("ascending", "all_equal"):
        packed = packed[:, :1].repeat(1, n).contiguous()
        values = topk.unpack_int4(packed[:, :1]).float().T
        qi8, qscale = topk.quantize_queries(values + 0.5 * torch.randn((nq, 384), generator=g, device=dev))
        if case == "ascending":
            scales = torch.linspace(0.5, 1.5, n, device=dev)
            src = torch.zeros_like(src)
        else:
            scales = torch.ones_like(scales)
    elif case == "filter_drops_99":
        src = torch.where(torch.rand((n,), generator=g, device=dev) < 0.01, 0, 5).to(torch.int32)
        allowed = _allowed(dev, [0])
    else:
        n_sweep = 20_000 + 37
    got = topk.scan_topk_int4_slab(packed, scales, src, qi8, qscale, allowed, k, n_sweep)
    want = topk.scan_topk_int4_plain(packed, scales, src, qi8, qscale, allowed, k, n_sweep)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "all_equal":
        first_rows = torch.nonzero(src >= 0).flatten()[:k].to(torch.int32)
        assert bool((got[1] == first_rows[None, :]).all())
    if case == "ragged_sweep":
        assert bool((got[1] < n_sweep).all())


def test_scan_slab_int4_refuses_unaligned_columns(dev):
    """The slab kernel reads the packed matrix by TMA: a column count that
    is not a multiple of 16 raises instead of launching."""
    packed, scales, src, qi8, qscale = _int4_inputs(dev, 4100, 256, 3)
    with pytest.raises(ValueError):
        topk.scan_topk_int4_slab(packed, scales, src, qi8, qscale, _allowed(dev), 16)


def _slab_int8(kernel, m, scales, src, qi8, qscale, allowed, k, n_sweep=0):
    """K4 over the (N, D) int8 rows ``m``, or K8 over their (D, N)
    transpose (the int2 tier's companion layout), beside the plain
    version: (got, want, launches)."""
    if kernel == "K4":
        fn, plain, mat, counter = topk.scan_topk_int8_slab, topk.scan_topk_int8_plain, m, "LAUNCHES_INT8_SLAB"
    else:
        fn, plain, mat, counter = (topk.scan_topk_int8t_slab, topk.scan_topk_int8t_plain, m.T.contiguous(),
                                   "LAUNCHES_INT8T_SLAB")
    before = getattr(topk, counter)
    got = fn(mat, scales, src, qi8, qscale, allowed, k, n_sweep)
    want = plain(mat, scales, src, qi8, qscale, allowed, k, n_sweep)
    torch.cuda.synchronize()
    return got, want, getattr(topk, counter) - before


@pytest.mark.parametrize("kernel", ["K4", "K8"])
@pytest.mark.parametrize("nq", [256, 512, 2048])
@pytest.mark.parametrize("k,filt,n_sweep", [(1, None, 0), (32, [1], 0), (33, None, 0), (256, [0, 2], 0),
                                            (1024, [1], 20037), (8192, None, 0)])
def test_scan_slab_int8_widths_bit_exact(dev, kernel, nq, k, filt, n_sweep):
    """K4 (csrc/scan_slab_rows.cu) and K8 (csrc/scan_slab_cols.cu) bit for
    bit at every sweep width and depth: k = 32 (the largest list sorted in
    registers), 33 (the first bitwise compaction), 8,192 (the largest k), a
    filtered sweep that ends inside a row tile; up to k = 256 a sweep is
    one launch, 2,048 queries included."""
    m, scales, src, qi8, qscale = _int8_inputs(dev, 32768, nq, nq + k)
    (vk, rk), (vp, rp), launches = _slab_int8(kernel, m, scales, src, qi8, qscale, _allowed(dev, filt), k, n_sweep)
    assert torch.equal(vk, vp) and torch.equal(rk, rp)
    if k <= 256:
        assert launches == 1
    if n_sweep:
        assert bool((rk < n_sweep).all())


@pytest.mark.parametrize("kernel", ["K4", "K8"])
@pytest.mark.parametrize("case", ["ascending", "all_equal", "filter_drops_99", "ragged_sweep"])
@pytest.mark.parametrize("k", [10, 32, 512])
def test_scan_slab_int8_adversarial(dev, kernel, case, k):
    """K4 and K8 on the orders that defeat running thresholds, bit for bit:
    one row whose scales ascend along the sweep (queries near it), every
    row equal (the tie rule: the first live rows, lowest first), a filter
    keeping ~1% of the rows, a sweep ending inside a row tile."""
    n, nq = 65536, 256
    m, scales, src, qi8, qscale = _int8_inputs(dev, n, nq, 17 + k)
    allowed, n_sweep = _allowed(dev), 0
    g = torch.Generator(device=dev).manual_seed(k)
    if case in ("ascending", "all_equal"):
        m = m[:1].repeat(n, 1).contiguous()
        qi8, qscale = topk.quantize_queries(m[:1].float() + 20.0 * torch.randn((nq, 384), generator=g, device=dev))
        if case == "ascending":
            scales = torch.linspace(0.5, 1.5, n, device=dev)
            src = torch.zeros_like(src)
        else:
            scales = torch.ones_like(scales)
    elif case == "filter_drops_99":
        src = torch.where(torch.rand((n,), generator=g, device=dev) < 0.01, 0, 5).to(torch.int32)
        allowed = _allowed(dev, [0])
    else:
        n_sweep = 20_000 + 37
    got, want, _ = _slab_int8(kernel, m, scales, src, qi8, qscale, allowed, k, n_sweep)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "all_equal":
        first_rows = torch.nonzero(src >= 0).flatten()[:k].to(torch.int32)
        assert bool((got[1] == first_rows[None, :]).all())
    if case == "ragged_sweep":
        assert bool((got[1] < n_sweep).all())


def test_scan_slab_int8t_refuses_unaligned_columns(dev):
    """K8 reads the companion by TMA: a column count that is not a
    multiple of 16 raises instead of launching."""
    _, _, fine, s8, src, qi8, qscale = _int2_inputs(dev, 4100, 256, 3)
    with pytest.raises(ValueError):
        topk.scan_topk_int8t_slab(fine, s8, src, qi8, qscale, _allowed(dev), 16)


def _flat_cols(kernel, m8, scales, src, qi8, qscale, allowed, k, n_sweep=0):
    """K7 over the (D, N) int8 columns ``m8``, or K9 flat over their packed
    int4 form (``m8`` then holds nibble values), beside the plain version:
    (got, want, launches)."""
    if kernel == "K7":
        fn, plain, mat, counter = topk.scan_topk_int8t_flat, topk.scan_topk_int8t_plain, m8, "LAUNCHES_INT8T"
    else:
        d2 = m8.shape[0] // 2
        lo, hi = m8[:d2].to(torch.int32), m8[d2:].to(torch.int32)
        mat = ((lo + 8) | ((hi & 15) << 4)).to(torch.uint8).contiguous()
        fn, plain, counter = topk.scan_topk_int4_flat, topk.scan_topk_int4_plain, "LAUNCHES_INT4"
    before = getattr(topk, counter)
    got = fn(mat, scales, src, qi8, qscale, allowed, k, n_sweep)
    want = plain(mat, scales, src, qi8, qscale, allowed, k, n_sweep)
    torch.cuda.synchronize()
    return got, want, getattr(topk, counter) - before


@pytest.mark.parametrize("kernel", ["K7", "K9"])
@pytest.mark.parametrize("nq", [1, 40])
@pytest.mark.parametrize("case", ["ascending", "all_equal", "filter_drops_99", "all_masked", "last_row_only",
                                  "dense_ties"])
@pytest.mark.parametrize("k", [10, 512, 8192])
def test_scan_flat_cols_adversarial(dev, kernel, nq, case, k):
    """K7 and K9 flat (csrc/scan_flat_cols.cu) on the orders that defeat
    running thresholds, bit for bit, on the CUDA cores (Q = 1) and the
    tensor cores (Q = 40): one column whose row scales ascend along the
    sweep (queries near it), every column equal (the tie rule: the first
    live rows, lowest first), a filter keeping ~1% of the rows, every row
    masked ((-inf, -1) everywhere), one live row at the sweep's end (a
    ragged last tile), every column 8 times over (dense ties; at k = 8,192
    through the multi-block pass 2)."""
    n = 65536
    g = torch.Generator(device=dev).manual_seed(k + nq)
    lo, hi = (-8, 8) if kernel == "K9" else (-127, 128)
    m8 = torch.randint(lo, hi, (384, n), generator=g, device=dev, dtype=torch.int32).to(torch.int8)
    scales = torch.rand((n,), generator=g, device=dev) + 0.5
    src = torch.randint(0, 3, (n,), generator=g, device=dev, dtype=torch.int32)
    src[torch.rand((n,), generator=g, device=dev) < 0.2] = -1
    qi8, qscale = topk.quantize_queries(torch.randn((nq, 384), generator=g, device=dev))
    allowed, n_sweep = _allowed(dev), 0
    if case in ("ascending", "all_equal"):
        m8 = m8[:, :1].repeat(1, n).contiguous()
        qi8, qscale = topk.quantize_queries(m8[:, :1].float().T + 0.5 * torch.randn((nq, 384), generator=g, device=dev))
        if case == "ascending":
            scales = torch.linspace(0.5, 1.5, n, device=dev)
            src = torch.zeros_like(src)
        else:
            scales = torch.ones_like(scales)
    elif case == "filter_drops_99":
        src = torch.where(torch.rand((n,), generator=g, device=dev) < 0.01, 0, 5).to(torch.int32)
        allowed = _allowed(dev, [0])
    elif case == "all_masked":
        src = torch.full_like(src, -1)
    elif case == "last_row_only":
        n_sweep = 50_001
        src = torch.full_like(src, -1)
        src[n_sweep - 1] = 1
    else:
        m8 = m8[:, : n // 8].repeat(1, 8).contiguous()
        scales = scales[: n // 8].repeat(8)
    (vk, rk), (vp, rp), launches = _flat_cols(kernel, m8, scales, src, qi8, qscale, allowed, k, n_sweep)
    assert torch.equal(vk, vp) and torch.equal(rk, rp) and launches == 1
    if case == "all_equal":
        first_rows = torch.nonzero(src >= 0).flatten()[:k].to(torch.int32)
        assert bool((rk == first_rows[None, :]).all())
    if case == "all_masked":
        assert bool(torch.isinf(vk).all()) and bool((rk == -1).all())
    if case == "last_row_only":
        assert bool((rk[:, 0] == n_sweep - 1).all()) and bool((rk[:, 1:] == -1).all())
    if case == "dense_ties":
        same = (vk[:, 1:] == vk[:, :-1]) & torch.isfinite(vk[:, 1:])
        assert bool(same.any()) and bool((rk[:, 1:][same] > rk[:, :-1][same]).all())
        if k == 8192:
            assert topk.flat_cols_plan(nq, 384, n, k, topk._sm_count(dev), kernel == "K9")[1][4] == 1


def test_scan_flat_cols_keys_select_workspace_matches_the_kernel(dev):
    """The multi-block select's scratch as the wrapper sizes it
    (``keys_select_bytes``) and as the kernel lays it out."""
    from perceive_tpu_torch.ops import _cuda

    lib = _cuda.library()
    for nq, k in ((1, 1), (3, 100), (16, 8192), (255, 1024)):
        assert lib.perceive_keys_select_workspace(nq, k) == topk.keys_select_bytes(nq, k)


@pytest.mark.parametrize("kernel", ["K7", "K9"])
def test_scan_flat_cols_refuses_unaligned_columns(dev, kernel):
    """K7 and K9 flat read the matrix by TMA: a column count that is not a
    multiple of 16 raises instead of launching, at every width."""
    packed, s2, fine, s8, src, qi8, qscale = _int2_inputs(dev, 4100, 1, 3)
    if kernel == "K7":
        fn, mat, sc = topk.scan_topk_int8t_flat, fine, s8
    else:
        fn, mat, sc = topk.scan_topk_int4_flat, fine[:192].view(torch.uint8).contiguous(), s8
    for nq in (1, 40):
        qi8, qscale = topk.quantize_queries(torch.randn((nq, 384), device=dev))
        with pytest.raises(ValueError):
            fn(mat, sc, src, qi8, qscale, _allowed(dev), 16)


def test_doctor_device_checks_pass(dev):
    from perceive_tpu_torch.cli import doctor as doc

    rep = doc._Report()
    doc._check_device(rep, dev)
    doc._check_kernel_cache(rep)
    status = {name: st for st, name, _ in rep.rows}
    assert status["device"] == status["kernel build+launch"] == status["kernel cache"] == doc.OK, rep.rows


def test_served_search_equals_plain_scan(dev, tmp_path, monkeypatch):
    import contextlib
    import io
    import json
    import urllib.request

    import numpy as np

    from perceive_tpu_torch.cli import AppState, main
    from perceive_tpu_torch.index.searcher import _k_bucket
    from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, TextTokenizer
    from perceive_tpu_torch.models.tokenize import tiny_test_vocab
    from perceive_tpu_torch.serve import start_server

    monkeypatch.setenv("PERCEIVE_TPU_WARM_BATCH_SHAPES", "0")
    monkeypatch.setenv("PERCEIVE_TPU_WARM_HIGHLIGHTS", "0")
    monkeypatch.setenv("PERCEIVE_TPU_DATA_DIR", str(tmp_path / "data"))
    words = "alpha beta gamma delta music river".split()
    vocab = tiny_test_vocab(words)
    arch = EncoderArch(vocab_size=len(vocab), hidden_size=64, num_layers=1, num_heads=4,
                       intermediate_size=128, max_position_embeddings=64)
    model = Model.random(arch, HeadConfig(pooling="mean", normalize=True),
                         TextTokenizer.from_vocab(vocab, max_seq_length=64), seed=1, device=dev)
    model.model_id = 0
    state = AppState(str(tmp_path / "db.sqlite3"), model=model, highlights_model=model, device=dev)
    rng = np.random.default_rng(2)
    docs = tmp_path / "docs"
    docs.mkdir()
    for i in range(300):
        (docs / f"d{i}.txt").write_text(" ".join(rng.choice(words, size=int(rng.integers(3, 40)))))
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["source", "add", "fs", str(docs), "--name", "docs"], state=state) == 0
        assert main(["source", "scan", "docs"], state=state) == 0
    srv = start_server(lambda: state, port=0)
    try:
        assert srv.perceive_state.ready.wait(300) and srv.perceive_state.error is None
        launches = topk.LAUNCHES
        url = f"http://127.0.0.1:{srv.server_address[1]}/search?q=music%20river%20gamma&k=10"
        with urllib.request.urlopen(url) as r:
            got = [(h["id"], h["score"]) for h in json.loads(r.read())]
        assert topk.LAUNCHES > launches
        s, m = state.searcher, state.searcher.matrix
        vectors, src, _ = m.device_view()
        kb = _k_bucket(s._first_fetch(10), m.sweep_rows)
        allowed = torch.from_numpy(s._allowed_arrays(None)[0]).to(dev)
        ids = torch.from_numpy(model.tokenizer.encode_batch_ids(["music river gamma"], pad_batch_to=1)).to(dev)
        q = torch.nn.functional.pad(model.encode_ids(ids).float(), (0, m.padded_dim - m.dim))
        vals, rows = topk.scan_topk_plain(vectors, src, q, allowed, kb, m.sweep_rows)
        want = s._decode_hits(vals[0].cpu().numpy(), rows[0].cpu().numpy(), 10)
        assert got and [i for i, _ in got] == [i for i, _ in want]
        assert max(abs(a[1] - b[1]) for a, b in zip(got, want)) <= 1e-4
    finally:
        srv.perceive_state.stop()
        srv.shutdown()
        srv.server_close()
        state.close()


@pytest.mark.parametrize("tier", ["bf16", "f32", "int8", "int4", "int2+int8", "int2+int4"])
def test_sharded_searcher_on_four_slots_equals_one_device(dev, tier, monkeypatch):
    """A ShardedSearcher over [cuda:0] * 4 (each shard's own tensors, the
    tier's kernels on each, the merge on the lead slot) answers as the
    one-device Searcher on the card: single queries (the coarse route at
    int2, filtered too), a batch of 256 (the slab kernels), upserts and
    removals; every query sweeps 4 shards."""
    import numpy as np

    from perceive_tpu_torch.index.matrix import INT2, INT4
    from perceive_tpu_torch.index.searcher import Searcher
    from perceive_tpu_torch.parallel import ShardedSearcher, make_mesh

    dtype, fine = {"bf16": (torch.bfloat16, None), "f32": (torch.float32, None), "int8": (torch.int8, None),
                   "int4": (INT4, None), "int2+int8": (INT2, "int8"), "int2+int4": (INT2, "int4")}[tier]
    if fine:
        monkeypatch.setenv("PERCEIVE_TPU_INT2_FINE", fine)
    monkeypatch.setenv("PERCEIVE_TPU_COARSE_AUDIT", "0")  # trust the coarse pass: K5/K6 serve
    rng = np.random.default_rng(1)
    n, d = 60_000, 384
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ids, srcs = list(range(1, n + 1)), [i % 3 for i in range(n)]
    ss = ShardedSearcher(0, 0, d, make_mesh(devices=[dev] * 4), dtype=dtype)
    s1 = Searcher(0, 0, d, device=dev, dtype=dtype)
    for s in (ss, s1):
        s.upsert_embeddings(ids, srcs, vecs)
    tol = 1e-4 if tier in ("bf16", "f32") else 1e-6
    qs = vecs[rng.integers(0, n, 256)] + 0.05 * rng.standard_normal((256, d)).astype(np.float32)

    def same(got, want):
        assert [i for i, _ in got] == [i for i, _ in want]
        assert max((abs(a[1] - b[1]) for a, b in zip(got, want)), default=0.0) <= tol

    before = {**topk.launch_counts(), **int2.launch_counts()}
    got = [ss.search_vector(q, 10, f) for q in qs[:4] for f in (None, [1])]
    after = {**topk.launch_counts(), **int2.launch_counts()}
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved and all(v % 4 == 0 for v in moved.values()), moved
    for g, w in zip(got, [s1.search_vector(q, 10, f) for q in qs[:4] for f in (None, [1])]):
        same(g, w)
    for g, w in zip(ss.search_vectors_batch(qs, 10), s1.search_vectors_batch(qs, 10)):
        same(g, w)
    for s in (ss, s1):
        s.remove_items([i for i, _ in s.search_vector(qs[0], 3)])
        s.upsert_embeddings([n + 1], [2], qs[1:2])
    same(ss.search_vector(qs[0], 10), s1.search_vector(qs[0], 10))
