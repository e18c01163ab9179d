"""The port's attention against the JAX package's.

* ``attention_plain`` (the CUDA kernel's math) against the Pallas kernel
  ``fused_attention`` in interpret mode;
* ``xla_attention_plain`` (short buckets) against the encoder's
  ``_xla_attention``;
* the routing decision, with no launch.

Same seeded numpy inputs to both, f32, with pad masks; tolerance 1e-5
(f32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.models.encoder import _xla_attention
from perceive_tpu.ops.attention import fused_attention
from perceive_tpu_torch.ops import attention as attn
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

TOL = 1e-5


def _inputs(b, s, nh, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, nh, dh)).astype(np.float32) for _ in range(3))
    lens = rng.integers(1, s + 1, b)
    lens[0] = s  # one unpadded row
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return q, k, v, mask


SHAPES = [(2, s, 4, dh) for s in (64, 128) for dh in (16, 32)]


@pytest.mark.parametrize("b,s,nh,dh", SHAPES)
def test_kernel_math_matches_pallas(b, s, nh, dh):
    q, k, v, mask = _inputs(b, s, nh, dh, seed=s + dh)
    want = fused_attention(*(jnp.asarray(x) for x in (q, k, v, mask)), interpret=True)
    got = attn.attention(*(torch.from_numpy(x) for x in (q, k, v, mask)))  # CPU: plain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("b,s,nh,dh", SHAPES)
def test_short_bucket_plain_matches_xla(b, s, nh, dh):
    q, k, v, mask = _inputs(b, s, nh, dh, seed=3 * s + dh)
    bias = (1.0 - jnp.asarray(mask)[:, None, None, :].astype(jnp.float32)) * -1e9
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias)
    got = attn.xla_attention_plain(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_bf16_rounds_p_before_pv():
    """The kernel math casts p to v's dtype before p @ v (as the TPU kernel
    does); the short-bucket math normalizes first.  In bf16 the two differ,
    each staying close to the f32 result."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(2, 64, 4, 32, seed=9))
    ref = attn.attention_plain(q, k, v, mask)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    kern = attn.attention_plain(qb, kb, vb, mask)
    short = attn.xla_attention_plain(qb, kb, vb, mask)
    assert kern.dtype == short.dtype == torch.bfloat16
    assert not torch.equal(kern, short)
    for out in (kern, short):
        assert (out.float() - ref).abs().max() < 5e-2


@pytest.mark.parametrize(
    "device,seq,want",
    [("cuda", 384, "kernel"), ("cuda", 512, "kernel"), ("cuda", 256, "plain"),
     ("cuda", 16, "plain"), ("cpu", 512, "plain"), ("cpu", 64, "plain")],
)
def test_route(device, seq, want):
    assert attn.route(device, seq) == want


def test_route_rejects_unknown_impl():
    assert attn.route("cpu", 16, "kernel") == "kernel"
    with pytest.raises(ValueError):
        attn.route("cuda", 512, "pallas")


def test_attention_shape_checks():
    x = torch.zeros(2, 8, 2, 4)
    with pytest.raises(ValueError):
        attn.attention(x, x, x, torch.ones(2, 4, dtype=torch.int32))


@pytest.mark.parametrize("s", [100, 256, 512])
def test_dead_key_tiles_add_nothing(s):
    """The CUDA kernel skips 64-key tiles whose mask is all 0 when the row
    keeps a key: exp(-1e9 + s - m) is 0.0 in f32, so attention_plain over
    the live tiles' keys alone equals the full call to 1e-6 (f32).  A row
    that keeps no key keeps every tile."""
    b, nh, dh = 4, 3, 32
    q, k, v, _ = _inputs(b, s, nh, dh, seed=s + 5)
    rng = np.random.default_rng(s)
    mask = (rng.random((b, s)) < 0.4).astype(np.int32)
    tiles = (s + 63) // 64
    for row in range(1, b):  # rows 1..3 lose whole tiles; row 0 keeps nothing
        dead = rng.choice(tiles, size=max(1, tiles // 2), replace=False)
        for tile in dead:
            mask[row, tile * 64 : (tile + 1) * 64] = 0
        kept = [j for j in range(s) if j // 64 not in dead]
        mask[row, rng.choice(kept)] = 1  # at least one kept key, in a live tile
    mask[0] = 0
    q, k, v, m = (torch.from_numpy(x) for x in (q, k, v, mask))
    full = attn.attention_plain(q, k, v, m)
    for row in range(b):
        live = [t for t in range(tiles) if m[row, t * 64 : (t + 1) * 64].any()] or list(range(tiles))
        keys = torch.cat([torch.arange(t * 64, min(s, (t + 1) * 64)) for t in live])
        part = attn.attention_plain(q[row : row + 1], k[row : row + 1, keys], v[row : row + 1, keys], m[row : row + 1, keys])
        np.testing.assert_allclose(part.numpy(), full[row : row + 1].numpy(), atol=1e-6, rtol=0)
        if row:
            assert len(live) < tiles
