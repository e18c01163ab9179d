"""The port's similarity helpers (ops/similarity.py) against the JAX
package's, on the CPU: the same seeded inputs, results within 1e-5 in f32
(f32 sums in another order) and 4e-3 in bf16 (2**-8: XLA's CPU fusion may
divide by the norm inside the dot without rounding the normalized operand
to bf16, the port rounds it, as an unfused JAX program does)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.ops import similarity as jax_sim
from perceive_tpu_torch.ops import similarity as sim
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

TOL = {"f32": 1e-5, "bf16": 4e-3}


def _inputs(dtype, zero_row=False):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 48)).astype(np.float32)
    v = rng.standard_normal((20, 48)).astype(np.float32)
    if zero_row:
        v[5] = 0.0  # the norm clamp: a zero row scores 0, not nan
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    return (jnp.asarray(q, jd), jnp.asarray(v, jd)), (torch.from_numpy(q).to(td), torch.from_numpy(v).to(td))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("zero_row", [False, True])
def test_similarity_matches_jax(dtype, zero_row):
    (jq, jv), (tq, tv) = _inputs(dtype, zero_row)
    pairs = [
        (sim.dot_product(tq[0], tv), jax_sim.dot_product(jq[0], jv)),
        (sim.dot_product(tq[:1], tv), jax_sim.dot_product(jq[:1], jv)),
        (sim.cosine_similarity_single_query(tq[1], tv), jax_sim.cosine_similarity_single_query(jq[1], jv)),
        (sim.cosine_similarity_multi_query(tq, tv), jax_sim.cosine_similarity_multi_query(jq, jv)),
    ]
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=TOL[dtype], rtol=0)
