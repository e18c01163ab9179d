"""The port's encoder against the JAX package's ``encode_tokens``.

The JAX ``init_params`` tree reaches the port through ``params_from_jax``;
the token arrays come from one seeded numpy generator.  Tolerances: f32 to
1e-5 (same math, sums in another order); bf16 to cosine >= 0.999 (the two
frameworks round bf16 at different places).  The golden sentence-
transformers fixture must reproduce its committed vectors within the
tolerance tests/test_golden_fixture.py holds the JAX package to.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceive_tpu.models.encoder import EncoderArch as JaxArch
from perceive_tpu.models.encoder import HeadConfig as JaxHead
from perceive_tpu.models.encoder import encode_tokens as jax_encode
from perceive_tpu.models.encoder import init_params as jax_init
from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, encode_tokens
from perceive_tpu_torch.models.convert import params_from_jax
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

FIXTURES = Path(__file__).resolve().parent / "fixtures"

ARCHS = {
    "bert": dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, max_position_embeddings=64),
    "roberta": dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
                    intermediate_size=128, max_position_embeddings=70, pad_token_id=1,
                    roberta_positions=True),
    "albert": dict(vocab_size=96, hidden_size=64, num_layers=3, num_heads=4,
                   intermediate_size=128, max_position_embeddings=64, shared_layers=True,
                   embedding_size=32, hidden_act="gelu_new"),
    "distilbert_relu": dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
                            intermediate_size=128, max_position_embeddings=64,
                            type_vocab_size=0, hidden_act="relu"),
}
HEADS = {
    "mean": dict(pooling="mean"),
    "cls_norm": dict(pooling="cls", normalize=True),
    "max_dense": dict(pooling="max", dense_dim=48, dense_activation="tanh", normalize=True),
    "mean_dense_id": dict(pooling="mean", dense_dim=24, dense_activation="identity"),
}


def _tokens(seed, b=4, s=32, vocab=96):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (b, s)).astype(np.int32)
    lens = np.array([s, 20, 7, 1])[:b]
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    types = (rng.random((b, s)) < 0.3).astype(np.int32) * mask
    return ids, mask, types


def _both(arch_kw, head_kw, compute, seed=0):
    arch, head = JaxArch(**arch_kw), JaxHead(**head_kw)
    params = jax_init(jax.random.PRNGKey(seed), arch, head)
    ids, mask, types = _tokens(seed)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    want = jax_encode(params, arch, head, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types),
                      compute_dtype=jdt, attention_impl="xla")
    got = encode_tokens(
        params_from_jax(jax.tree.map(np.asarray, params)), EncoderArch(**arch_kw), HeadConfig(**head_kw),
        torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(types),
        compute_dtype=getattr(torch, compute),
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("head", list(HEADS))
def test_bert_heads_f32(head):
    got, want = _both(ARCHS["bert"], HEADS[head], "float32")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ["roberta", "albert", "distilbert_relu"])
def test_arch_flags_f32(arch):
    got, want = _both(ARCHS[arch], HEADS["cls_norm"], "float32", seed=1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("head", ["mean", "cls_norm"])
def test_bert_bf16_cosine(head):
    got, want = _both(ARCHS["bert"], HEADS[head], "bfloat16", seed=2)
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.999, cos


def test_unknown_activation_raises():
    arch = dict(ARCHS["bert"], hidden_act="mish")
    with pytest.raises(ValueError, match="mish"):
        _both(arch, HEADS["mean"], "float32")


def test_golden_checkpoint_reproduces_committed_vectors():
    z = np.load(FIXTURES / "golden_vectors.npz")
    model = Model.new_pretrained(
        str(FIXTURES / "golden_st_checkpoint"), device="cpu", compute_dtype=torch.float32
    )
    assert model.dim == 32
    sentences = [str(s) for s in z["sentences"]]
    tb = model.tokenizer.encode_batch(sentences)
    np.testing.assert_array_equal(tb.input_ids, z["input_ids"])
    np.testing.assert_array_equal(tb.attention_mask, z["attention_mask"])
    got = model.encode(sentences)
    want = z["embeddings"]
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.999, cos
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_random_model_is_seeded():
    from perceive_tpu_torch.models import TextTokenizer, tiny_test_vocab

    vocab = tiny_test_vocab(["alpha", "beta"])
    arch = EncoderArch(vocab_size=len(vocab), hidden_size=32, num_layers=1, num_heads=4,
                       intermediate_size=64, max_position_embeddings=32)
    tok = TextTokenizer.from_vocab(vocab, max_seq_length=32)
    a, b, c = (Model.random(arch, HeadConfig(normalize=True), tok, seed=s, device="cpu") for s in (3, 3, 4))
    ea, eb, ec = (m.encode(["alpha beta", "beta"]) for m in (a, b, c))
    np.testing.assert_array_equal(ea, eb)
    assert not np.allclose(ea, ec)
    # the ids-only dispatch path derives the mask as ids != pad
    out = a.materialize(a.encode_dispatch(["alpha beta", "beta"]))
    np.testing.assert_allclose(out, ea, atol=1e-6, rtol=0)
