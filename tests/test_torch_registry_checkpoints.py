"""The registry's checkpoint architectures in the port against the JAX
package, and AppState's default models in both.

Each case writes a small sentence-transformers directory through
``chip_smoke.write_checkpoint`` (the writer the smoke uses at full width:
seeded weights under HF's BERT or DistilBERT key names, the pooling mode, an
optional Dense head, an optional Normalize, a WordPiece vocab.txt with its
do_lower_case) and loads it through both packages.  Tolerances:
  * the converter: the same EncoderArch, HeadConfig and max_seq_length, and
    params equal bit for bit (both read the same f32 tensors; the JAX tree
    carried across by ``params_from_jax`` equals the port's own load);
  * the tokenizer: token ids equal;
  * embeddings at f32: rtol 1e-4, atol 1e-5 (the golden checkpoint test
    holds rtol 2e-3 / atol 2e-4; the two packages sum in other orders);
  * AppState's defaults: the same (item, score) hits for ``search --like``
    (stored vectors: the same bf16 matrix, scores within 1e-4 of |q| |r|
    summed in another order) and the same ids for a text query.
"""

import io
import json
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from perceive_tpu.cli import AppState as JaxAppState
from perceive_tpu.cli import main as jax_main
from perceive_tpu.models import Model as JaxModel
from perceive_tpu.models import convert as jax_convert
from perceive_tpu.models.registry import ModelType as JaxType
from perceive_tpu_torch.cli import AppState, main
from perceive_tpu_torch.models import Model, ModelType, convert
from perceive_tpu_torch.models.convert import params_from_jax
from perceive_tpu_torch.models.tokenize import tiny_test_vocab
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

WORDS = "the a and search semantic music pizza river mountain notes kernel query".split()
TEXTS = ["music river notes", "Search the SEMANTIC kernel", "pizza mountain " * 30,
         "Café naïve Über façade 日本語 東京 and the river", "", "the"]


def _smoke():
    """chip_smoke.py, whose checkpoint writer and vocabularies run here."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


def _bert(hidden, layers, vocab_size, heads=4):
    return {"model_type": "bert", "architectures": ["BertModel"], "vocab_size": vocab_size, "hidden_size": hidden,
            "num_hidden_layers": layers, "num_attention_heads": heads, "intermediate_size": 2 * hidden,
            "hidden_act": "gelu", "max_position_embeddings": 128, "type_vocab_size": 2, "pad_token_id": 0,
            "layer_norm_eps": 1e-12}


def _distilbert(hidden, layers, vocab_size, heads=4):
    return {"model_type": "distilbert", "architectures": ["DistilBertModel"], "vocab_size": vocab_size,
            "dim": hidden, "n_layers": layers, "n_heads": heads, "hidden_dim": 2 * hidden, "activation": "gelu",
            "max_position_embeddings": 128, "sinusoidal_pos_embds": False, "pad_token_id": 0}


UNCASED = list(tiny_test_vocab(WORDS))
# the registry's published shapes cut to a few layers and a narrow width:
# (model type, config, head keywords, vocab, do_lower_case)
CASES = {
    "bert mean, no Normalize (msmarco-bert-base-dot-v5)": (
        "MsMarcoBertBaseDotV5", _bert(64, 3, len(UNCASED)), {"normalize": False}, UNCASED, True),
    "distilbert mean (msmarco-distilbert-dot-v5)": (
        "MsMarcoDistilbertDotV5", _distilbert(48, 2, len(UNCASED)), {"normalize": False}, UNCASED, True),
    "distilbert cls (msmarco-distilbert-base-tas-b)": (
        "MsMarcoDistilbertBaseTasB", _distilbert(64, 2, len(UNCASED)), {"pooling": "cls", "normalize": False},
        UNCASED, True),
    "distilbert + dense tanh, cased (distiluse-base-multilingual-cased)": (
        "DistiluseBaseMultilingualCased", _distilbert(32, 2, 119547, heads=2), {"dense": 24, "normalize": False},
        None, False),
    "bert 12 layers mean + Normalize (all-MiniLM-L12-v2 shape)": (
        "AllMiniLmL12V2", _bert(32, 12, len(UNCASED)), {"normalize": True}, UNCASED, True),
}


def _write(d, case):
    _, cfg, head, vocab, lower = CASES[case]
    vocab = vocab or SMOKE.cased_vocab(cfg["vocab_size"])
    SMOKE.write_checkpoint(str(d), cfg, vocab, 96, seed=7, lower=lower, **head)
    return vocab


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_loads_and_embeds_as_the_jax_package(tmp_path, monkeypatch, case):
    """The checkpoint under its registry name: the converters agree, and
    ``Model.new_pretrained(<registry type>)`` embeds alike in both."""
    name, cfg, head, _, lower = CASES[case]
    path = tmp_path / ModelType.parse(name).checkpoint_dir_name
    vocab = _write(path, case)
    jp, jarch, jhead, jmax = jax_convert.load_sentence_transformer(path)
    pp, parch, phead, pmax = convert.load_sentence_transformer(path)
    for field in parch.__dataclass_fields__:
        assert getattr(parch, field) == getattr(jarch, field), field
    for field in phead.__dataclass_fields__:
        assert getattr(phead, field) == getattr(jhead, field), field
    assert pmax == jmax == 96
    assert phead.pooling == head.get("pooling", "mean") and phead.normalize == head["normalize"]
    assert phead.dense_dim == head.get("dense", 0) and (not phead.dense_dim or phead.dense_activation == "tanh")
    carried = params_from_jax(jax.tree.map(np.asarray, jp))
    assert carried.keys() == pp.keys() and ("dense" in pp) == bool(head.get("dense"))
    for group in pp:
        assert carried[group].keys() == pp[group].keys(), group
        for key in pp[group]:
            assert torch.equal(carried[group][key], pp[group][key]), (group, key)

    monkeypatch.setenv("PERCEIVE_TPU_MODEL_DATA", str(tmp_path))
    jm = JaxModel.new_pretrained(JaxType.parse(name), compute_dtype=np.float32, attention_impl="xla")
    pm = Model.new_pretrained(ModelType.parse(name), device="cpu", compute_dtype=torch.float32)
    assert (pm.name, pm.model_id) == (jm.name, jm.model_id) == (name, ModelType.parse(name).model_id)
    texts = TEXTS + SMOKE.family_docs(np.random.default_rng(3), vocab, n_docs=3, n_long=1)
    if not lower:  # cased words, accents and CJK ideographs stay as written
        cased = [w for w in vocab if w[:1].isupper() or "á" in w][:40]
        texts.append(" ".join(cased) + " 丁七 " + "".join(vocab[1000:1006]))
        ids = pm.tokenizer.encode_batch_ids([cased[0]], pad_batch_to=1)[0]
        assert vocab[ids[1]] == cased[0]
    np.testing.assert_array_equal(pm.tokenizer.encode_batch(texts).input_ids,
                                  jm.tokenizer.encode_batch(texts).input_ids)
    got, want = pm.encode(texts), jm.encode(texts)
    assert got.shape == want.shape == (len(texts), head.get("dense") or cfg.get("hidden_size", cfg.get("dim")))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    norms = np.linalg.norm(got, axis=1)
    assert np.allclose(norms, 1.0, atol=1e-4) == head["normalize"]


def _search(entry, state, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        assert entry(argv, state=state) == 0
    return json.loads(out.getvalue())


def test_appstate_defaults_load_and_search_alike(tmp_path, monkeypatch):
    """Tiny default checkpoints under PERCEIVE_TPU_MODEL_DATA, no fallback:
    AppState with no model passed loads MsMarcoBertBaseDotV5 (id 7) and, as
    a model of its own, AllMiniLmL6V2 (id 0) in both packages; over one
    database the port ingested, ``search --like`` gives the same (item,
    score) hits and a text query the same items."""
    models = tmp_path / "models"
    for name, cfg, head in (("MsMarcoBertBaseDotV5", _bert(64, 2, len(UNCASED)), {"normalize": False}),
                            ("AllMiniLmL6V2", _bert(32, 2, len(UNCASED)), {"normalize": True})):
        SMOKE.write_checkpoint(str(models / ModelType.parse(name).checkpoint_dir_name), cfg, UNCASED, 96, seed=9,
                               **head)
    monkeypatch.setenv("PERCEIVE_TPU_MODEL_DATA", str(models))
    monkeypatch.setenv("PERCEIVE_TPU_REQUIRE_CHECKPOINT", "1")
    docs = tmp_path / "docs"
    docs.mkdir()
    rng = np.random.default_rng(5)
    for i in range(10):
        (docs / f"d{i}.txt").write_text(" ".join(rng.choice(WORDS, size=int(rng.integers(5, 60)))))
    db = str(tmp_path / "db.sqlite3")

    ps = AppState(db, device="cpu")
    assert (ps.model.name, ps.model.model_id, ps.model.dim, ps.model.head.normalize) == (
        "MsMarcoBertBaseDotV5", 7, 64, False)
    assert ps.highlights_model is not ps.model
    assert (ps.highlights_model.name, ps.highlights_model.model_id, ps.highlights_model.dim) == (
        "AllMiniLmL6V2", 0, 32)
    with redirect_stdout(io.StringIO()):
        assert main(["source", "add", "fs", str(docs), "--name", "docs"], state=ps) == 0
        assert main(["source", "scan", "docs"], state=ps) == 0
    item = int(ps.searcher.matrix.item_ids[0] // 4096)
    like = ["search", "--like", str(item), "-n", "5", "--json"]
    text = ["search", "semantic river notes", "-n", "5", "--json"]
    got_like, got_text = _search(main, ps, like), _search(main, ps, text)
    ps.close()

    js = JaxAppState(db, engine="xla")
    assert (js.model.name, js.model.model_id, js.highlights_model.name, js.highlights_model.model_id) == (
        "MsMarcoBertBaseDotV5", 7, "AllMiniLmL6V2", 0)
    assert js.highlights_model is not js.model
    want_like, want_text = _search(jax_main, js, like), _search(jax_main, js, text)
    js.close()
    scale = max(abs(r["score"]) for r in want_like)  # |q| |r| of the best hit: the query is a stored row
    assert got_like and [r["id"] for r in got_like] == [r["id"] for r in want_like]
    np.testing.assert_allclose([r["score"] for r in got_like], [r["score"] for r in want_like],
                               atol=1e-4 * scale, rtol=0)
    assert got_text and [r["id"] for r in got_text] == [r["id"] for r in want_text]
