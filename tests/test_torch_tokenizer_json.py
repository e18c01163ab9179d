"""The port's tokenizer.json pipelines (byte-level BPE, Unigram) against the
tokenizers library and against the JAX package's ``TextTokenizer.from_dir``.

The files are made here with the library: a ``BpeTrainer`` over the
byte-level alphabet with RoBERTa's specials and post-processor, and a
``UnigramTrainer`` behind ALBERT's normalizer and pre-tokenizer sequence,
with a hand-built darts-clone ``precompiled_charsmap``.  Ids, type ids,
special-token masks and character offsets are compared exactly; a small
roberta and albert checkpoint embed through ``Model.new_pretrained`` in
both packages within rtol 1e-3, atol 1e-4 at f32.
"""

import json
import random
import struct

import numpy as np
import pytest
import torch
from tokenizers import AddedToken, Tokenizer, models, normalizers, pre_tokenizers, processors
from tokenizers.trainers import BpeTrainer, UnigramTrainer

from perceive_tpu.models.tokenize import TextTokenizer as HfTokenizer
from perceive_tpu_torch.models.tokenize import TextTokenizer
from perceive_tpu_torch.models.tokenizer_json import Pipeline, graphemes
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

CORPUS = ["hello world the quick brown fox", "jumps over the lazy dog's tail", "café naïve ÜBER 日本語 emoji🙂",
          "it's they're we've I'm you'll he'd", "search semantic retrieval index vector",
          "Ｆｕｌｌ ① ㎏ x́"] * 30

TEXTS = [
    "hello world", "  hello   world  ", "it's IT'S they'RE 'll ''d", "héllo  ",
    "x\xa0\x85y\x1cz\x1d \x1e\x1fq",  # U+0085 is White_Space; U+001C-U+001F are not (str.isspace says they are)
    "a　b c d​e", "hello <mask> world", "<mask>", " <mask>x", "hello<mask>  <mask>", "<s>hi</s>",
    "café naïve NAÏVE éé ạ́ ạ́ ȫ",
    "日本語 中文text 한국어 각 각",
    "\U0001F642 \U0001F468‍\U0001F469‍\U0001F467 \U0001F1EF\U0001F1F5x \U0001F44D\U0001F3FD ❤️",
    "Ｆｕｌｌ ① ② ㎏ ﬁne Ⅷ ² Ｆ́ ①́", "$100 +5 <a> ^b| ~c `d ``quoted'' text", "tab\tnew\nline\r\nend",
    "", "   ", "a", "́", "x" * 300, "İstanbul Σσς ΣΑΣ ǅ", "ﾊﾝｶｸ カタカナ", "﻿bom \xadsoft",
    "1234 5.6 ٣٤ 一二三", "x \x00 y � z", "Hello, World! (Semantic) [search]", "don't stop believin'",
    "क्ष ा a‍b ‌",
]
_POOL = list("abcXYZ019 '\t\n\r.,!?-_") + [
    " ", "\x85", "\x1c", "　", "́", "̣", "é", "Ｆ", "①", "㎏", "ﬁ", "Σ", "İ", "日", "한", "ᄀ",
    "ᅡ", "ᆨ", "\U0001F642", "‍", "\U0001F1EF", "\U0001F1F5", "️", "​", "<mask>", "<s>",
    "``", "''", "'s", "'ll", "²", "Ⅷ", "٣", "ः", "\x00", "�", "﻿"]
_RNG = random.Random(0)
FUZZ = ["".join(_RNG.choice(_POOL) for _ in range(_RNG.randint(0, 25))) for _ in range(150)]


def darts_charsmap(entries: dict) -> bytes:
    """A ``precompiled_charsmap``: the u32 trie size, a darts-clone double
    array (each node's children in a 256-unit block of its own), then the
    NUL-terminated replacements."""
    blob, value_at = b"", {}
    for key, value in entries.items():
        value_at[key] = len(blob)
        blob += value.encode() + b"\0"
    root: dict = {}
    for key in entries:
        node = root
        for b in key.encode():
            node = node.setdefault(b, {})
        node[None] = value_at[key]
    units, blocks = {}, [1]

    def place(node, pos, label):
        base = 256 * blocks[0]
        blocks[0] += 1
        units[pos] = label | ((1 << 8) if None in node else 0) | ((pos ^ base) << 10)
        if None in node:
            units[base] = node[None] | (1 << 31)
        for c, child in node.items():
            if c is not None:
                place(child, base ^ c, c)

    place(root, 0, 0)
    n = 256 * blocks[0]
    return struct.pack("<I", 4 * n) + struct.pack(f"<{n}I", *(units.get(i, 0) for i in range(n))) + blob


# a full-width letter, circled digits, a base + combining accent, one
# replacement of two chars and two that delete
CHARSMAP = darts_charsmap({"Ｆ": "F", "ｕ": "u", "ｌ": "l", "①": "1", "②": "2", "㎏": "kg", "é": "é",
                           "​": "", "﻿": ""})


def _bpe(add_prefix_space=False, post="roberta"):
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=add_prefix_space)
    tok.train_from_iterator(CORPUS, BpeTrainer(
        vocab_size=700, special_tokens=["<s>", "<pad>", "</s>", "<unk>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False))
    if post == "roberta":
        tok.post_processor = processors.RobertaProcessing(("</s>", 2), ("<s>", 0), trim_offsets=True,
                                                          add_prefix_space=True)
    else:
        tok.post_processor = processors.TemplateProcessing(single="<s> $A:1 </s>",
                                                           special_tokens=[("<s>", 0), ("</s>", 2)])
    tok.add_special_tokens([AddedToken("<mask>", lstrip=True, normalized=False, special=True)])
    return tok


def _albert_normalizer(charsmap=True):
    steps = [normalizers.Replace("``", '"'), normalizers.Replace("''", '"'), normalizers.NFKD(),
             normalizers.StripAccents(), normalizers.Lowercase()]
    return normalizers.Sequence(steps + ([normalizers.Precompiled(CHARSMAP)] if charsmap else []))


def _unigram(normalizer, metaspace=None):
    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizer
    tok.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(),
                                                 metaspace or pre_tokenizers.Metaspace()])
    tok.train_from_iterator(CORPUS, UnigramTrainer(
        vocab_size=300, special_tokens=["<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"], unk_token="<unk>",
        show_progress=False))
    tok.post_processor = processors.TemplateProcessing(single="[CLS]:0 $A:0 [SEP]:0",
                                                       special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
    return tok


def _old_merges(spec):
    spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]


def _bpe_word_pieces():
    """A BPE over WhitespaceSplit with an unk token, fused unknowns, a
    continuing-subword prefix and an end-of-word suffix."""
    tok = Tokenizer(models.BPE(unk_token="<unk>", fuse_unk=True, continuing_subword_prefix="##",
                               end_of_word_suffix="</w>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.train_from_iterator(CORPUS[:5], BpeTrainer(
        vocab_size=200, special_tokens=["<unk>"], continuing_subword_prefix="##", end_of_word_suffix="</w>",
        show_progress=False))
    return tok


def _ignore_merges(spec):
    spec["model"]["ignore_merges"] = True


def _normalized_added(spec):
    spec["added_tokens"].append({"id": 3, "content": "[CLS]", "single_word": False, "lstrip": False,
                                 "rstrip": True, "normalized": True, "special": False})
    spec["added_tokens"].append({"id": 5, "content": "ab", "single_word": True, "lstrip": False,
                                 "rstrip": False, "normalized": False, "special": False})


FAMILIES = {
    "bpe": (_bpe, None),
    "bpe_prefix_space": (lambda: _bpe(add_prefix_space=True), None),
    "bpe_template_post": (lambda: _bpe(post="sequence"), None),
    "bpe_string_merges": (_bpe, _old_merges),
    "bpe_ignore_merges": (_bpe, _ignore_merges),
    "bpe_unk_prefix_suffix": (_bpe_word_pieces, None),
    "unigram_albert": (lambda: _unigram(_albert_normalizer()), None),
    "unigram_albert_added": (lambda: _unigram(_albert_normalizer()), _normalized_added),
    "unigram_charsmap": (lambda: _unigram(normalizers.Precompiled(CHARSMAP)), None),
    "unigram_nfd": (lambda: _unigram(normalizers.NFD()), None),
    "unigram_nfc": (lambda: _unigram(normalizers.NFC()), None),
    "unigram_nfkc": (lambda: _unigram(normalizers.Sequence([normalizers.NFKC(), normalizers.Lowercase()])), None),
    "unigram_first": (lambda: _unigram(normalizers.Lowercase(), pre_tokenizers.Metaspace(prepend_scheme="first")),
                      None),
    "unigram_no_split": (lambda: _unigram(normalizers.Lowercase(), pre_tokenizers.Metaspace(split=False)), None),
    "unigram_bert_normalizer": (lambda: _unigram(normalizers.BertNormalizer(lowercase=True)), None),
}


def _family(name):
    make, edit = FAMILIES[name]
    spec = json.loads(make().to_str())
    if edit:
        edit(spec)
    return Tokenizer.from_str(json.dumps(spec)), Pipeline(spec)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pipeline_matches_the_library(family):
    lib, port = _family(family)
    for text in TEXTS + FUZZ:
        for add in (True, False):
            a, b = lib.encode(text, add_special_tokens=add), port.encode(text, add_special_tokens=add)
            assert (b.ids, b.type_ids, b.offsets, b.special_tokens_mask) == (
                a.ids, a.type_ids, [tuple(o) for o in a.offsets], a.special_tokens_mask), (family, text, add)


def _dirs(tmp_path, max_len):
    """A RoBERTa-like (byte-level BPE) and an ALBERT-like (Unigram)
    checkpoint's tokenizer files, each loaded by both packages."""
    out = {}
    for name, tok, pad in (("roberta", _bpe(), "<pad>"), ("albert", _unigram(_albert_normalizer()), "<pad>")):
        d = tmp_path / name
        d.mkdir()
        tok.save(str(d / "tokenizer.json"))
        (d / "tokenizer_config.json").write_text(json.dumps({"pad_token": pad}))
        out[name] = (HfTokenizer.from_dir(d, max_seq_length=max_len), TextTokenizer.from_dir(d, max_seq_length=max_len))
    return out


@pytest.mark.parametrize("family", ["roberta", "albert"])
def test_from_dir_matches_the_jax_package(tmp_path, family):
    hf, port = _dirs(tmp_path, 24)[family]
    assert hf.pad_id == port.pad_id == {"roberta": 1, "albert": 0}[family]
    assert hf._special_wrap() == port._special_wrap()
    assert hf.wrap_budget == port.wrap_budget == 22
    for a, b in zip(hf.encode_untruncated(TEXTS), port.encode_untruncated(TEXTS)):
        assert (b.ids, b.type_ids, b.offsets, b.special_tokens_mask) == (
            a.ids, a.type_ids, [tuple(o) for o in a.offsets], a.special_tokens_mask)
    for max_len in (8, 24):
        hf.max_seq_length = port.max_seq_length = max_len
        a, b = hf.encode_batch(TEXTS, pad_batch_to=64), port.encode_batch(TEXTS, pad_batch_to=64)
        for field in ("input_ids", "attention_mask", "token_type_ids"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        np.testing.assert_array_equal(hf.encode_batch_ids(TEXTS), port.encode_batch_ids(TEXTS))
    hf.max_seq_length = port.max_seq_length = 24
    windows = [[5, 6, 7], list(range(5, 40)), []]
    np.testing.assert_array_equal(hf.pack_token_windows(windows, pad_batch_to=8),
                                  port.pack_token_windows(windows, pad_batch_to=8))
    a, b = hf.encode_token_chunks(windows), port.encode_token_chunks(windows)
    np.testing.assert_array_equal(a.input_ids, b.input_ids)
    np.testing.assert_array_equal(a.attention_mask, b.attention_mask)


@pytest.mark.parametrize("text,want", [
    ("éx", ["é", "x"]),
    ("ạ́b", ["ạ́", "b"]),
    ("\U0001F468‍\U0001F469‍\U0001F467!", ["\U0001F468‍\U0001F469‍\U0001F467", "!"]),
    ("\U0001F44D\U0001F3FD❤️", ["\U0001F44D\U0001F3FD", "❤️"]),
    ("\U0001F1EF\U0001F1F5\U0001F1FA", ["\U0001F1EF\U0001F1F5", "\U0001F1FA"]),
    ("각각", ["각", "각"]),
    ("a\r\nb\n\r", ["a", "\r\n", "b", "\n", "\r"]),
    ("क्षा", ["क्", "षा"]),
])
def test_graphemes(text, want):
    assert graphemes(text) == want


def test_charsmap_takes_a_clusters_shortest_key():
    """The library looks a grapheme of under 6 bytes up whole, and takes the
    replacement of its shortest key prefix: Ｆ + U+0301 (5 bytes) becomes F,
    the accent gone; ① + U+0301 (5 bytes) likewise; e + U+0301 is a key."""
    spec = json.loads(_unigram(normalizers.Precompiled(CHARSMAP)).to_str())
    port = Pipeline(spec)
    lib = Tokenizer.from_str(json.dumps(spec))
    for text in ("Ｆ́", "①́x", "é", "a​b", "﻿z"):
        assert lib.normalizer.normalize_str(text) == port.normalizer((text, list(range(len(text)))))[0]
        assert port.encode(text).offsets == [tuple(o) for o in lib.encode(text).offsets]


def test_gpt2_split_whitespace_classes():
    """U+0085 and U+3000 are White_Space (a space run), U+001C-U+001F are
    not (they split off as symbols), as the library's Oniguruma sees them."""
    from perceive_tpu_torch.models.tokenizer_json import BYTES_CHAR, gpt2_split

    pre = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    for text in ("a\x85\x85b", "a\x1c\x1db", "x 　 y", "a\x1f b", "it's 'S 're", "x  \n\ty  ", "½ ² ٣ 一"):
        want = [s for s, _ in pre.pre_tokenize_str(text)]
        # the library's pieces come back through the byte-to-unicode map
        got = ["".join(BYTES_CHAR[b] for b in m.group().encode()) for m in gpt2_split().finditer(text)]
        assert got == want, (text, got, want)


def _spec(tok, **edits):
    spec = json.loads(tok.to_str())
    for path, value in edits.items():
        node = spec
        *head, last = path.split("__")
        for key in head:
            node = node[key]
        node[last] = value
    return spec


@pytest.mark.parametrize("edit,match", [
    (dict(model__dropout=0.1), "dropout"),
    (dict(pre_tokenizer={"type": "Split", "pattern": {"Regex": "\\s+"}, "behavior": "Removed", "invert": False}),
     "Split"),
    (dict(pre_tokenizer={"type": "Whitespace"}), "Whitespace"),
    (dict(normalizer={"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}), "Replace"),
    (dict(normalizer={"type": "Prepend", "prepend": "_"}), "Prepend"),
    (dict(post_processor={"type": "ByteLevel", "trim_offsets": True}), "ByteLevel"),
    (dict(normalizer={"type": "Strip", "strip_left": True, "strip_right": True}), "Strip"),
    (dict(post_processor={"type": "Foo"}), "Foo"),
])
def test_unported_components_raise(tmp_path, edit, match):
    (tmp_path / "tokenizer.json").write_text(json.dumps(_spec(_bpe(), **edit)))
    with pytest.raises(ValueError, match=match):
        TextTokenizer.from_dir(tmp_path)


def test_unigram_byte_fallback_raises(tmp_path):
    (tmp_path / "tokenizer.json").write_text(json.dumps(_spec(_unigram(normalizers.Lowercase()),
                                                              model__byte_fallback=True)))
    with pytest.raises(ValueError, match="byte_fallback"):
        TextTokenizer.from_dir(tmp_path)


# -- the smoke's synthetic files, and a small checkpoint of each family end to end --


def _smoke():
    """chip_smoke.py, whose tokenizer.json and checkpoint writers run here."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("family", ["bpe", "unigram"])
def test_smoke_tokenizer_files_match_the_library(family):
    """The smoke's full-size synthetic tokenizer.json files (50,265 and 30,000
    entries) encode its generated documents as the library does, and
    mostly a word a token."""
    smoke = _smoke()
    spec = smoke.bpe_tokenizer_json() if family == "bpe" else smoke.unigram_tokenizer_json()
    n = len(spec["model"]["vocab"])
    assert n == (50265 if family == "bpe" else 30000)
    lib, port = Tokenizer.from_str(json.dumps(spec)), Pipeline(spec)
    assert lib.get_vocab_size() == n
    docs = smoke.family_docs(np.random.default_rng(0), spec, n_docs=12, n_long=2)
    for text in docs + TEXTS[:12]:
        a, b = lib.encode(text), port.encode(text)
        assert (b.ids, b.offsets, b.special_tokens_mask) == (
            a.ids, [tuple(o) for o in a.offsets], a.special_tokens_mask), text[:60]
    words = sum(len(d.split()) for d in docs)
    tokens = sum(len(port.encode(d, add_special_tokens=False).ids) for d in docs)
    assert words <= tokens < 1.5 * words


def _checkpoint(d, family, tok, hidden=64):
    """A 2-layer checkpoint of ``family`` through the smoke's writer, at the
    published config's other fields."""
    smoke = _smoke()
    name = "AllDistilrobertaV1" if family == "roberta" else "ParaphraseAlbertSmallV2"
    cfg = dict(smoke.FAMILIES[name]["config"], vocab_size=tok.get_vocab_size(), hidden_size=hidden,
               num_hidden_layers=2, num_attention_heads=4, intermediate_size=2 * hidden)
    if family == "albert":
        cfg["embedding_size"] = hidden // 2
    else:
        cfg["max_position_embeddings"] = 130
    smoke.write_checkpoint(str(d), cfg, json.loads(tok.to_str()), 128, seed=3)


@pytest.mark.parametrize("family,model_type", [("roberta", "AllDistilrobertaV1"),
                                               ("albert", "ParaphraseAlbertSmallV2")])
def test_checkpoint_embeds_as_the_jax_package(tmp_path, monkeypatch, family, model_type):
    """A registry checkpoint of each family under PERCEIVE_TPU_MODEL_DATA
    loads through Model.new_pretrained in both packages and embeds alike
    (sequences under 384 tokens: plain attention on both sides)."""
    from perceive_tpu.models import Model as JaxModel
    from perceive_tpu.models.registry import ModelType as JaxType
    from perceive_tpu_torch.models import Model, ModelType

    tok = _bpe() if family == "roberta" else _unigram(_albert_normalizer())
    _checkpoint(tmp_path / ModelType.parse(model_type).checkpoint_dir_name, family, tok)
    monkeypatch.setenv("PERCEIVE_TPU_MODEL_DATA", str(tmp_path))
    jm = JaxModel.new_pretrained(JaxType.parse(model_type), compute_dtype=np.float32, attention_impl="xla")
    pm = Model.new_pretrained(ModelType.parse(model_type), device="cpu", compute_dtype=torch.float32)
    assert pm.name == model_type and pm.model_id == ModelType.parse(model_type).model_id
    assert pm.tokenizer.max_seq_length == jm.tokenizer.max_seq_length == 128
    assert pm.tokenizer.pad_id == jm.tokenizer.pad_id == (1 if family == "roberta" else 0)
    texts = [t for t in TEXTS if t.strip()] + [" ".join(CORPUS[:6])]
    np.testing.assert_array_equal(jm.tokenizer.encode_batch(texts).input_ids, pm.tokenizer.encode_batch(texts).input_ids)
    np.testing.assert_allclose(pm.encode(texts), jm.encode(texts), rtol=1e-3, atol=1e-4)


def test_model_set_loads_the_checkpoint(tmp_path, monkeypatch):
    """``model set`` then a fresh AppState that must load the checkpoint
    (PERCEIVE_TPU_REQUIRE_CHECKPOINT): the Unigram family is served, not
    the random fallback."""
    from perceive_tpu_torch.cli import AppState
    from perceive_tpu_torch.cli import main as cli_main
    from perceive_tpu_torch.models import EncoderArch, HeadConfig, Model, ModelType, tiny_test_vocab

    _checkpoint(tmp_path / "models" / ModelType.PARAPHRASE_ALBERT_SMALL_V2.checkpoint_dir_name, "albert",
                _unigram(_albert_normalizer()))
    monkeypatch.setenv("PERCEIVE_TPU_MODEL_DATA", str(tmp_path / "models"))
    monkeypatch.setenv("PERCEIVE_TPU_REQUIRE_CHECKPOINT", "1")
    vocab = tiny_test_vocab(["hello"])
    small = Model.random(EncoderArch(vocab_size=len(vocab), hidden_size=32, num_layers=1, num_heads=4,
                                     intermediate_size=64, max_position_embeddings=32),
                         HeadConfig(normalize=True), TextTokenizer.from_vocab(vocab, max_seq_length=32), device="cpu")
    db = str(tmp_path / "db.sqlite3")
    setter = AppState(db, model=small, highlights_model=small, device="cpu", build_searcher=False)
    assert cli_main(["--db", db, "model", "set", "ParaphraseAlbertSmallV2"], state=setter) == 0
    setter.close()
    state = AppState(db, highlights_model=small, device="cpu")
    assert state.model.name == "ParaphraseAlbertSmallV2" and state.model.dim == 64
    state.close()
