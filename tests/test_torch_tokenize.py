"""The port's pure-Python WordPiece tokenizer against the JAX package's
``TextTokenizer`` (HF ``tokenizers``): ids, offsets, special-token masks
and type ids compared exactly, as are the padded batches, the wrap budget
and token-window packing."""

from pathlib import Path

import numpy as np
import pytest

from perceive_tpu.models.tokenize import TextTokenizer as HfTokenizer
from perceive_tpu.models.tokenize import tiny_test_vocab as hf_tiny_vocab
from perceive_tpu_torch.models.tokenize import TextTokenizer, tiny_test_vocab
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse: one intra-op thread)

FIXTURES = Path(__file__).resolve().parent / "fixtures"

TEXTS = [
    "Café hello!",
    "café x naïve NAÏVE café",
    "日本語 hi 中文text",
    "a\x00b\u200bc d\u00a0e\x85f g\u2028h",
    "x" * 100,
    "x" * 101,
    "hello" * 30,
    "İstanbul Σσς ΣΑΣ",
    "\U0002B820a \U0002B91Fb \U0002B920c 豈d",
    "Straße ÜBER über",
    "hello,world.the!search (semantic) [search]",
    "�hello\x7fworld\x1cz",
    "ﬁne  ﬃ Ⅷ",
    "ǅemal Ǆ",
    "\U0001F642 emoji\U0001F642x",
    "$100 +5 <a> ^b| ~c `d",
    "¿qué? ¡sí! «x» —y— “z”",
    "ﾊﾝｶｸ カタカナ 한국어 텍스트",
    "Hello\tworld\nnew\r\nline",
    "",
    "   ",
    "zzqqxx unknownword hellox",
    " ".join(["hello world"] * 40),
]

WORDS = ["café", "hello", "world", "naïve", "the", "search", "semantic", "cafe", "über",
         "straße", "日", "中", "text", "emoji", "line", "new"]


def _vocab():
    v = tiny_test_vocab(WORDS)
    for extra in (",", ".", "!", "(", ")", "##ne", "##x"):
        v.setdefault(extra, len(v))
    return v


def _pair(max_len=24):
    v = _vocab()
    return HfTokenizer.from_vocab(v, max_seq_length=max_len), TextTokenizer.from_vocab(v, max_seq_length=max_len)


def _same_encoding(a, b):
    assert list(a.ids) == b.ids
    assert [tuple(o) for o in a.offsets] == b.offsets
    assert list(a.special_tokens_mask) == b.special_tokens_mask
    assert list(a.type_ids) == b.type_ids


@pytest.mark.parametrize("text", TEXTS)
def test_untruncated_encodings_match(text):
    hf, port = _pair()
    _same_encoding(hf.encode_untruncated([text])[0], port.encode_untruncated([text])[0])


def test_tiny_vocab_matches():
    assert tiny_test_vocab(WORDS) == hf_tiny_vocab(WORDS)


@pytest.mark.parametrize("max_len", [8, 24, 128])
def test_batches_match(max_len):
    hf, port = _pair(max_len)
    a, b = hf.encode_batch(TEXTS, pad_batch_to=32), port.encode_batch(TEXTS, pad_batch_to=32)
    for name in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    np.testing.assert_array_equal(hf.encode_batch_ids(TEXTS), port.encode_batch_ids(TEXTS))
    assert hf.wrap_budget == port.wrap_budget == max_len - 2


def test_token_windows_match():
    hf, port = _pair(24)
    windows = [[5, 6, 7], list(range(5, 40)), []]
    np.testing.assert_array_equal(
        hf.pack_token_windows(windows, pad_batch_to=8), port.pack_token_windows(windows, pad_batch_to=8)
    )
    a, b = hf.encode_token_chunks(windows), port.encode_token_chunks(windows)
    np.testing.assert_array_equal(a.input_ids, b.input_ids)
    np.testing.assert_array_equal(a.attention_mask, b.attention_mask)


def test_golden_vocab_matches():
    d = FIXTURES / "golden_st_checkpoint"
    hf, port = HfTokenizer.from_dir(d, max_seq_length=64), TextTokenizer.from_dir(d, max_seq_length=64)
    assert hf.pad_id == port.pad_id
    for text in TEXTS:
        _same_encoding(hf.encode_untruncated([text])[0], port.encode_untruncated([text])[0])
    np.testing.assert_array_equal(hf.encode_batch(TEXTS).input_ids, port.encode_batch(TEXTS).input_ids)


def test_offsets_slice_original_text():
    _, port = _pair()
    text = "Naïve café, ÜBER straße!"
    enc = port.encode_untruncated([text])[0]
    pieces = [text[s:e] for (s, e), sp in zip(enc.offsets, enc.special_tokens_mask) if not sp]
    assert "".join(pieces) == text.replace(" ", "")


@pytest.mark.parametrize("lowercase,pad", [(True, None), (False, "[PAD]"), (True, "[SEP]")])
def test_tokenizer_json_only_checkpoint_matches(tmp_path, lowercase, pad):
    """A checkpoint that ships a WordPiece tokenizer.json and no vocab.txt
    (written by the tokenizers library itself, with a custom continuing
    prefix and word length): both packages' from_dir read it to the same
    ids, padded batches and pad id."""
    import json

    from perceive_tpu.models.tokenize import _build_wordpiece

    vocab = hf_tiny_vocab(["hello", "world", "search", "café", "x", "##ll", "straße", "über"])
    tok = _build_wordpiece(vocab, lowercase=lowercase)
    spec = json.loads(tok.to_str())
    spec["model"]["continuing_subword_prefix"] = "@@"
    spec["model"]["max_input_chars_per_word"] = 40
    vocab_at = {w.replace("##", "@@"): i for w, i in spec["model"]["vocab"].items()}
    spec["model"]["vocab"] = vocab_at
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    if pad is not None:
        (tmp_path / "tokenizer_config.json").write_text(json.dumps({"pad_token": {"content": pad}}))
    hf, port = HfTokenizer.from_dir(tmp_path, max_seq_length=64), TextTokenizer.from_dir(tmp_path, max_seq_length=64)
    assert not (tmp_path / "vocab.txt").exists()
    assert hf.pad_id == port.pad_id
    assert hf._special_wrap() == port._special_wrap() and hf.wrap_budget == port.wrap_budget
    for text in TEXTS:
        _same_encoding(hf.encode_untruncated([text])[0], port.encode_untruncated([text])[0])
    a, b = hf.encode_batch(TEXTS, pad_batch_to=32), port.encode_batch(TEXTS, pad_batch_to=32)
    for name in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_tokenizer_json_other_models_raise(tmp_path):
    """A tokenizer.json whose model the port does not read (WordLevel) is
    not read as another model: a clear error naming it, not wrong ids."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    wl = Tokenizer(models.WordLevel(vocab={"a": 0, "b": 1, "[UNK]": 2}, unk_token="[UNK]"))
    wl.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    wl.save(str(tmp_path / "tokenizer.json"))
    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\na\n")
    with pytest.raises(ValueError, match="WordLevel"):
        TextTokenizer.from_dir(tmp_path)
