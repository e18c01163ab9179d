"""The compiled tokenizer (``perceive_tpu_torch/native/tokenizer.cpp``)
against its plain versions, the pure-Python pipelines it is built from.

Every tokenizer.json family of ``test_torch_tokenizer_json.FAMILIES``, the
smoke's full-size BPE and Unigram files and WordPiece (from a vocab, cased
and lowercased, and from a tokenizer.json) encode alike in both: ids, type
ids, offsets (code-point indices of the original text) and special masks,
with and without specials, untruncated and truncated, over the texts of the
port's tokenizer tests and the smoke's generated documents.  Random Unicode
text (combining marks, CJK, controls, every whitespace class, lone
surrogates, words past 100 characters) is held to the plain versions by
hypothesis; threads and the engine's own thread count do not change what
it returns; a failed build raises rather than falling back to Python.
"""

import functools
import json
import threading
import unicodedata

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_tokenize import TEXTS as WORDPIECE_TEXTS
from test_torch_tokenize import _vocab
from test_torch_tokenizer_json import FAMILIES, FUZZ, TEXTS, _family, _smoke

from perceive_tpu.models.tokenize import _build_wordpiece
from perceive_tpu_torch.models.tokenize import TextTokenizer, WordPieceTokenizer, _wordpiece_from_spec
from perceive_tpu_torch.models.tokenizer_json import Pipeline
from perceive_tpu_torch.native import tokenizer as native_tokenizer
from perceive_tpu_torch.native.tokenizer import NativeTokenizer


def _wordpiece_json():
    """A WordPiece tokenizer.json written by the tokenizers library, with a
    custom continuing prefix and word length."""
    spec = json.loads(_build_wordpiece(_vocab(), lowercase=True).to_str())
    spec["model"]["continuing_subword_prefix"] = "@@"
    spec["model"]["max_input_chars_per_word"] = 40
    spec["model"]["vocab"] = {w.replace("##", "@@"): i for w, i in spec["model"]["vocab"].items()}
    return _wordpiece_from_spec(spec)


def _smoke_family(kind):
    """The smoke's full-size tokenizer.json of ``kind`` and its documents, as
    test_smoke_tokenizer_files_match_the_library builds them."""
    smoke = _smoke()
    spec = smoke.bpe_tokenizer_json() if kind == "bpe" else smoke.unigram_tokenizer_json()
    docs = smoke.family_docs(np.random.default_rng(0), spec, n_docs=12, n_long=2)
    return Pipeline(spec), docs + TEXTS[:12]


def _smoke_wordpiece():
    """The smoke's all-MiniLM-L6-v2-width vocabulary and its first documents."""
    smoke = _smoke()
    words = smoke.minilm_vocab()
    docs = smoke.make_docs(np.random.default_rng(11), words)
    return WordPieceTokenizer({w: i for i, w in enumerate(words)}), docs[:6] + docs[smoke.N_LONG:smoke.N_LONG + 40]


# canonical ordering and composition: marks of equal and of lower class
# after one that does not compose (blocked), Hangul L V T, a two-starter pair
MARKED = ["a\u0363\u0301 a\u0301\u0363 a\u0316\u0301 e\u0302\u0323 \u1ea1\u0302 a\u0315\u0300\u05ae\u0301",
          "\u1100\u1161\u11a8 \u1100\u1161 \uac00\u11a8 \u0b47\u0b3e \u0344 \u0958 \u2126\u0301 \u212b"]

CASES = {
    **{name: (lambda name=name: (_family(name)[1], TEXTS + FUZZ + MARKED)) for name in FAMILIES},
    "wordpiece_lowercase": lambda: (WordPieceTokenizer(_vocab(), lowercase=True),
                                    WORDPIECE_TEXTS + TEXTS + FUZZ + MARKED),
    "wordpiece_cased": lambda: (WordPieceTokenizer(_vocab(), lowercase=False), WORDPIECE_TEXTS + TEXTS + FUZZ),
    "wordpiece_tokenizer_json": lambda: (_wordpiece_json(), WORDPIECE_TEXTS + TEXTS + FUZZ),
    "smoke_bpe": lambda: _smoke_family("bpe"),
    "smoke_unigram": lambda: _smoke_family("unigram"),
    "smoke_wordpiece": _smoke_wordpiece,
}


def _fields(e):
    return e.ids, e.type_ids, e.offsets, e.special_tokens_mask


@pytest.mark.parametrize("case", list(CASES))
def test_engine_equals_plain(case):
    plain, texts = CASES[case]()
    engine = NativeTokenizer(plain)
    for add in (True, False):
        for max_length in (None, 7):
            got = engine.encode_batch(texts, add_special_tokens=add, max_length=max_length)
            for text, g in zip(texts, got):
                want = plain.encode(text, add_special_tokens=add, max_length=max_length)
                assert _fields(g) == _fields(want), (case, add, max_length, text[:80])


# -- random text -----------------------------------------------------------------

_SPECIAL = [
    "́", "̣", "̈", "̈́", "ͅ", "ཱི", "େ", "ା",  # marks, odd decompositions
    "一", "㐀", "\U00020000", "豈", "　", "Ｆ", "①", "㎏", "ﬁ",  # CJK, compat
    "\x00", "\x01", "\x1c", "\x7f", "\x85", "�", "​", "‌", "‍", "﻿", "\xad",  # controls
    " ", "\t", "\n", "\r", "\xa0", " ", " ", " ", " ", " ", " ",  # whitespace
    "\ud800", "\udc00", "\udfff",  # lone surrogates
    "ᄀ", "ᅡ", "ᆨ", "가", "각",  # Hangul jamo and syllables
    "\U0001f1ef", "\U0001f1f5", "\U0001f642", "\U0001f3fd", "❤", "️",  # emoji, regional indicators
    "İ", "Σ", "ẛ", "Ω", "Å", "'", "'s", "'ll", "<s>", "<mask>", "[CLS]", "``", "''",
]
_MARKS = "\u0300\u0301\u0302\u0308\u0315\u0316\u031b\u0323\u0345\u0363\u05ae\u0b3e\u11a8\u1161"
_CHAR = st.one_of(st.characters(), st.characters(max_codepoint=0x2FF), st.sampled_from(_SPECIAL),
                  st.builds(lambda base, marks: base + "".join(marks), st.sampled_from("aeoAEOuU\u1100\u0b47\uac00"),
                            st.lists(st.sampled_from(_MARKS), max_size=4)))
_TEXT = st.one_of(
    st.lists(_CHAR, max_size=40).map("".join),
    st.builds(lambda word, rest: word + rest, st.text("abcé́x", min_size=101, max_size=140),
              st.lists(_CHAR, max_size=8).map("".join)),
)
_RANDOM_CASES = {"wordpiece": lambda: WordPieceTokenizer(_vocab(), lowercase=True), "bpe": lambda: _family("bpe")[1],
                 "unigram": lambda: _family("unigram_albert")[1], "unigram_nfc": lambda: _family("unigram_nfc")[1]}


@functools.lru_cache(maxsize=None)
def _pair(family):
    plain = _RANDOM_CASES[family]()
    return plain, NativeTokenizer(plain)


def _outcome(fn, text):
    try:
        return _fields(fn(text))
    except Exception as e:  # noqa: BLE001 - the plain version's exception type is the answer
        return type(e)


@pytest.mark.parametrize("family", list(_RANDOM_CASES))
@settings(max_examples=150, deadline=None)
@given(text=_TEXT)
def test_random_text_equals_plain(family, text):
    plain, engine = _pair(family)
    assert _outcome(engine.encode, text) == _outcome(plain.encode, text)


def test_a_failing_text_raises_as_the_plain_version_does():
    """A lone surrogate meets the byte-level BPE's UTF-8 encoder: the batch
    raises UnicodeEncodeError at that text, as the plain loop does; the
    WordPiece normalizer drops it as a control char."""
    plain = _family("bpe")[1]
    with pytest.raises(UnicodeEncodeError):
        plain.encode("a\ud800b")
    with pytest.raises(UnicodeEncodeError):
        NativeTokenizer(plain).encode_batch(["fine", "a\ud800b", "fine"])
    wp = WordPieceTokenizer(_vocab())
    assert _fields(NativeTokenizer(wp).encode("a\ud800b")) == _fields(wp.encode("a\ud800b"))


# -- threads -----------------------------------------------------------------------


def test_threads_do_not_change_the_encodings():
    """Eight Python threads encoding interleaved batches of one engine get
    the one-thread answers; a batch split over 1, 3 or 8 engine threads
    returns the same arrays."""
    plain, docs = _smoke_wordpiece()
    texts = docs + TEXTS + FUZZ
    engine = NativeTokenizer(plain, threads=1)
    want = engine.encode_batch(texts)
    got: dict = {}

    def work(t):
        for rep in range(3):
            for b in range(t, len(texts), 8 * 16):
                got[(t, rep, b)] = engine.encode_batch(texts[b: b + 16])

    workers = [threading.Thread(target=work, args=(t * 16,)) for t in range(8)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
        assert not w.is_alive()
    for (_, _, b), encs in got.items():
        assert [_fields(e) for e in encs] == [_fields(e) for e in want[b: b + 16]]
    assert {b for _, _, b in got} == set(range(0, len(texts), 16))

    big = docs * 4  # past the engine's split threshold (65,536 code points)
    assert sum(map(len, big)) > 65536
    ref = engine.encode_arrays(big)
    for threads in (3, 8):
        engine.threads = threads
        out = engine.encode_arrays(big)
        for name in ref._fields:
            np.testing.assert_array_equal(getattr(out, name), getattr(ref, name))


# -- the build -------------------------------------------------------------------------


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No g++: the library does not build, and the tokenizer raises
    RuntimeError instead of tokenizing in Python."""
    monkeypatch.setattr(native_tokenizer, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_tokenizer, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native_tokenizer, "_lib", None)
    with pytest.raises(RuntimeError, match="did not build"):
        native_tokenizer.library()
    with pytest.raises(RuntimeError, match="did not build"):
        TextTokenizer.from_vocab(_vocab())
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_library_hash_follows_the_unicode_version(monkeypatch):
    key = native_tokenizer.source_key()
    monkeypatch.setattr(unicodedata, "unidata_version", "14.0.0")
    assert native_tokenizer.source_key() != key
    assert native_tokenizer.library_path().name == f"libtokenizer_{native_tokenizer.source_key()}.so"


def test_text_tokenizer_encodes_through_the_engine(monkeypatch):
    """Every entry point of TextTokenizer makes one engine call a batch and
    never calls the plain pipeline's encode."""
    tok = TextTokenizer.from_vocab(_vocab(), max_seq_length=24)
    calls = []
    untimed = tok.engine.encode_arrays

    def counted(texts, **kwargs):
        calls.append(len(texts))
        return untimed(texts, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("the plain pipeline encoded on the main path")

    monkeypatch.setattr(tok.engine, "encode_arrays", counted)
    monkeypatch.setattr(tok.tokenizer, "encode", refused)
    tok.encode_batch(WORDPIECE_TEXTS)
    tok.encode_batch_ids(WORDPIECE_TEXTS, pad_batch_to=32)
    tok.encode_untruncated(WORDPIECE_TEXTS)
    tok.encode_untruncated(WORDPIECE_TEXTS, fast=True)
    assert tok.wrap_budget == 22
    assert calls == [len(WORDPIECE_TEXTS)] * 4 + [1, 1]
