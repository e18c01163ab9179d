"""The tokenizer facade, with bucketed padding, and the plain WordPiece
pipeline.

Port of perceive_tpu/models/tokenize.py without the Rust ``tokenizers``
library.  ``TextTokenizer`` encodes through the compiled engine
(``native.tokenizer.NativeTokenizer``, one GIL-free call a batch), built
from a plain pipeline object: ``WordPieceTokenizer`` here, or a
``tokenizer_json.Pipeline``.  The plain pipelines are the engine's plain
versions, which the tests and the smoke hold it to; nothing on the main
path encodes through them.  ``WordPieceTokenizer`` reproduces the
library's BERT pipeline token for token:

  * normalizer (``BertNormalizer``): drop NUL, U+FFFD and control
    characters, map whitespace to a space, surround CJK ideographs with
    spaces, strip accents (NFD, drop nonspacing marks) when lowercasing,
    lowercase;
  * pre-tokenizer (``BertPreTokenizer``): split on whitespace, and put
    every punctuation character in a token of its own;
  * greedy longest-match WordPiece with the ``##`` continuation prefix; a
    word longer than 100 characters, or one with a piece that matches
    nothing, becomes a single ``[UNK]``;
  * the ``[CLS] $A [SEP]`` template, with truncation to ``max_seq_length``
    specials included.

``TextTokenizer.from_dir`` reads a checkpoint's ``tokenizer.json`` first,
as the JAX package does (``_tokenizer_from_json``): a WordPiece one as
that same pipeline, a byte-level BPE (the RoBERTa family) or a Unigram
(ALBERT) as a ``tokenizer_json.Pipeline``; another model, such as
WordLevel, raises ValueError.  Else it reads ``vocab.txt``.

Every normalized character remembers the original character it came from,
so token offsets are character ranges of the ORIGINAL text (the highlight
engine slices snippets with them).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import unicodedata
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SEQ_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512)

MAX_INPUT_CHARS_PER_WORD = 100
CONTINUING_PREFIX = "##"


def bucket_length(n: int, max_seq_length: int) -> int:
    for b in SEQ_BUCKETS:
        if b >= n and b <= max_seq_length:
            return b
    return max_seq_length


@dataclasses.dataclass
class TokenBatch:
    """Token arrays (all int32, shape (B, S))."""

    input_ids: np.ndarray
    attention_mask: np.ndarray
    token_type_ids: np.ndarray

    def __len__(self) -> int:
        return self.input_ids.shape[0]


@dataclasses.dataclass
class Encoding:
    """One encoded sequence, with the fields of a ``tokenizers`` Encoding
    that this package reads."""

    ids: list[int]
    type_ids: list[int]
    offsets: list[tuple[int, int]]
    special_tokens_mask: list[int]


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B920 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_control(c: str) -> bool:
    if c in "\t\n\r":
        return False
    return unicodedata.category(c) in ("Cc", "Cf", "Cn", "Co", "Cs")


def _is_whitespace(c: str) -> bool:
    return c in "\t\n\r " or unicodedata.category(c) in ("Zs", "Zl", "Zp")


def _is_punctuation(c: str) -> bool:
    o = ord(c)
    if 33 <= o <= 47 or 58 <= o <= 64 or 91 <= o <= 96 or 123 <= o <= 126:
        return True
    return unicodedata.category(c).startswith("P")


def bert_normalize(text: str, lowercase: bool) -> tuple[str, list[int]]:
    """The ``BertNormalizer`` (clean text, Chinese chars spaced, accents
    stripped when lowercasing): (normalized text, index in ``text`` of the
    char each normalized char came from)."""
    chars: list[str] = []
    align: list[int] = []
    ascii_only = text.isascii()
    for i, c in enumerate(text):
        if ascii_only:
            o = ord(c)
            if o == 0 or (o < 32 and c not in "\t\n\r") or o == 127:
                continue
            if c in "\t\n\r":
                c = " "
            chars.append(c.lower() if lowercase else c)
            align.append(i)
            continue
        if c == "\x00" or c == "\ufffd" or _is_control(c):
            continue
        if _is_whitespace(c):
            chars.append(" ")
            align.append(i)
            continue
        for p in (" ", c, " ") if _is_cjk(ord(c)) else (c,):
            if p == " " or not lowercase:
                chars.append(p)
                align.append(i)
                continue
            # accents strip whenever the text lowercases
            for d in unicodedata.normalize("NFD", p):
                if unicodedata.category(d) == "Mn":
                    continue
                for low in d.lower():
                    chars.append(low)
                    align.append(i)
    return "".join(chars), align


class WordPieceTokenizer:
    """The normalizer + pre-tokenizer + WordPiece model above, over one
    vocabulary.  Thread-safe (its only mutable state is a word cache
    guarded by a lock)."""

    _CACHE_MAX = 200_000

    def __init__(self, vocab: dict[str, int], *, lowercase: bool = True, unk_token: str = "[UNK]",
                 prefix: str = CONTINUING_PREFIX, max_chars: int = MAX_INPUT_CHARS_PER_WORD,
                 cls_id: Optional[int] = None, sep_id: Optional[int] = None,
                 added: Optional[dict[str, int]] = None):
        self.vocab = vocab
        self.lowercase = lowercase
        self.prefix = prefix
        self.max_chars = max_chars
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab.get("[CLS]", 1) if cls_id is None else cls_id
        self.sep_id = vocab.get("[SEP]", 2) if sep_id is None else sep_id
        # added tokens (a tokenizer.json's ``added_tokens``): looked up by
        # token_to_id before the vocabulary, as the tokenizers library does
        self.added = dict(added or {})
        self._cache: dict[str, list[tuple[int, int, int]]] = {}
        self._cache_lock = threading.Lock()

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self.added.get(token)
        return self.vocab.get(token) if tid is None else tid

    def normalize(self, text: str) -> tuple[str, list[int]]:
        """(normalized text, original char index of each normalized char)."""
        return bert_normalize(text, self.lowercase)

    @staticmethod
    def pre_tokenize(text: str) -> list[tuple[int, int]]:
        """(start, end) spans of words in the normalized text."""
        spans: list[tuple[int, int]] = []
        start = -1
        for i, c in enumerate(text):
            if c == " ":  # the normalizer mapped all whitespace to spaces
                if start >= 0:
                    spans.append((start, i))
                    start = -1
            elif _is_punctuation(c):
                if start >= 0:
                    spans.append((start, i))
                    start = -1
                spans.append((i, i + 1))
            elif start < 0:
                start = i
        if start >= 0:
            spans.append((start, len(text)))
        return spans

    def word_pieces(self, word: str) -> list[tuple[int, int, int]]:
        """(id, start, end) pieces of one word, ends in word characters."""
        with self._cache_lock:
            hit = self._cache.get(word)
        if hit is not None:
            return hit
        n = len(word)
        vocab = self.vocab
        pieces: list[tuple[int, int, int]] = []
        if n > self.max_chars:
            pieces = [(self.unk_id, 0, n)]
        else:
            start = 0
            while start < n:
                end = n
                found = None
                while start < end:
                    sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                    tid = vocab.get(sub)
                    if tid is not None:
                        found = tid
                        break
                    end -= 1
                if found is None:
                    pieces = [(self.unk_id, 0, n)]
                    break
                pieces.append((found, start, end))
                start = end
        with self._cache_lock:
            if len(self._cache) >= self._CACHE_MAX:
                self._cache.clear()
            self._cache[word] = pieces
        return pieces

    def encode(self, text: str, *, add_special_tokens: bool = True, max_length: Optional[int] = None) -> Encoding:
        norm, align = self.normalize(text)
        ids: list[int] = []
        offsets: list[tuple[int, int]] = []
        for ws, we in self.pre_tokenize(norm):
            for tid, ps, pe in self.word_pieces(norm[ws:we]):
                ids.append(tid)
                offsets.append((align[ws + ps], align[ws + pe - 1] + 1))
        if max_length is not None:
            budget = max(max_length - (2 if add_special_tokens else 0), 0)
            ids, offsets = ids[:budget], offsets[:budget]
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.sep_id]
            offsets = [(0, 0)] + offsets + [(0, 0)]
            special = [1] + [0] * (len(ids) - 2) + [1]
        else:
            special = [0] * len(ids)
        return Encoding(ids, [0] * len(ids), offsets, special)


def _tokenizer_from_json(path: Path):
    """The pipeline of a ``tokenizer.json`` (the tokenizers library's
    serialization), read once without that library: a WordPiece model as
    ``_wordpiece_from_spec``'s pipeline, a BPE or Unigram one as a
    ``tokenizer_json.Pipeline``.  Any other model or component raises
    ValueError naming the file."""
    from .tokenizer_json import Pipeline

    spec = json.loads(path.read_text(encoding="utf-8"))
    try:
        if (spec.get("model") or {}).get("type") == "WordPiece":
            return _wordpiece_from_spec(spec)
        return Pipeline(spec)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def _wordpiece_from_spec(spec: dict) -> WordPieceTokenizer:
    """The BERT WordPiece pipeline of a parsed ``tokenizer.json``: the
    model's vocab, ``unk_token``, ``continuing_subword_prefix`` and
    ``max_input_chars_per_word``, the ``BertNormalizer``'s ``lowercase``
    (accents strip with it), a ``BertPreTokenizer``, and the post
    processor's [CLS] and [SEP] ids.  Any other normalizer or
    pre-tokenizer raises ValueError."""
    model = spec["model"]
    norm = spec.get("normalizer") or {}
    if norm.get("type") != "BertNormalizer" or not norm.get("clean_text", True) or not norm.get(
            "handle_chinese_chars", True):
        raise ValueError(f"normalizer {norm.get('type')!r} is not the BertNormalizer the port implements")
    lowercase = bool(norm.get("lowercase", True))
    if norm.get("strip_accents") not in (None, lowercase):
        raise ValueError(f"strip_accents {norm['strip_accents']} apart from lowercase is not implemented")
    pre = spec.get("pre_tokenizer") or {}
    if pre.get("type") != "BertPreTokenizer":
        raise ValueError(f"pre-tokenizer {pre.get('type')!r} is not BertPreTokenizer")
    from .tokenizer_json import PostProcessor

    post = PostProcessor(spec.get("post_processor"))
    if len(post.pre) != 1 or len(post.suf) != 1 or post.type_id or post.trim is not None:
        raise ValueError(f"a WordPiece post-processor that does not wrap one sequence as [CLS] $A [SEP]")
    cls_id, sep_id = post.pre[0][0], post.suf[0][0]
    added = {t["content"]: int(t["id"]) for t in spec.get("added_tokens") or []}
    return WordPieceTokenizer(
        {str(k): int(v) for k, v in model["vocab"].items()}, lowercase=lowercase,
        unk_token=model.get("unk_token", "[UNK]"), prefix=model.get("continuing_subword_prefix", CONTINUING_PREFIX),
        max_chars=int(model.get("max_input_chars_per_word", MAX_INPUT_CHARS_PER_WORD)),
        cls_id=cls_id, sep_id=sep_id, added=added,
    )


class TextTokenizer:
    """The tokenizer facade the models use: bucketed padding, the special
    wrap, token windows.  ``tokenizer`` is the plain pipeline (a
    WordPieceTokenizer, or a tokenizer.json Pipeline: its ``vocab`` and
    ``token_to_id``); ``engine``, the compiled tokenizer built from it,
    encodes every batch (its first construction in a process builds the
    library; a failed build raises RuntimeError).  Thread-safe."""

    def __init__(self, tokenizer, max_seq_length: int = 512, pad_id: int = 0):
        from ..native.tokenizer import NativeTokenizer

        self.tokenizer = tokenizer
        self.engine = NativeTokenizer(tokenizer)
        self.max_seq_length = max_seq_length
        self.pad_id = pad_id

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_dir(cls, model_dir: str | Path, max_seq_length: int = 512) -> "TextTokenizer":
        """Load from a checkpoint dir: its ``tokenizer.json`` first, as the
        JAX package does (``_tokenizer_from_json``: WordPiece, BPE or
        Unigram; any other model raises ValueError), else its
        ``vocab.txt``."""
        model_dir = Path(model_dir)
        tj = model_dir / "tokenizer.json"
        vocab_file = model_dir / "vocab.txt"
        if tj.exists():
            tok = _tokenizer_from_json(tj)
        elif vocab_file.exists():
            lower = True
            tc = model_dir / "tokenizer_config.json"
            if tc.exists():
                lower = json.loads(tc.read_text()).get("do_lower_case", True)
            vocab = {w: i for i, w in enumerate(vocab_file.read_text().splitlines())}
            tok = WordPieceTokenizer(vocab, lowercase=lower)
        else:
            raise FileNotFoundError(f"no tokenizer.json or vocab.txt in {model_dir}")
        pad_token = None
        for cfg_name in ("tokenizer_config.json", "special_tokens_map.json"):
            cfg_file = model_dir / cfg_name
            if pad_token is None and cfg_file.exists():
                pt = json.loads(cfg_file.read_text()).get("pad_token")
                if isinstance(pt, dict):
                    pt = pt.get("content")
                if isinstance(pt, str):
                    pad_token = pt
        pad_id = None
        for cand in ([pad_token] if pad_token else []) + ["[PAD]", "<pad>"]:
            pad_id = tok.token_to_id(cand)
            if pad_id is not None:
                break
        return cls(tok, max_seq_length=max_seq_length, pad_id=pad_id or 0)

    @classmethod
    def from_vocab(
        cls, vocab: dict[str, int], max_seq_length: int = 512, lowercase: bool = True
    ) -> "TextTokenizer":
        return cls(
            WordPieceTokenizer(vocab, lowercase=lowercase),
            max_seq_length=max_seq_length,
            pad_id=vocab.get("[PAD]", 0),
        )

    # -- encoding ------------------------------------------------------------

    def encode_batch(
        self,
        texts: Sequence[str],
        *,
        pad_to: Optional[int] = None,
        pad_batch_to: Optional[int] = None,
    ) -> TokenBatch:
        """Tokenize + truncate to max_seq_length + pad to a bucket
        (``pad_to`` forces a length, ``pad_batch_to`` a batch size): one
        engine call."""
        enc = self.engine.encode_arrays(list(texts), max_length=self.max_seq_length)
        n_texts = len(enc.splits) - 1
        if pad_batch_to is not None and n_texts > pad_batch_to:
            raise ValueError(f"{n_texts} texts exceed pad_batch_to={pad_batch_to}")
        longest = int(np.diff(enc.splits).max()) if n_texts else 1
        if pad_to is not None and pad_to < longest:
            raise ValueError(f"pad_to={pad_to} is shorter than the longest row ({longest})")
        target = pad_to or bucket_length(longest, self.max_seq_length)
        n = n_texts if pad_batch_to is None else pad_batch_to
        rows, cols = enc.rows_cols()
        keep = cols < target
        rows, cols = rows[keep], cols[keep]
        ids = np.full((n, target), self.pad_id, dtype=np.int32)
        mask = np.zeros((n, target), dtype=np.int32)
        type_ids = np.zeros((n, target), dtype=np.int32)
        ids[rows, cols] = enc.ids[keep]
        mask[rows, cols] = 1
        type_ids[rows, cols] = enc.type_ids[keep]
        return TokenBatch(ids, mask, type_ids)

    def encode_batch_ids(self, texts: Sequence[str], *, pad_batch_to: Optional[int] = None) -> np.ndarray:
        """Padded (N, S) int32 ids only (the mask is ids != pad)."""
        return self.encode_batch(texts, pad_batch_to=pad_batch_to).input_ids

    def _special_wrap(self) -> tuple[list[int], list[int]]:
        """(prefix, suffix) special-token ids around a single sequence, as the
        JAX package finds them: a probe text encoded with and without
        specials, the wrap split around where the bare ids land (else the
        extra ids split in half)."""
        wrap = getattr(self, "_wrap_ids", None)
        if wrap is None:
            wrapped = self.engine.encode("a").ids
            bare = self.engine.encode("a", add_special_tokens=False).ids
            for at in range(len(wrapped) - len(bare) + 1) if bare else ():
                if wrapped[at: at + len(bare)] == bare:
                    wrap = (wrapped[:at], wrapped[at + len(bare):])
                    break
            else:
                ids = [t for t in wrapped if t not in bare]
                half = (len(ids) + 1) // 2
                wrap = (ids[:half], ids[half:])
            self._wrap_ids = wrap
        return wrap

    @property
    def wrap_budget(self) -> int:
        """Content tokens that fit one sequence after the special wrap."""
        pre, suf = self._special_wrap()
        return max(self.max_seq_length - len(pre) - len(suf), 1)

    def pack_token_windows(
        self, windows: Sequence[Sequence[int]], *, pad_batch_to: Optional[int] = None
    ) -> np.ndarray:
        """Token-id windows (no specials) -> padded (N, S) int32 ids with the
        special wrap re-added."""
        pre, suf = self._special_wrap()
        budget = self.wrap_budget
        n = len(windows) if pad_batch_to is None else pad_batch_to
        if pad_batch_to is not None and len(windows) > pad_batch_to:
            raise ValueError(f"{len(windows)} windows exceed pad_batch_to={pad_batch_to}")
        longest = max((min(len(w), budget) for w in windows), default=1) + len(pre) + len(suf)
        target = bucket_length(longest, self.max_seq_length)
        ids = np.full((n, target), self.pad_id, dtype=np.int32)
        for r, w in enumerate(windows):
            seq = pre + list(w[:budget]) + suf
            ids[r, : len(seq)] = seq
        return ids

    def encode_untruncated(self, texts: Sequence[str], *, fast: bool = False) -> list[Encoding]:
        """Full-length encodings with offsets and special-token masks, one
        engine call.  ``fast=True`` is for callers that read only ids and
        the special mask (the ingest chunker): every offset is (0, 0), as
        in the JAX package's ``encode_batch_fast`` route."""
        return self.engine.encode_batch(list(texts), offsets=not fast)

    def encode_token_chunks(self, chunks: Sequence[Sequence[int]]) -> TokenBatch:
        """Pack token-id windows into a padded batch with the special wrap
        re-added, batch size padded to a bucket (highlight path)."""
        pre, suf = self._special_wrap()
        budget = self.wrap_budget
        longest = max((min(len(c), budget) for c in chunks), default=1) + len(pre) + len(suf)
        target = bucket_length(longest, self.max_seq_length)
        from .model import batch_bucket

        n = max(batch_bucket(len(chunks)), len(chunks))
        ids = np.full((n, target), self.pad_id, dtype=np.int32)
        mask = np.zeros((n, target), dtype=np.int32)
        for r, c in enumerate(chunks):
            seq = pre + list(c)[:budget] + suf
            ids[r, : len(seq)] = seq
            mask[r, : len(seq)] = 1
        return TokenBatch(ids, mask, np.zeros_like(ids))


def tiny_test_vocab(words: Sequence[str]) -> dict[str, int]:
    """Deterministic toy vocab: specials + whole words + a-z0-9 single
    chars as subword fallbacks."""
    vocab: dict[str, int] = {"[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "[UNK]": 3, "[MASK]": 4}
    for w in words:
        for piece in (w.lower(),):
            if piece not in vocab:
                vocab[piece] = len(vocab)
    for c in "abcdefghijklmnopqrstuvwxyz0123456789":
        if c not in vocab:
            vocab[c] = len(vocab)
        cont = "##" + c
        if cont not in vocab:
            vocab[cont] = len(vocab)
    return vocab
