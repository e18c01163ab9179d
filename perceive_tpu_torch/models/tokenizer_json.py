"""The byte-level BPE and Unigram pipelines of a ``tokenizer.json``, read
without the ``tokenizers`` library (and without ``regex``).

``tokenizer.json`` is the serialization of the ``tokenizers`` library.  The
RoBERTa family ships a byte-level BPE in it, ALBERT a SentencePiece
Unigram; WordPiece files are read by ``tokenize._wordpiece_from_spec``.
``pipeline_from_json`` builds a ``Pipeline`` whose ``encode`` gives the
library's ids, type ids, special-token masks and character offsets into
the original text, token for token:

  * added tokens split out of the raw text (those marked ``normalized``
    out of each normalized piece), leftmost-longest, with their
    ``single_word``, ``lstrip`` and ``rstrip`` rules;
  * normalizers: ``Sequence``, ``Replace`` (a string pattern), ``NFD``,
    ``NFKD``, ``NFC``, ``NFKC``, ``StripAccents``, ``Lowercase``,
    ``BertNormalizer`` and ``Precompiled`` (SentencePiece's darts-clone
    character map);
  * pre-tokenizers: ``ByteLevel`` (the GPT-2 split and the byte-to-unicode
    map), ``WhitespaceSplit``, ``Metaspace`` and ``Sequence``;
  * models: ``BPE`` (merges by rank) and ``Unigram`` (the Viterbi best
    path, unknowns fused);
  * post-processors: ``RobertaProcessing`` (with its offset trim),
    ``BertProcessing`` and ``TemplateProcessing``.

Any other component raises ValueError naming it.

The pipeline is the plain version of the compiled tokenizer
(``native.tokenizer``), which ``TextTokenizer`` encodes with: each
component carries a ``native`` descriptor (its kind and parameters) that
the engine is built from, so this module parses ``tokenizer.json`` for
both.

A piece of text under normalization is a string and, for each of its
characters, the index of the original character it came from; every
transformation assigns those indices the way the library's
``NormalizedString.transform`` does (positionally), so a token's offsets
are the range from its first character's original index to its last's.

Known divergence: character classes come from Python's ``unicodedata``
(Unicode 15.0 in Python 3.12); the library's tables may be newer, so a
character assigned after Unicode 15.0 may split or normalize differently.
"""

from __future__ import annotations

import base64
import functools
import json
import re
import struct
import threading
import unicodedata
from pathlib import Path
from typing import Callable, Optional

from .tokenize import Encoding, bert_normalize

# the White_Space property: Rust's char::is_whitespace and Oniguruma's \s
WHITESPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680" + "".join(map(chr, range(0x2000, 0x200B)))
              + "\u2028\u2029\u202f\u205f\u3000")
_WS = frozenset(WHITESPACE)
_CACHE_MAX = 200_000

# A normalized piece: (text, original index of each char; -1 is an empty range at 0)
Piece = tuple[str, list]


def _unsupported(what: str) -> ValueError:
    return ValueError(f"tokenizer.json: {what} is not supported by the port")


def _described(fn: Callable, *native) -> Callable:
    """``fn`` with ``native``: the component's kind and parameters, which
    ``native.tokenizer`` serializes into the compiled engine."""
    fn.native = native
    return fn


def transform(text: str, align: list, dest, initial_offset: int = 0) -> Piece:
    """The library's ``NormalizedString.transform``: ``dest`` yields (char,
    change) pairs; change 0 replaces the next original char, 1 inserts a
    char (aligned as the one before it), -n replaces one and removes n."""
    chars, out = [], []
    pos = initial_offset
    for c, change in dest:
        if change > 0:
            out.append(align[pos - 1] if pos >= 1 else -1)
        else:
            out.append(align[pos])
            pos += 1 - change
        chars.append(c)
    return "".join(chars), out


def _span(align: list, start: int, end: int) -> tuple[int, int]:
    """Original (start, end) of normalized chars [start, end)."""
    if start >= end:
        return (0, 0)
    a, b = align[start], align[end - 1]
    return (max(a, 0), b + 1 if b >= 0 else 0)


# -- normalizers -----------------------------------------------------------------


def _decomposed(text: str, form: str) -> list:
    """(char, change) pairs of NFD / NFKD as the library aligns them: each
    char's decomposition (its first char 0, the rest inserted), then the
    canonical reordering of each run of non-starters, the changes moving
    with their chars."""
    seq: list = []
    run = 0  # start of the current segment (a starter and its marks)
    for c in text:
        for i, d in enumerate(unicodedata.normalize(form, c)):
            if unicodedata.combining(d) == 0:
                seq[run:] = sorted(seq[run:], key=lambda x: unicodedata.combining(x[0]))
                run = len(seq)
            seq.append((d, 1 if i else 0))
    seq[run:] = sorted(seq[run:], key=lambda x: unicodedata.combining(x[0]))
    return seq


def _compose_pair(a: str, b: str) -> Optional[str]:
    c = unicodedata.normalize("NFC", a + b)
    return c if len(c) == 1 else None


def _recompose(seq: list) -> list:
    """The canonical composition of unicode-normalization's Recompositions
    over (char, change) pairs: a composed char's change absorbs its mark's."""
    out, buffer = [], []
    composee, last_ccc = None, None
    for ch, change in seq:
        cc = unicodedata.combining(ch)
        if composee is None:
            if cc != 0:
                out.append((ch, change))
                continue
            composee = (ch, change)
            continue
        k, ck = composee
        if last_ccc is not None and last_ccc >= cc:  # blocked
            if cc == 0:
                out.append(composee)
                out.extend(buffer)
                buffer, composee, last_ccc = [], (ch, change), None
                continue
            buffer.append((ch, change))
            last_ccc = cc
            continue
        r = _compose_pair(k, ch)
        if r is not None:
            composee = (r, ck + change - 1)
            continue
        if cc == 0 and last_ccc is None:
            out.append(composee)
            composee = (ch, change)
            continue
        buffer.append((ch, change))
        last_ccc = cc
    if composee is not None:
        out.append(composee)
    return out + buffer


def _normalization(form: str) -> Callable:
    decompose = {"NFD": "NFD", "NFKD": "NFKD", "NFC": "NFD", "NFKC": "NFKD"}[form]

    def run(p: Piece) -> Piece:
        text, align = p
        if text.isascii():
            return p
        seq = _decomposed(text, decompose)
        return transform(text, align, seq if form == decompose else _recompose(seq))

    return _described(run, form)


def _filter(p: Piece, keep: Callable) -> Piece:
    """The library's ``filter``: a removed char is folded into the kept
    char before it (or skipped at the start)."""
    text, align = p
    dest, removed, first_removed, last = [], 0, 0, None
    for c in text:
        if keep(c):
            if last is None:
                first_removed = removed
            else:
                dest.append((last, -removed))
            last, removed = c, 0
        else:
            removed += 1
    if last is not None:
        dest.append((last, -removed))
    return transform(text, align, dest, first_removed)


def _strip_accents(p: Piece) -> Piece:
    if p[0].isascii():
        return p
    return _filter(p, lambda c: unicodedata.category(c)[0] != "M")


_described(_strip_accents, "StripAccents")


def _lowercase(p: Piece) -> Piece:
    text, align = p
    if text.isascii():
        return text.lower(), align
    return transform(text, align, ((low, 1 if i else 0) for c in text for i, low in enumerate(c.lower())))


_described(_lowercase, "Lowercase")


def _replace_matches(text: str, align: list, spans, content: str) -> Piece:
    """Each [start, end) span replaced by ``content``, its chars inserted
    after the span (aligned as its last char)."""
    chars, out, last = [], [], 0
    for s, e in spans:
        chars.append(text[last:s])
        out.extend(align[last:s])
        chars.append(content)
        out.extend([align[e - 1]] * len(content))
        last = e
    chars.append(text[last:])
    out.extend(align[last:])
    return "".join(chars), out


def _replace(pattern: dict, content: str) -> Callable:
    if "String" not in pattern:
        raise _unsupported(f"a Replace normalizer with the pattern {pattern}")
    needle = pattern["String"]

    def run(p: Piece) -> Piece:
        text, spans = p[0], []
        at = text.find(needle) if needle else -1
        while at >= 0:
            spans.append((at, at + len(needle)))
            at = text.find(needle, at + len(needle))
        return _replace_matches(text, p[1], spans, content) if spans else p

    return _described(run, "Replace", needle, content)


def _prepend(p: Piece, prefix: str) -> Piece:
    """The library's ``prepend``: ``prefix`` aligned as the first char."""
    text, align = p
    if not text:
        return p
    dest = [(c, 1 if i else 0) for i, c in enumerate(prefix)] + [(text[0], 1)]
    head = transform(text[:1], align[:1], dest)
    return head[0] + text[1:], head[1] + align[1:]


# -- Precompiled: SentencePiece's character map -------------------------------------

# prepended concatenation marks: format chars that are not Control
_PREPEND = frozenset("\u0600\u0601\u0602\u0603\u0604\u0605\u06dd\u070f\u08e2\U000110bd\U000110cd")


def _gcb(c: str) -> str:
    """A grapheme-cluster-break class, as far as the character maps need:
    CR, LF, Control, Extend, ZWJ, SpacingMark, Regional, Hangul L/V/T/LV/LVT,
    Pictographic, or Other."""
    cp = ord(c)
    if c == "\r":
        return "CR"
    if c == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me") or cp == 0x200C or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F:
        return "Extend"
    if cat == "Mc":
        return "SpacingMark"
    if cat in ("Cc", "Zl", "Zp") or (cat == "Cf" and c not in _PREPEND):
        return "Control"
    if cat == "So" and (0x1F000 <= cp <= 0x1FAFF or 0x2600 <= cp <= 0x27BF) or cp in (0xA9, 0xAE):
        return "Pict"
    return "Other"


def graphemes(text: str) -> list[str]:
    """Extended grapheme clusters (UAX #29) of ``text``: CR LF, controls,
    marks, ZWJ emoji sequences, regional-indicator pairs and Hangul
    syllable sequences; the Prepend and Indic conjunct rules are left out."""
    out: list[str] = []
    if not text:
        return out
    start, prev = 0, _gcb(text[0])
    ri_run = 1 if prev == "RI" else 0
    pict_zwj = prev == "Pict"  # inside Pict Extend* (ZWJ)?
    for i in range(1, len(text)):
        cur = _gcb(text[i])
        if prev == "CR" and cur == "LF":
            join = True
        elif prev in ("CR", "LF", "Control") or cur in ("CR", "LF", "Control"):
            join = False
        elif prev == "L" and cur in ("L", "V", "LV", "LVT") or prev in ("LV", "V") and cur in ("V", "T") \
                or prev in ("LVT", "T") and cur == "T":
            join = True
        elif cur in ("Extend", "ZWJ", "SpacingMark"):
            join = True
        elif prev == "ZWJ" and cur == "Pict" and pict_zwj:
            join = True
        elif prev == "RI" and cur == "RI":
            join = ri_run % 2 == 1
        else:
            join = False
        if not join:
            out.append(text[start:i])
            start = i
        ri_run = ri_run + 1 if cur == "RI" else 0
        if cur == "Pict":
            pict_zwj = True
        elif cur not in ("Extend", "ZWJ"):
            pict_zwj = False
        prev = cur
    out.append(text[start:])
    return out


class CharsMap:
    """A ``precompiled_charsmap``: a little-endian u32 trie size, a
    darts-clone double array of that many bytes, then the NUL-separated
    replacement strings.  ``transform`` gives the replacement of a chunk's
    SHORTEST key prefix, as the library does."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.normalized = blob[4 + size:]
        self._memo: dict[str, Optional[str]] = {}

    def _prefix_value(self, key: bytes) -> Optional[int]:
        units = self.units
        u = units[0]
        pos = (u >> 10) << ((u & (1 << 9)) >> 6)
        for c in key:
            if c == 0:
                return None
            pos ^= c
            if pos >= len(units):
                return None
            u = units[pos]
            if (u & ((1 << 31) | 0xFF)) != c:
                return None
            pos ^= (u >> 10) << ((u & (1 << 9)) >> 6)
            if (u >> 8) & 1:
                return units[pos] & ((1 << 31) - 1)
        return None

    def transform(self, chunk: str) -> Optional[str]:
        hit = self._memo.get(chunk, False)
        if hit is not False:
            return hit
        at = self._prefix_value(chunk.encode("utf-8"))
        if at is None:
            out = None
        else:
            end = self.normalized.find(b"\0", at)
            out = self.normalized[at: end if end >= 0 else len(self.normalized)].decode("utf-8")
        if len(self._memo) < _CACHE_MAX:
            self._memo[chunk] = out
        return out

    def __call__(self, p: Piece) -> Piece:
        text, align = p
        dest: list = []
        modified = False

        def replace(old: str, new: str) -> None:
            dest.extend((c, 0) for c in new)
            diff = len(new) - len(old)
            if diff > 0:
                for j in range(len(dest) - diff, len(dest)):
                    dest[j] = (dest[j][0], 1)
            elif diff < 0 and dest:
                dest[-1] = (dest[-1][0], dest[-1][1] + diff)

        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    modified = True
                    replace(g, norm)
                    continue
            for c in g:
                norm = self.transform(c)
                if norm is not None:
                    modified = True
                    replace(c, norm)
                else:
                    dest.append((c, 0))
        return transform(text, align, dest) if modified else p


def _normalizer(spec: Optional[dict]) -> Optional[Callable]:
    if not spec:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [s for s in (_normalizer(n) for n in spec.get("normalizers") or []) if s is not None]

        def run(p: Piece) -> Piece:
            for s in steps:
                p = s(p)
            return p

        return _described(run, "Sequence", steps)
    if kind in ("NFD", "NFKD", "NFC", "NFKC"):
        return _normalization(kind)
    if kind == "StripAccents":
        return _strip_accents
    if kind == "Lowercase":
        return _lowercase
    if kind == "Replace":
        return _replace(spec["pattern"], spec["content"])
    if kind == "Precompiled":
        return CharsMap(base64.b64decode(spec["precompiled_charsmap"]))
    if kind == "BertNormalizer":
        lowercase = bool(spec.get("lowercase", True))
        if not spec.get("clean_text", True) or not spec.get("handle_chinese_chars", True) or spec.get(
                "strip_accents") not in (None, lowercase):
            raise _unsupported("a BertNormalizer without clean_text and Chinese chars, or with strip_accents "
                               "apart from lowercase")

        def bert(p: Piece) -> Piece:
            text, local = bert_normalize(p[0], lowercase)
            return text, [p[1][i] for i in local]

        return _described(bert, "BertNormalizer", lowercase)
    raise _unsupported(f"the normalizer {kind!r}")


# -- pre-tokenizers -----------------------------------------------------------------


def _bytes_to_unicode() -> dict:
    """GPT-2's map of the 256 bytes to printable chars."""
    keep = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    out, n = {}, 0
    for b in range(256):
        if b in keep:
            out[b] = chr(b)
        else:
            out[b] = chr(256 + n)
            n += 1
    return out


BYTES_CHAR = _bytes_to_unicode()
_ASCII_BYTES = str.maketrans({chr(b): BYTES_CHAR[b] for b in range(128)})

def _ranges(pred) -> str:
    """A regex character class body for the code points where ``pred``."""
    out, start = [], None
    for cp in range(0x110000):
        hit = pred(cp)
        if hit and start is None:
            start = cp
        elif not hit and start is not None:
            out.append((start, cp - 1))
            start = None
    if start is not None:
        out.append((start, 0x10FFFF))
    return "".join(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}" for a, b in out)


@functools.lru_cache(maxsize=None)
def gpt2_split() -> re.Pattern:
    """GPT-2's pre-tokenizing pattern ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+|
    ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, with the letter and
    number classes spelled out from unicodedata and \\s as White_Space;
    built at its first use."""
    cats = [unicodedata.category(chr(cp))[0] for cp in range(0x110000)]
    letters = _ranges(lambda cp: cats[cp] == "L")
    numbers = _ranges(lambda cp: cats[cp] == "N")
    ws = "".join(re.escape(c) for c in WHITESPACE)
    return re.compile(f"'s|'t|'re|'ve|'m|'ll|'d| ?[{letters}]+| ?[{numbers}]+| ?[^{ws}{letters}{numbers}]+"
                      f"|[{ws}]+(?![^{ws}])|[{ws}]+")


def _byte_level(add_prefix_space: bool, use_regex: bool) -> Callable:
    def run(p: Piece) -> list:
        if add_prefix_space and not p[0].startswith(" "):
            p = _prepend(p, " ")
        text, align = p
        spans = [m.span() for m in gpt2_split().finditer(text)] if use_regex else [(0, len(text))]
        out = []
        for s, e in spans:
            word, wal = text[s:e], align[s:e]
            if word.isascii():
                out.append((word.translate(_ASCII_BYTES), wal))
                continue
            chars, al = [], []
            for c, a in zip(word, wal):
                for b in c.encode("utf-8"):
                    chars.append(BYTES_CHAR[b])
                    al.append(a)
            out.append(("".join(chars), al))
        return out

    return _described(run, "ByteLevel", add_prefix_space, use_regex)


def _whitespace_split(p: Piece) -> list:
    text, align = p
    out, start = [], None
    for i, c in enumerate(text):
        if c in _WS:
            if start is not None:
                out.append((text[start:i], align[start:i]))
                start = None
        elif start is None:
            start = i
    if start is not None:
        out.append((text[start:], align[start:]))
    return out


_described(_whitespace_split, "WhitespaceSplit")


def _metaspace(spec: dict) -> Callable:
    replacement = spec.get("replacement", "▁")
    legacy = spec.get("add_prefix_space")
    scheme = spec.get("prepend_scheme") or ("never" if legacy is False else "always")
    if legacy is not None and (legacy is False) != (scheme == "never"):
        raise ValueError("tokenizer.json: Metaspace's add_prefix_space does not match its prepend_scheme")
    if scheme not in ("always", "first", "never"):
        raise _unsupported(f"Metaspace's prepend_scheme {scheme!r}")
    split = spec.get("split", True)

    def run(p: Piece) -> list:
        text, align = p
        if " " in text:
            text, align = _replace_matches(text, align, [(i, i + 1) for i, c in enumerate(text) if c == " "],
                                           replacement)
        if not text.startswith(replacement) and (scheme == "always" or scheme == "first" and align and align[0] <= 0):
            text, align = _prepend((text, align), replacement)
        if not split:
            return [(text, align)]
        # each replacement char starts a piece (merged with the chars after it)
        cuts = [0] + [i for i in range(1, len(text)) if text[i] == replacement] + [len(text)]
        return [(text[a:b], align[a:b]) for a, b in zip(cuts, cuts[1:])]

    return _described(run, "Metaspace", replacement, scheme, split)


def _pre_tokenizer(spec: Optional[dict]) -> Optional[Callable]:
    if not spec:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [s for s in (_pre_tokenizer(n) for n in spec.get("pretokenizers") or []) if s is not None]

        def run(p: Piece) -> list:
            pieces = [p]
            for s in steps:
                pieces = [q for piece in pieces for q in s(piece) if q[0]]
            return pieces

        return _described(run, "Sequence", steps)
    if kind == "ByteLevel":
        return _byte_level(bool(spec.get("add_prefix_space", True)), bool(spec.get("use_regex", True)))
    if kind == "WhitespaceSplit":
        return _whitespace_split
    if kind == "Metaspace":
        return _metaspace(spec)
    raise _unsupported(f"the pre-tokenizer {kind!r}" + (" (a regex split)" if kind == "Split" else ""))


# -- models ---------------------------------------------------------------------


class _Cache:
    """A bounded word cache under a lock (cleared when full)."""

    def __init__(self):
        self._d: dict = {}
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            return self._d.get(key)

    def put(self, key, value) -> None:
        with self._lock:
            if len(self._d) >= _CACHE_MAX:
                self._d.clear()
            self._d[key] = value


class BPE:
    """Byte-pair encoding: a word's symbols merged pair by pair, the
    lowest-ranked pair first (the leftmost among equals)."""

    def __init__(self, spec: dict):
        if spec.get("dropout") not in (None, 0, 0.0):
            raise _unsupported(f"BPE dropout {spec['dropout']}")
        if spec.get("byte_fallback"):
            raise _unsupported("BPE byte_fallback")
        self.vocab = {str(k): int(v) for k, v in spec["vocab"].items()}
        self.vocab_r = {v: k for k, v in self.vocab.items()}
        self.unk_token = spec.get("unk_token")
        self.unk_id = None if self.unk_token is None else self.vocab.get(self.unk_token)
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: dict = {}
        for rank, m in enumerate(spec.get("merges") or []):
            a, b = m.split(" ") if isinstance(m, str) else m
            try:
                key = (self.vocab[a], self.vocab[b])
                self.merges[key] = (rank, self.vocab[a + b[len(self.prefix):]])
            except KeyError as e:
                raise ValueError(f"tokenizer.json: the merge {a!r} {b!r} names {e} outside the vocabulary") from None
        self._cache = _Cache()

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def tokenize(self, word: str) -> list:
        """(id, start, end) of each token of ``word``, in its chars."""
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [(self.vocab[word], 0, len(word))]
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        syms: list = []
        unk = None
        n = len(word)
        for i, c in enumerate(word):
            s = (self.prefix + c if i and self.prefix else c) + (self.suffix if i == n - 1 else "")
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append((tid, i, i + 1))
            elif self.unk_token is not None:
                if self.unk_id is None:
                    raise ValueError(f"tokenizer.json: the unk_token {self.unk_token!r} is not in the vocabulary")
                if unk is not None and self.fuse_unk:
                    unk = (self.unk_id, unk[1], i + 1)
                else:
                    if unk is not None:
                        syms.append(unk)
                    unk = (self.unk_id, i, i + 1)
        if unk is not None:
            syms.append(unk)
        merges = self.merges
        while len(syms) > 1:
            best = None
            for j in range(len(syms) - 1):
                m = merges.get((syms[j][0], syms[j + 1][0]))
                if m is not None and (best is None or m[0] < best[0]):
                    best = (m[0], j, m[1])
            if best is None:
                break
            _, j, new_id = best
            syms[j: j + 2] = [(new_id, syms[j][1], syms[j + 1][2])]
        self._cache.put(word, syms)
        return syms

    def value(self, word: str, tid: int, start: int, end: int) -> str:
        """A token's string, as the library's Token.value holds it."""
        return self.vocab_r[tid]


class Unigram:
    """SentencePiece's unigram model: the best-scoring segmentation, a char
    with no piece of its own scored as unknown (the lowest score less 10),
    consecutive unknowns fused into one token."""

    UNK_PENALTY = 10.0

    def __init__(self, spec: dict):
        if spec.get("byte_fallback"):
            raise _unsupported("Unigram byte_fallback")
        self.pieces = [(str(p), float(s)) for p, s in spec["vocab"]]
        self.vocab = {p: i for i, (p, _) in enumerate(self.pieces)}  # a repeated piece: its last id
        self.scored = {p: (i, self.pieces[i][1]) for p, i in self.vocab.items() if p}
        self.unk_id = spec.get("unk_id")
        self.min_score = min((s for _, s in self.pieces), default=0.0)
        self.max_len = max((len(p) for p in self.scored), default=1)
        self._cache = _Cache()

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def value(self, word: str, tid: int, start: int, end: int) -> str:
        return word[start:end]

    def tokenize(self, word: str) -> list:
        if not word:
            return []
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        n = len(word)
        score = [0.0] * (n + 1)
        back: list = [None] * (n + 1)  # (start, id) of the best path's last token ending here
        unk_score = self.min_score - self.UNK_PENALTY
        scored, max_len = self.scored, self.max_len
        for s in range(n):
            base = score[s]
            single = False
            for e in range(s + 1, min(n, s + max_len) + 1):
                hit = scored.get(word[s:e])
                if hit is None:
                    continue
                cand = hit[1] + base
                if back[e] is None or cand > score[e]:
                    score[e], back[e] = cand, (s, hit[0])
                if e == s + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError("tokenizer.json: a Unigram model with no unk_id met an unknown char")
                cand = unk_score + base
                if back[s + 1] is None or cand > score[s + 1]:
                    score[s + 1], back[s + 1] = cand, (s, self.unk_id)
        spans: list = []  # (start, end) of each token, from the end
        fused = None
        e = n
        while e > 0:
            s, tid = back[e]
            if tid == self.unk_id:
                fused = (s, fused[1] if fused else e)
            else:
                if fused:
                    spans.append(fused)
                    fused = None
                spans.append((s, e))
            e = s
        if fused:
            spans.append(fused)
        out = []
        for s, e in reversed(spans):
            tid = self.vocab.get(word[s:e])
            out.append((self.unk_id if tid is None else tid, s, e))
        self._cache.put(word, out)
        return out


def _model(spec: dict):
    kind = spec.get("type")
    if kind == "BPE" or kind is None and "merges" in spec:
        return BPE(spec)
    if kind == "Unigram":
        return Unigram(spec)
    raise _unsupported(f"the {kind or 'untyped'} model")


# -- post-processors ------------------------------------------------------------------


def _trim(tokens: list, add_prefix_space: bool) -> None:
    """RoBERTa's ``trim_offsets`` (the library's ByteLevel one): a token's leading and trailing spaces
    (as the byte-level space or whitespace) leave its offsets, except one
    leading space the pre-tokenizer added before the first token."""
    space = BYTES_CHAR[ord(" ")]
    for i, t in enumerate(tokens):
        s, e = t[2]
        text = t[1]
        lead = len(text) - len(text.lstrip(space + WHITESPACE))
        trail = len(text) - len(text.rstrip(space + WHITESPACE))
        if lead and (i == 0 or s == 0) and add_prefix_space and lead == 1:
            lead = 0
        if lead:
            s = min(s + lead, e)
        if trail and e >= trail:
            e = max(e - trail, s)
        t[2] = (s, e)


class PostProcessor:
    """A post-processor's special tokens around one sequence (``pre``,
    ``suf``: (id, type id) each), the type id of its tokens, and RoBERTa's
    offset trim (``trim``: its add_prefix_space; None without a trim)."""

    def __init__(self, spec: Optional[dict]):
        self.pre: list = []
        self.suf: list = []
        self.type_id = 0
        self.trim: Optional[bool] = None
        kind = (spec or {}).get("type")
        if kind is None:
            return
        if kind in ("RobertaProcessing", "BertProcessing"):
            if kind == "RobertaProcessing" and spec.get("trim_offsets", True):
                self.trim = bool(spec.get("add_prefix_space", True))
            self.pre, self.suf = [(int(spec["cls"][1]), 0)], [(int(spec["sep"][1]), 0)]
        elif kind == "TemplateProcessing":
            pre, suf, seen = [], [], False
            for piece in spec.get("single") or []:
                if "Sequence" in piece:
                    if piece["Sequence"].get("id", "A") != "A" or seen:
                        raise _unsupported("a single-sequence template with a second sequence")
                    seen, self.type_id = True, int(piece["Sequence"].get("type_id", 0))
                    continue
                tok = piece["SpecialToken"]
                ids = spec["special_tokens"][tok["id"]]["ids"]
                (suf if seen else pre).extend((int(i), int(tok.get("type_id", 0))) for i in ids)
            self.pre, self.suf = pre, suf
        else:
            raise _unsupported(f"the post-processor {kind!r}")

    @property
    def n_added(self) -> int:
        return len(self.pre) + len(self.suf)


# -- the pipeline ----------------------------------------------------------------------


class _Added:
    """An added token: its id and matching rules."""

    __slots__ = ("content", "id", "single_word", "lstrip", "rstrip", "normalized")

    def __init__(self, spec: dict):
        self.content, self.id = spec["content"], int(spec["id"])
        self.normalized = bool(spec.get("normalized", not spec.get("special", False)))
        self.single_word = bool(spec.get("single_word"))
        self.lstrip, self.rstrip = bool(spec.get("lstrip")), bool(spec.get("rstrip"))


def _is_word_char(c: str) -> bool:
    cat = unicodedata.category(c)
    return cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or c in "\u200c\u200d"


def _find_added(text: str, patterns: list) -> list:
    """The library's ``find_matches``: (token or None, start, end) pieces
    covering ``text``, added tokens matched leftmost-longest."""
    if not text or not patterns:
        return [(None, 0, len(text))]
    out: list = []
    start_offset = pos = 0
    while True:
        best = None
        for pat, tok in patterns:
            at = text.find(pat, pos)
            if at >= 0 and (best is None or at < best[0] or at == best[0] and len(pat) > len(best[1])):
                best = (at, pat, tok)
        if best is None:
            break
        start, pat, tok = best
        stop = pos = start + len(pat)
        if tok.single_word and ((start > 0 and _is_word_char(text[start - 1]))
                                or (stop < len(text) and _is_word_char(text[stop]))):
            continue
        if tok.lstrip:
            start = max(len(text[:start].rstrip(WHITESPACE)), start_offset)
        if tok.rstrip:
            stop += len(text[stop:]) - len(text[stop:].lstrip(WHITESPACE))
        if start_offset < start:
            out.append((None, start_offset, start))
        out.append((tok, start, stop))
        start_offset = stop
    if start_offset != len(text):
        out.append((None, start_offset, len(text)))
    return out


class Pipeline:
    """A ``tokenizer.json``'s normalizer, pre-tokenizer, model,
    post-processor and added tokens.  Thread-safe (the models' word caches
    are locked)."""

    def __init__(self, spec: dict):
        self.model = _model(spec.get("model") or {})
        self.normalizer = _normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.post = PostProcessor(spec.get("post_processor"))
        self.vocab = self.model.vocab
        added = [_Added(t) for t in spec.get("added_tokens") or []]
        self.added = {t.content: t.id for t in added}
        self._raw = [(t.content, t) for t in added if t.content and not t.normalized]
        self._normalized = []  # matched in the normalized text, as normalized
        for t in added:
            if t.content and t.normalized:
                pat = self._normalize((t.content, list(range(len(t.content)))))[0]
                if pat:
                    self._normalized.append((pat, t))

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self.added.get(token)
        return self.model.token_to_id(token) if tid is None else tid

    def _normalize(self, p: Piece) -> Piece:
        return self.normalizer(p) if self.normalizer else p

    def _tokens(self, text: str) -> list:
        """[id, token string, (start, end) in the original text] of each
        token, before truncation and the special wrap."""
        tokens: list = []

        def model_tokens(p: Piece) -> None:
            for word, al in (self.pre_tokenizer(p) if self.pre_tokenizer else [p]):
                if not word:
                    continue
                for tid, s, e in self.model.tokenize(word):
                    tokens.append([tid, self.model.value(word, tid, s, e), _span(al, s, e)])

        align = list(range(len(text)))
        for tok, s, e in _find_added(text, self._raw):
            if tok is not None:
                tokens.append([tok.id, text[s:e], (s, e)])
                continue
            if s == e:
                continue
            norm, nal = self._normalize((text[s:e], align[s:e]))
            for ntok, ns, ne in _find_added(norm, self._normalized):
                if ntok is not None:
                    tokens.append([ntok.id, norm[ns:ne], _span(nal, ns, ne)])
                elif ns < ne:
                    model_tokens((norm[ns:ne], nal[ns:ne]))
        return tokens

    def encode(self, text: str, *, add_special_tokens: bool = True, max_length: Optional[int] = None) -> Encoding:
        tokens = self._tokens(text)
        if max_length is not None:
            budget = max_length - self.post.n_added if add_special_tokens and self.post.n_added else max_length
            del tokens[max(budget, 0):]
        if self.post.trim is not None:
            _trim(tokens, self.post.trim)
        ids = [t[0] for t in tokens]
        offsets = [t[2] for t in tokens]
        n = len(ids)
        type_ids = [self.post.type_id] * n
        special = [0] * n
        if add_special_tokens:
            pre, suf = self.post.pre, self.post.suf
            ids = [i for i, _ in pre] + ids + [i for i, _ in suf]
            type_ids = [t for _, t in pre] + type_ids + [t for _, t in suf]
            offsets = [(0, 0)] * len(pre) + offsets + [(0, 0)] * len(suf)
            special = [1] * len(pre) + special + [1] * len(suf)
        return Encoding(ids, type_ids, offsets, special)


def pipeline_from_json(path: Path) -> Pipeline:
    """The pipeline of a BPE or Unigram ``tokenizer.json``; other models and
    components raise ValueError."""
    try:
        return Pipeline(json.loads(Path(path).read_text(encoding="utf-8")))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
