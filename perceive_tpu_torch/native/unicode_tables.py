"""The character tables of the compiled tokenizer, generated from Python's
own ``unicodedata``.

``declarations()`` is the header ``tokenizer.cpp`` is compiled with (the
tables' layout, constant); ``definitions()`` is the C++ source of the
tables themselves.  Every class they hold is computed by calling the very
functions the plain (pure-Python) pipelines consult, over every code point,
so the engine and its plain versions classify every character alike on
whichever interpreter runs them:

  * a record of four bytes per code point (two-stage table, blocks of
    ``1 << SHIFT``): the general category, the canonical combining class,
    flag bits (``tokenize._is_control``, ``_is_whitespace``,
    ``_is_punctuation``, ``_is_cjk``; ``tokenizer_json``'s White_Space set,
    the letter and number classes of ``gpt2_split`` and ``_is_word_char``)
    and the grapheme-break class of ``tokenizer_json._gcb`` with three more
    flags (has a lowercase mapping, an NFD one, an NFKD one);
  * each code point's full lowercase mapping as ``str.lower`` gives it, and
    its NFD and NFKD as ``unicodedata.normalize`` gives them (Hangul
    syllables are left to the arithmetic in ``tokenizer.cpp``, checked here
    against ``unicodedata`` for every syllable);
  * the pairs that ``tokenizer_json._compose_pair`` composes: each primary
    composite (a canonical decomposition into two code points that NFC
    gives back), checked with ``unicodedata.normalize``.

``source_texts()`` lists what the tables depend on; the library's hash
takes it in, with ``unicodedata.unidata_version``.
"""

from __future__ import annotations

import functools
import inspect
import os
import unicodedata
from pathlib import Path

import numpy as np

SHIFT = 7  # code points per block of the second stage: 1 << SHIFT

CATEGORIES = ("Cn", "Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No", "Pc", "Pd", "Ps", "Pe",
              "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So", "Zs", "Zl", "Zp", "Cc", "Cf", "Cs", "Co")
# flag bits of the record's third byte
FLAGS = ("CONTROL", "BERT_WS", "PUNCT", "CJK", "WHITE_SPACE", "LETTER", "NUMBER", "WORD")
# grapheme-break classes (the record's fourth byte, low nibble)
GCB = ("Other", "CR", "LF", "Control", "Extend", "ZWJ", "SpacingMark", "RI", "L", "V", "T", "LV", "LVT", "Pict")
# the fourth byte's high nibble
HAS_LOWER, HAS_NFD, HAS_NFKD = 0x10, 0x20, 0x40

S_BASE, L_BASE, V_BASE, T_BASE = 0xAC00, 0x1100, 0x1161, 0x11A7
L_COUNT, V_COUNT, T_COUNT = 19, 21, 28
N_COUNT, S_COUNT = V_COUNT * T_COUNT, 19 * 21 * 28


def _plain():
    """The plain versions' classifiers, which the tables are made of."""
    from ..models import tokenize, tokenizer_json

    return {
        "CONTROL": tokenize._is_control, "BERT_WS": tokenize._is_whitespace, "PUNCT": tokenize._is_punctuation,
        "CJK": tokenize._is_cjk, "WHITE_SPACE": tokenizer_json._WS.__contains__,
        "WORD": tokenizer_json._is_word_char, "gcb": tokenizer_json._gcb, "_compose_pair": tokenizer_json._compose_pair,
    }


def source_texts() -> list[str]:
    """This generator's source and that of every plain classifier it calls."""
    from ..models import tokenize, tokenizer_json

    fns = (tokenize._is_control, tokenize._is_whitespace, tokenize._is_punctuation, tokenize._is_cjk,
           tokenizer_json._gcb, tokenizer_json._is_word_char, tokenizer_json._compose_pair)
    return [Path(__file__).read_text(), repr(tokenizer_json.WHITESPACE)] + [inspect.getsource(f) for f in fns]


def _hangul_nfd(cp: int) -> str:
    s = cp - S_BASE
    t = T_BASE + s % T_COUNT
    return chr(L_BASE + s // N_COUNT) + chr(V_BASE + (s % N_COUNT) // T_COUNT) + (chr(t) if t != T_BASE else "")


def _check_hangul(plain) -> None:
    """The arithmetic that tokenizer.cpp uses for Hangul syllables, against
    unicodedata: every syllable's decomposition, every L V and LV T pair,
    and no other jamo pair composing."""
    for cp in range(S_BASE, S_BASE + S_COUNT):
        c = chr(cp)
        if not unicodedata.normalize("NFD", c) == unicodedata.normalize("NFKD", c) == _hangul_nfd(cp):
            raise RuntimeError(f"Hangul U+{cp:04X} decomposes apart from the arithmetic")
    compose = plain["_compose_pair"]
    for a in range(0x1100, 0x1160):
        for b in range(0x1160, 0x11A8):
            want = (chr(S_BASE + ((a - L_BASE) * V_COUNT + b - V_BASE) * T_COUNT)
                    if a < L_BASE + L_COUNT and V_BASE <= b < V_BASE + V_COUNT else None)
            if compose(chr(a), chr(b)) != want:
                raise RuntimeError(f"U+{a:04X} U+{b:04X} composes apart from the arithmetic")
    for lv in range(S_BASE, S_BASE + S_COUNT, T_COUNT):
        for b in (T_BASE, T_BASE + 1, T_BASE + T_COUNT - 1, T_BASE + T_COUNT):
            want = chr(lv + b - T_BASE) if T_BASE < b < T_BASE + T_COUNT else None
            if compose(chr(lv), chr(b)) != want or compose(chr(lv + 1), chr(b)) is not None:
                raise RuntimeError(f"U+{lv:04X} + U+{b:04X} composes apart from the arithmetic")


MAPPINGS = ("lower", "nfd", "nfkd")


def _mapping(name: str, table: dict) -> str:
    keys = sorted(table)
    offs, pool = [0], []
    for k in keys:
        pool.extend(ord(c) for c in table[k])
        offs.append(len(pool))
    return "\n".join([
        f"extern const uint32_t ut_{name}_n = {len(keys)};",
        f"extern const uint32_t ut_{name}_keys[] = {{{','.join(map(str, keys)) or '0'}}};",
        f"extern const uint32_t ut_{name}_offs[] = {{{','.join(map(str, offs))}}};",
        f"extern const uint32_t ut_{name}_pool[] = {{{','.join(map(str, pool)) or '0'}}};",
    ])


def declarations() -> str:
    """The header ``tokenizer.cpp`` is compiled with: the tables' layout and
    constants, and the tables as extern arrays (``definitions`` holds
    them).  It needs no pass over the code points, so the engine compiles
    while the tables are generated."""
    return "\n".join([
        "// Generated by perceive_tpu_torch/native/unicode_tables.py; do not edit.",
        "#pragma once",
        "#include <cstdint>",
        f"#define UT_SHIFT {SHIFT}",
        *(f"#define UT_CAT_{c} {i}" for i, c in enumerate(CATEGORIES)),
        *(f"#define UT_F_{f} {1 << i}" for i, f in enumerate(FLAGS)),
        *(f"#define UT_G_{g.upper()} {i}" for i, g in enumerate(GCB)),
        f"#define UT_HAS_LOWER {HAS_LOWER}", f"#define UT_HAS_NFD {HAS_NFD}", f"#define UT_HAS_NFKD {HAS_NFKD}",
        "extern const char ut_unidata[];",
        "extern const uint16_t ut_stage1[];",
        "extern const unsigned char ut_stage2[];",
        *(f"extern const uint32_t ut_{m}_n, ut_{m}_keys[], ut_{m}_offs[], ut_{m}_pool[];" for m in MAPPINGS),
        "extern const uint32_t ut_pair_n, ut_pair_vals[];",
        "extern const uint64_t ut_pair_keys[];",
        "",
    ])


def definitions() -> str:
    """The tables, as a C++ source of their own, from one pass of the plain
    classifiers and of unicodedata over every code point."""
    plain = _plain()
    _check_hangul(plain)
    n = 0x110000
    chars = [chr(cp) for cp in range(n)]
    cat = np.frombuffer(bytes(map({c: i for i, c in enumerate(CATEGORIES)}.__getitem__,
                                  map(unicodedata.category, chars))), np.uint8)
    f1 = np.zeros(n, np.uint8)
    for i, name in enumerate(FLAGS):
        if name == "LETTER":
            hit = (cat >= CATEGORIES.index("Lu")) & (cat <= CATEGORIES.index("Lo"))
        elif name == "NUMBER":
            hit = (cat >= CATEGORIES.index("Nd")) & (cat <= CATEGORIES.index("No"))
        else:  # _is_cjk takes a code point, the others a char
            hit = np.frombuffer(bytes(map(plain[name], range(n) if name == "CJK" else chars)), np.uint8) != 0
        f1 |= hit.astype(np.uint8) << i
    f2 = np.frombuffer(bytes(map({g: i for i, g in enumerate(GCB)}.__getitem__, map(plain["gcb"], chars))),
                       np.uint8).copy()
    hangul = range(S_BASE, S_BASE + S_COUNT)
    tables = {}
    for name, fn, bit in (("lower", str.lower, HAS_LOWER),
                          ("nfd", functools.partial(unicodedata.normalize, "NFD"), HAS_NFD),
                          ("nfkd", functools.partial(unicodedata.normalize, "NFKD"), HAS_NFKD)):
        tables[name] = {cp: m for cp, (c, m) in enumerate(zip(chars, map(fn, chars)))
                        if m != c and (name == "lower" or cp not in hangul)}
        f2[list(tables[name])] |= bit
    ccc = np.frombuffer(bytes(map(unicodedata.combining, chars)), np.uint8)
    records = np.stack([cat, ccc, f1, f2], axis=1)

    # a primary composite decomposes canonically into two code points that NFC gives back
    pairs = {}
    for cp in tables["nfd"]:
        d = unicodedata.decomposition(chars[cp]).split()
        if len(d) == 2 and not d[0].startswith("<"):
            a, b = (int(x, 16) for x in d)
            if plain["_compose_pair"](chr(a), chr(b)) == chars[cp]:
                pairs[(a << 32) | b] = cp

    size = 1 << SHIFT
    blocks, stage1 = {}, []
    for at in range(0, n, size):
        stage1.append(blocks.setdefault(records[at: at + size].tobytes(), len(blocks)))
    blob = b"".join(blocks)
    lines = ['"' + "".join("\\x%02x" % b for b in blob[i: i + 64]) + '"' for i in range(0, len(blob), 64)]
    pair_keys = sorted(pairs)
    return "\n".join([
        f"// Generated by perceive_tpu_torch/native/unicode_tables.py from unicodedata "
        f"{unicodedata.unidata_version}; do not edit.",
        "#include <cstdint>",
        f'extern const char ut_unidata[] = "{unicodedata.unidata_version}";',
        f"extern const uint16_t ut_stage1[{len(stage1)}] = {{{','.join(map(str, stage1))}}};",
        "extern const unsigned char ut_stage2[] =",
        *lines,
        ";",
        *(_mapping(name, t) for name, t in tables.items()),
        f"extern const uint32_t ut_pair_n = {len(pair_keys)};",
        f"extern const uint64_t ut_pair_keys[] = {{{','.join(f'{k}ull' for k in pair_keys)}}};",
        f"extern const uint32_t ut_pair_vals[] = {{{','.join(str(pairs[k]) for k in pair_keys)}}};",
        "",
    ])


def write(path: Path, text: str) -> None:
    """``text`` at ``path``, written under a temporary name and moved into
    place."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)
