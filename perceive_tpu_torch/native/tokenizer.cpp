// The compiled tokenizer: the WordPiece, byte-level BPE and Unigram
// pipelines of perceive_tpu_torch/models/tokenize.py and tokenizer_json.py
// (their plain versions), step for step, over UTF-32 text.
//
// Built by native/tokenizer.py with g++, beside the character tables that
// native/unicode_tables.py generates from Python's unicodedata (their
// declarations are force-included: -include <header>).  The Python side serializes the tables the
// plain pipeline object has already parsed (tk_new); each batch is one call
// (tk_encode) that runs without the interpreter lock, split over a few
// threads by contiguous runs of texts.  A text's encoding does not depend
// on the thread that made it: the word caches are per thread and per call,
// and the engine's tables are immutable after tk_new.
//
// Offsets are code-point indices of the original text, as the plain
// versions give them.  A step whose plain version raises (a lone surrogate
// met by a UTF-8 encoder, an unknown char with no unk token, an index past
// a malformed charsmap) fails that text with an error kind; the caller
// raises the same exception.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <new>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

typedef std::u32string U32;
typedef std::u32string_view View;

enum ErrKind { E_OK = 0, E_UNK_MISSING = 1, E_NO_UNK_ID = 2, E_SURROGATE = 3, E_INDEX = 4, E_DECODE = 5,
               E_INTERNAL = 6 };

struct Fail {
    int kind;
};

// -- character classes (tables generated from unicodedata) ---------------------

inline const unsigned char* rec(uint32_t cp) {
    if (cp > 0x10FFFF) cp = 0xFFFF;  // never a Python code point; a noncharacter's record
    size_t block = ut_stage1[cp >> UT_SHIFT];
    return ut_stage2 + ((block << UT_SHIFT) + (cp & ((1u << UT_SHIFT) - 1))) * 4;
}
inline int cat_of(uint32_t cp) { return rec(cp)[0]; }
inline int ccc_of(uint32_t cp) { return rec(cp)[1]; }
inline bool has(uint32_t cp, int flag) { return (rec(cp)[2] & flag) != 0; }
inline int gcb_of(uint32_t cp) { return rec(cp)[3] & 15; }
inline bool is_mark(uint32_t cp) {
    int c = cat_of(cp);
    return c == UT_CAT_Mn || c == UT_CAT_Mc || c == UT_CAT_Me;
}
inline bool is_surrogate(uint32_t cp) { return cp >= 0xD800 && cp <= 0xDFFF; }

struct Mapping {
    uint32_t n;
    const uint32_t* keys;
    const uint32_t* offs;
    const uint32_t* pool;

    // appends the mapping of cp to out; false where cp maps to itself
    bool append(uint32_t cp, std::vector<uint32_t>& out) const {
        const uint32_t* it = std::lower_bound(keys, keys + n, cp);
        if (it == keys + n || *it != cp) return false;
        size_t i = it - keys;
        out.insert(out.end(), pool + offs[i], pool + offs[i + 1]);
        return true;
    }
};
const Mapping LOWER{ut_lower_n, ut_lower_keys, ut_lower_offs, ut_lower_pool};
const Mapping NFD{ut_nfd_n, ut_nfd_keys, ut_nfd_offs, ut_nfd_pool};
const Mapping NFKD{ut_nfkd_n, ut_nfkd_keys, ut_nfkd_offs, ut_nfkd_pool};

const uint32_t S_BASE = 0xAC00, L_BASE = 0x1100, V_BASE = 0x1161, T_BASE = 0x11A7;
const uint32_t L_COUNT = 19, V_COUNT = 21, T_COUNT = 28, N_COUNT = 21 * 28, S_COUNT = 19 * 21 * 28;

// str.lower of one code point, appended
inline void append_lower(uint32_t cp, std::vector<uint32_t>& out) {
    if (cp < 128) {
        out.push_back(cp >= 'A' && cp <= 'Z' ? cp + 32 : cp);
        return;
    }
    if (!(rec(cp)[3] & UT_HAS_LOWER) || !LOWER.append(cp, out)) out.push_back(cp);
}

// unicodedata.normalize("NFD" or "NFKD", chr(cp)), appended
inline void append_decomposed(uint32_t cp, bool compat, std::vector<uint32_t>& out) {
    if (cp >= S_BASE && cp < S_BASE + S_COUNT) {
        uint32_t s = cp - S_BASE, t = T_BASE + s % T_COUNT;
        out.push_back(L_BASE + s / N_COUNT);
        out.push_back(V_BASE + (s % N_COUNT) / T_COUNT);
        if (t != T_BASE) out.push_back(t);
        return;
    }
    int bit = compat ? UT_HAS_NFKD : UT_HAS_NFD;
    if (cp < 128 || !(rec(cp)[3] & bit) || !(compat ? NFKD : NFD).append(cp, out)) out.push_back(cp);
}

const uint32_t NONE = 0xFFFFFFFFu;

// tokenizer_json._compose_pair
inline uint32_t compose_pair(uint32_t a, uint32_t b) {
    if (a >= L_BASE && a < L_BASE + L_COUNT && b >= V_BASE && b < V_BASE + V_COUNT)
        return S_BASE + ((a - L_BASE) * V_COUNT + (b - V_BASE)) * T_COUNT;
    if (a >= S_BASE && a < S_BASE + S_COUNT && (a - S_BASE) % T_COUNT == 0 && b > T_BASE && b < T_BASE + T_COUNT)
        return a + (b - T_BASE);
    uint64_t key = (uint64_t(a) << 32) | b;
    const uint64_t* it = std::lower_bound(ut_pair_keys, ut_pair_keys + ut_pair_n, key);
    if (it == ut_pair_keys + ut_pair_n || *it != key) return NONE;
    return ut_pair_vals[it - ut_pair_keys];
}

// UTF-8 of one code point into out; -1 for a surrogate (Python's utf-8 codec refuses it)
inline int utf8(uint32_t cp, unsigned char* out) {
    if (cp < 0x80) {
        out[0] = (unsigned char)cp;
        return 1;
    }
    if (cp < 0x800) {
        out[0] = 0xC0 | (cp >> 6);
        out[1] = 0x80 | (cp & 0x3F);
        return 2;
    }
    if (cp < 0x10000) {
        if (is_surrogate(cp)) return -1;
        out[0] = 0xE0 | (cp >> 12);
        out[1] = 0x80 | ((cp >> 6) & 0x3F);
        out[2] = 0x80 | (cp & 0x3F);
        return 3;
    }
    out[0] = 0xF0 | (cp >> 18);
    out[1] = 0x80 | ((cp >> 12) & 0x3F);
    out[2] = 0x80 | ((cp >> 6) & 0x3F);
    out[3] = 0x80 | (cp & 0x3F);
    return 4;
}

// strict UTF-8 decode (as Python's bytes.decode("utf-8")); false where invalid
bool decode_utf8(const unsigned char* s, size_t n, std::vector<uint32_t>& out) {
    size_t i = 0;
    while (i < n) {
        unsigned char c = s[i];
        uint32_t cp;
        int len;
        if (c < 0x80) {
            cp = c, len = 1;
        } else if (c >= 0xC2 && c < 0xE0) {
            cp = c & 0x1F, len = 2;
        } else if (c >= 0xE0 && c < 0xF0) {
            cp = c & 0x0F, len = 3;
        } else if (c >= 0xF0 && c < 0xF5) {
            cp = c & 0x07, len = 4;
        } else {
            return false;
        }
        if (i + len > n) return false;
        for (int k = 1; k < len; k++) {
            if ((s[i + k] & 0xC0) != 0x80) return false;
            cp = (cp << 6) | (s[i + k] & 0x3F);
        }
        if ((len == 3 && (cp < 0x800 || is_surrogate(cp))) || (len == 4 && (cp < 0x10000 || cp > 0x10FFFF)))
            return false;
        out.push_back(cp);
        i += len;
    }
    return true;
}

inline bool all_ascii(const uint32_t* t, size_t n) {
    for (size_t i = 0; i < n; i++)
        if (t[i] >= 128) return false;
    return true;
}

// -- pieces under normalization --------------------------------------------------

// text and, for each char, the original index it came from (-1: an empty range at 0)
struct Piece {
    std::vector<uint32_t> t;
    std::vector<int32_t> a;
};

struct DC {  // a (char, change) pair of NormalizedString.transform
    uint32_t c;
    int32_t change;
};

// tokenizer_json.transform
void transform(const Piece& in, const std::vector<DC>& dest, size_t initial, Piece& out) {
    out.t.clear();
    out.a.clear();
    size_t pos = initial;
    for (const DC& d : dest) {
        if (d.change > 0) {
            if (pos >= 1 && pos - 1 >= in.a.size()) throw Fail{E_INDEX};
            out.a.push_back(pos >= 1 ? in.a[pos - 1] : -1);
        } else {
            if (pos >= in.a.size()) throw Fail{E_INDEX};
            out.a.push_back(in.a[pos]);
            pos += 1 - d.change;
        }
        out.t.push_back(d.c);
    }
}

// tokenizer_json._span: original (start, end) of normalized chars [s, e)
inline std::pair<int32_t, int32_t> span(const int32_t* a, size_t s, size_t e) {
    if (s >= e) return {0, 0};
    int32_t x = a[s], y = a[e - 1];
    return {std::max(x, 0), y >= 0 ? y + 1 : 0};
}

// tokenize.bert_normalize over t[0:n]: chars appended to out, each with the
// index in t it came from appended to idx
void bert_normalize(const uint32_t* t, size_t n, bool lowercase, std::vector<uint32_t>& out,
                    std::vector<int32_t>& idx, std::vector<uint32_t>& buf) {
    for (size_t i = 0; i < n; i++) {
        uint32_t c = t[i];
        const unsigned char* r = rec(c);
        if (c == 0 || c == 0xFFFD || (r[2] & UT_F_CONTROL)) continue;
        if (r[2] & UT_F_BERT_WS) {
            out.push_back(' ');
            idx.push_back(int32_t(i));
            continue;
        }
        bool cjk = r[2] & UT_F_CJK;
        if (cjk) {
            out.push_back(' ');
            idx.push_back(int32_t(i));
        }
        if (!lowercase) {
            out.push_back(c);
            idx.push_back(int32_t(i));
        } else if (c < 128) {
            out.push_back(c >= 'A' && c <= 'Z' ? c + 32 : c);
            idx.push_back(int32_t(i));
        } else {
            buf.clear();
            append_decomposed(c, false, buf);
            for (uint32_t d : buf) {
                if (cat_of(d) == UT_CAT_Mn) continue;
                size_t before = out.size();
                append_lower(d, out);
                idx.insert(idx.end(), out.size() - before, int32_t(i));
            }
        }
        if (cjk) {
            out.push_back(' ');
            idx.push_back(int32_t(i));
        }
    }
}

// -- normalizers ------------------------------------------------------------------

enum NormKind { NK_NFD = 1, NK_NFKD = 2, NK_NFC = 3, NK_NFKC = 4, NK_STRIP = 5, NK_LOWER = 6, NK_REPLACE = 7,
                NK_PRECOMPILED = 8, NK_BERT = 9 };

struct CharsMap {
    std::vector<uint32_t> units;
    std::string normalized;

    // CharsMap.transform: the replacement of the key's shortest prefix
    bool lookup(const unsigned char* key, size_t len, std::vector<uint32_t>& out) const {
        if (units.empty()) throw Fail{E_INDEX};
        uint64_t u = units[0];
        uint64_t pos = (u >> 10) << ((u & (1u << 9)) >> 6);
        for (size_t i = 0; i < len; i++) {
            unsigned c = key[i];
            if (c == 0) return false;
            pos ^= c;
            if (pos >= units.size()) return false;
            u = units[pos];
            if ((u & ((1ull << 31) | 0xFF)) != c) return false;
            pos ^= (u >> 10) << ((u & (1u << 9)) >> 6);
            if ((u >> 8) & 1) {
                if (pos >= units.size()) throw Fail{E_INDEX};
                size_t at = units[pos] & ((1u << 31) - 1);
                size_t end = at < normalized.size() ? normalized.find('\0', at) : std::string::npos;
                if (end == std::string::npos) end = normalized.size();
                out.clear();
                if (at < end && !decode_utf8(reinterpret_cast<const unsigned char*>(normalized.data()) + at,
                                             end - at, out))
                    throw Fail{E_DECODE};
                return true;
            }
        }
        return false;
    }
};

struct NormStep {
    int kind = 0;
    bool lowercase = false;  // NK_BERT
    U32 needle, content;     // NK_REPLACE
    CharsMap map;            // NK_PRECOMPILED
};

// per-thread scratch
struct Scratch {
    Piece p2, p3;
    std::vector<DC> dest, seq, seq2;
    std::vector<uint32_t> buf, buf2;
    std::vector<int32_t> idx;
    std::vector<size_t> cuts;
};

void sort_run(std::vector<DC>& seq, size_t run) {
    if (seq.size() - run < 2) return;
    auto key = [](const DC& x, const DC& y) { return ccc_of(x.c) < ccc_of(y.c); };
    if (!std::is_sorted(seq.begin() + run, seq.end(), key)) std::stable_sort(seq.begin() + run, seq.end(), key);
}

// tokenizer_json._decomposed
void decomposed(const std::vector<uint32_t>& text, bool compat, std::vector<DC>& seq, std::vector<uint32_t>& buf) {
    seq.clear();
    size_t run = 0;
    for (uint32_t c : text) {
        buf.clear();
        append_decomposed(c, compat, buf);
        for (size_t i = 0; i < buf.size(); i++) {
            if (ccc_of(buf[i]) == 0) {
                sort_run(seq, run);
                run = seq.size();
            }
            seq.push_back({buf[i], i ? 1 : 0});
        }
    }
    sort_run(seq, run);
}

// tokenizer_json._recompose
void recompose(const std::vector<DC>& seq, std::vector<DC>& out) {
    out.clear();
    std::vector<DC> buffer;
    bool have = false;
    DC composee{0, 0};
    int last_ccc = -1;  // -1: None
    for (const DC& x : seq) {
        int cc = ccc_of(x.c);
        if (!have) {
            if (cc != 0) {
                out.push_back(x);
                continue;
            }
            composee = x, have = true;
            continue;
        }
        if (last_ccc >= 0 && last_ccc >= cc) {  // blocked
            if (cc == 0) {
                out.push_back(composee);
                out.insert(out.end(), buffer.begin(), buffer.end());
                buffer.clear();
                composee = x, last_ccc = -1;
                continue;
            }
            buffer.push_back(x);
            last_ccc = cc;
            continue;
        }
        uint32_t r = compose_pair(composee.c, x.c);
        if (r != NONE) {
            composee = DC{r, composee.change + x.change - 1};
            continue;
        }
        if (cc == 0 && last_ccc < 0) {
            out.push_back(composee);
            composee = x;
            continue;
        }
        buffer.push_back(x);
        last_ccc = cc;
    }
    if (have) out.push_back(composee);
    out.insert(out.end(), buffer.begin(), buffer.end());
}

// tokenizer_json._filter with keep = not a mark (StripAccents)
void strip_accents(Piece& p, Scratch& s) {
    if (all_ascii(p.t.data(), p.t.size())) return;
    s.dest.clear();
    size_t removed = 0, first_removed = 0;
    bool have = false;
    uint32_t last = 0;
    for (uint32_t c : p.t) {
        if (!is_mark(c)) {
            if (!have)
                first_removed = removed;
            else
                s.dest.push_back({last, -int32_t(removed)});
            last = c, have = true, removed = 0;
        } else {
            removed++;
        }
    }
    if (have) s.dest.push_back({last, -int32_t(removed)});
    transform(p, s.dest, first_removed, s.p2);
    std::swap(p, s.p2);
}

void lowercase(Piece& p, Scratch& s) {
    if (all_ascii(p.t.data(), p.t.size())) {
        for (uint32_t& c : p.t)
            if (c >= 'A' && c <= 'Z') c += 32;
        return;
    }
    s.dest.clear();
    for (uint32_t c : p.t) {
        s.buf.clear();
        append_lower(c, s.buf);
        for (size_t i = 0; i < s.buf.size(); i++) s.dest.push_back({s.buf[i], i ? 1 : 0});
    }
    transform(p, s.dest, 0, s.p2);
    std::swap(p, s.p2);
}

// tokenizer_json._replace_matches: each [start, end) span replaced by
// content, its chars aligned as the span's last char
void replace_matches(Piece& p, const std::vector<std::pair<size_t, size_t>>& spans, const U32& content, Scratch& s) {
    Piece& o = s.p2;
    o.t.clear();
    o.a.clear();
    size_t last = 0;
    for (auto& sp : spans) {
        o.t.insert(o.t.end(), p.t.begin() + last, p.t.begin() + sp.first);
        o.a.insert(o.a.end(), p.a.begin() + last, p.a.begin() + sp.first);
        o.t.insert(o.t.end(), content.begin(), content.end());
        o.a.insert(o.a.end(), content.size(), p.a[sp.second - 1]);
        last = sp.second;
    }
    o.t.insert(o.t.end(), p.t.begin() + last, p.t.end());
    o.a.insert(o.a.end(), p.a.begin() + last, p.a.end());
    std::swap(p, o);
}

void replace(Piece& p, const NormStep& st, Scratch& s) {
    if (st.needle.empty()) return;
    View text(reinterpret_cast<const char32_t*>(p.t.data()), p.t.size());
    std::vector<std::pair<size_t, size_t>> spans;
    size_t at = text.find(st.needle);
    while (at != View::npos) {
        spans.push_back({at, at + st.needle.size()});
        at = text.find(st.needle, at + st.needle.size());
    }
    if (!spans.empty()) replace_matches(p, spans, st.content, s);
}

// tokenizer_json._prepend: prefix aligned as the first char
void prepend(Piece& p, const U32& prefix) {
    if (p.t.empty()) return;
    p.t.insert(p.t.begin(), prefix.begin(), prefix.end());
    p.a.insert(p.a.begin(), prefix.size(), p.a[0]);
}

// tokenizer_json.graphemes: the cuts between clusters of t[0:n]
void graphemes(const uint32_t* t, size_t n, std::vector<size_t>& cuts) {
    cuts.clear();
    cuts.push_back(0);
    if (n == 0) return;
    int prev = gcb_of(t[0]);
    int ri_run = prev == UT_G_RI ? 1 : 0;
    bool pict_zwj = prev == UT_G_PICT;
    for (size_t i = 1; i < n; i++) {
        int cur = gcb_of(t[i]);
        bool join;
        auto ctl = [](int g) { return g == UT_G_CR || g == UT_G_LF || g == UT_G_CONTROL; };
        if (prev == UT_G_CR && cur == UT_G_LF)
            join = true;
        else if (ctl(prev) || ctl(cur))
            join = false;
        else if ((prev == UT_G_L && (cur == UT_G_L || cur == UT_G_V || cur == UT_G_LV || cur == UT_G_LVT)) ||
                 ((prev == UT_G_LV || prev == UT_G_V) && (cur == UT_G_V || cur == UT_G_T)) ||
                 ((prev == UT_G_LVT || prev == UT_G_T) && cur == UT_G_T))
            join = true;
        else if (cur == UT_G_EXTEND || cur == UT_G_ZWJ || cur == UT_G_SPACINGMARK)
            join = true;
        else if (prev == UT_G_ZWJ && cur == UT_G_PICT && pict_zwj)
            join = true;
        else if (prev == UT_G_RI && cur == UT_G_RI)
            join = ri_run % 2 == 1;
        else
            join = false;
        if (!join) cuts.push_back(i);
        ri_run = cur == UT_G_RI ? ri_run + 1 : 0;
        if (cur == UT_G_PICT)
            pict_zwj = true;
        else if (cur != UT_G_EXTEND && cur != UT_G_ZWJ)
            pict_zwj = false;
        prev = cur;
    }
    cuts.push_back(n);
}

// CharsMap.__call__
void precompiled(Piece& p, const CharsMap& map, Scratch& s) {
    for (size_t i = 0; i < p.t.size(); i++)
        if (is_surrogate(p.t[i])) throw Fail{E_SURROGATE};
    graphemes(p.t.data(), p.t.size(), s.cuts);
    s.dest.clear();
    bool modified = false;
    std::vector<unsigned char> key;
    auto put = [&](size_t old_len, const std::vector<uint32_t>& repl) {
        for (uint32_t c : repl) s.dest.push_back({c, 0});
        int64_t diff = int64_t(repl.size()) - int64_t(old_len);
        if (diff > 0) {
            for (size_t j = s.dest.size() - diff; j < s.dest.size(); j++) s.dest[j].change = 1;
        } else if (diff < 0 && !s.dest.empty()) {
            s.dest.back().change += int32_t(diff);
        }
    };
    unsigned char b[4];
    for (size_t g = 0; g + 1 < s.cuts.size(); g++) {
        size_t gs = s.cuts[g], ge = s.cuts[g + 1];
        key.clear();
        for (size_t i = gs; i < ge; i++) {
            int len = utf8(p.t[i], b);
            key.insert(key.end(), b, b + len);
        }
        if (key.size() < 6 && map.lookup(key.data(), key.size(), s.buf2)) {
            modified = true;
            put(ge - gs, s.buf2);
            continue;
        }
        for (size_t i = gs; i < ge; i++) {
            int len = utf8(p.t[i], b);
            if (map.lookup(b, len, s.buf2)) {
                modified = true;
                put(1, s.buf2);
            } else {
                s.dest.push_back({p.t[i], 0});
            }
        }
    }
    if (!modified) return;
    transform(p, s.dest, 0, s.p2);
    std::swap(p, s.p2);
}

void normalize(Piece& p, const std::vector<NormStep>& steps, Scratch& s) {
    for (const NormStep& st : steps) {
        switch (st.kind) {
            case NK_NFD:
            case NK_NFKD:
            case NK_NFC:
            case NK_NFKC: {
                if (all_ascii(p.t.data(), p.t.size())) break;
                bool compat = st.kind == NK_NFKD || st.kind == NK_NFKC;
                decomposed(p.t, compat, s.seq, s.buf);
                if (st.kind == NK_NFC || st.kind == NK_NFKC) {
                    recompose(s.seq, s.seq2);
                    transform(p, s.seq2, 0, s.p2);
                } else {
                    transform(p, s.seq, 0, s.p2);
                }
                std::swap(p, s.p2);
                break;
            }
            case NK_STRIP:
                strip_accents(p, s);
                break;
            case NK_LOWER:
                lowercase(p, s);
                break;
            case NK_REPLACE:
                replace(p, st, s);
                break;
            case NK_PRECOMPILED:
                precompiled(p, st.map, s);
                break;
            case NK_BERT: {
                s.p2.t.clear();
                s.idx.clear();
                bert_normalize(p.t.data(), p.t.size(), st.lowercase, s.p2.t, s.idx, s.buf);
                s.p2.a.resize(s.idx.size());
                for (size_t i = 0; i < s.idx.size(); i++) s.p2.a[i] = p.a[s.idx[i]];
                std::swap(p, s.p2);
                break;
            }
        }
    }
}

// -- pre-tokenizers ---------------------------------------------------------------

// pieces as [start, end) ranges of one buffer of chars and original indices
struct Pieces {
    std::vector<uint32_t> t;
    std::vector<int32_t> a;
    std::vector<std::pair<size_t, size_t>> at;

    void clear() {
        t.clear();
        a.clear();
        at.clear();
    }
    void begin() { at.push_back({t.size(), t.size()}); }
    void push(uint32_t c, int32_t o) {
        t.push_back(c);
        a.push_back(o);
        at.back().second = t.size();
    }
};

enum PreKind { PK_BYTE_LEVEL = 1, PK_WHITESPACE_SPLIT = 2, PK_METASPACE = 3 };

struct PreStep {
    int kind = 0;
    bool add_prefix_space = false, use_regex = false;  // ByteLevel
    uint32_t bytes_char[256] = {};
    U32 replacement;  // Metaspace
    int scheme = 0;   // 0 always, 1 first, 2 never
    bool split = true;
};

inline bool gpt2_letter(uint32_t c) { return has(c, UT_F_LETTER); }
inline bool gpt2_number(uint32_t c) { return has(c, UT_F_NUMBER); }
inline bool gpt2_space(uint32_t c) { return has(c, UT_F_WHITE_SPACE); }
inline bool gpt2_other(uint32_t c) { return !(rec(c)[2] & (UT_F_WHITE_SPACE | UT_F_LETTER | UT_F_NUMBER)); }

// the end of tokenizer_json.gpt2_split()'s match at i: 's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|
// ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+, tried in that order as the regex engine does
size_t gpt2_match(const uint32_t* t, size_t n, size_t i) {
    uint32_t c = t[i];
    if (c == '\'' && i + 1 < n) {
        uint32_t d = t[i + 1];
        if (d == 's' || d == 't' || d == 'm' || d == 'd') return i + 2;
        if (i + 2 < n) {
            uint32_t e = t[i + 2];
            if ((d == 'r' && e == 'e') || (d == 'v' && e == 'e') || (d == 'l' && e == 'l')) return i + 3;
        }
    }
    bool (*classes[3])(uint32_t) = {gpt2_letter, gpt2_number, gpt2_other};
    for (auto cls : classes) {
        size_t j = n;
        if (c == ' ' && i + 1 < n && cls(t[i + 1]))
            j = i + 1;
        else if (cls(c))
            j = i;
        if (j == n) continue;
        while (j < n && cls(t[j])) j++;
        return j;
    }
    size_t j = i;
    while (j < n && gpt2_space(t[j])) j++;
    if (j == i) return i + 1;  // unreachable: every char is a letter, a number, a space or other
    if (j == n || j - i < 2) return j;
    return j - 1;  // \s+(?!\S): the run less its last char, which the next match takes
}

void byte_level(const PreStep& st, const uint32_t* t0, const int32_t* a0, size_t n0, Pieces& out, Scratch& s) {
    const uint32_t* t = t0;
    const int32_t* a = a0;
    size_t n = n0;
    if (st.add_prefix_space && n > 0 && t[0] != ' ') {
        s.buf.assign(1, ' ');
        s.buf.insert(s.buf.end(), t0, t0 + n0);
        s.idx.assign(1, a0[0]);
        s.idx.insert(s.idx.end(), a0, a0 + n0);
        t = s.buf.data(), a = s.idx.data(), n = s.buf.size();
    }
    if (n == 0) return;
    size_t i = 0;
    unsigned char b[4];
    do {
        size_t j = st.use_regex ? gpt2_match(t, n, i) : n;
        out.begin();
        for (size_t k = i; k < j; k++) {
            if (t[k] < 128) {
                out.push(st.bytes_char[t[k]], a[k]);
                continue;
            }
            int len = utf8(t[k], b);
            if (len < 0) throw Fail{E_SURROGATE};
            for (int m = 0; m < len; m++) out.push(st.bytes_char[b[m]], a[k]);
        }
        i = j;
    } while (i < n);
}

void whitespace_split(const uint32_t* t, const int32_t* a, size_t n, Pieces& out) {
    bool in = false;
    for (size_t i = 0; i < n; i++) {
        if (gpt2_space(t[i])) {
            in = false;
        } else {
            if (!in) out.begin();
            out.push(t[i], a[i]);
            in = true;
        }
    }
}

void metaspace(const PreStep& st, const uint32_t* t, const int32_t* a, size_t n, Pieces& out, Scratch& s) {
    Piece& p = s.p3;
    p.t.assign(t, t + n);
    p.a.assign(a, a + n);
    if (std::find(t, t + n, uint32_t(' ')) != t + n) {
        std::vector<std::pair<size_t, size_t>> spans;
        for (size_t i = 0; i < n; i++)
            if (t[i] == ' ') spans.push_back({i, i + 1});
        replace_matches(p, spans, st.replacement, s);
    }
    const U32& r = st.replacement;
    bool starts = p.t.size() >= r.size() && std::equal(r.begin(), r.end(), p.t.begin());
    if (!starts && (st.scheme == 0 || (st.scheme == 1 && !p.a.empty() && p.a[0] <= 0))) prepend(p, r);
    size_t len = p.t.size();
    out.begin();
    for (size_t i = 0; i < len; i++) {
        if (st.split && i > 0 && r.size() == 1 && p.t[i] == uint32_t(r[0])) out.begin();
        out.push(p.t[i], p.a[i]);
    }
}

// -- models -----------------------------------------------------------------------

struct Sym {
    int32_t id, s, e;  // in the word's chars
};

// a string table: the strings in one pool and a map from each to a value
template <class V>
struct Table {
    std::vector<uint32_t> pool;
    std::unordered_map<View, V> map;

    const V* get(const uint32_t* s, size_t n) const {
        auto it = map.find(View(reinterpret_cast<const char32_t*>(s), n));
        return it == map.end() ? nullptr : &it->second;
    }
    const V* get(const U32& s) const { return get(reinterpret_cast<const uint32_t*>(s.data()), s.size()); }
};

struct WordCache {
    std::unordered_map<U32, std::vector<Sym>> map;
    const std::vector<Sym>* get(const uint32_t* w, size_t n, U32& key) {
        key.assign(reinterpret_cast<const char32_t*>(w), n);
        auto it = map.find(key);
        return it == map.end() ? nullptr : &it->second;
    }
    void put(const U32& key, const std::vector<Sym>& v) {
        if (map.size() >= 200000) map.clear();
        map.emplace(key, v);
    }
};

struct BPE {
    Table<int32_t> vocab;
    bool unk_set = false;
    int32_t unk_id = -1;  // -1: the unk token is not in the vocabulary
    bool fuse_unk = false, ignore_merges = false;
    U32 prefix, suffix;
    std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> merges;  // (left, right) -> (rank, new id)

    void tokenize(const uint32_t* w, size_t n, WordCache& cache, U32& key, std::vector<Sym>& syms) const {
        syms.clear();
        if (n == 0) return;
        if (ignore_merges) {
            if (const int32_t* id = vocab.get(w, n)) {
                syms.push_back({*id, 0, int32_t(n)});
                return;
            }
        }
        if (const std::vector<Sym>* hit = cache.get(w, n, key)) {
            syms = *hit;
            return;
        }
        U32 s;
        bool have_unk = false;
        Sym unk{0, 0, 0};
        for (size_t i = 0; i < n; i++) {
            s.clear();
            if (i && !prefix.empty()) s += prefix;
            s.push_back(char32_t(w[i]));
            if (i == n - 1) s += suffix;
            const int32_t* id = vocab.get(s);
            if (id) {
                if (have_unk) syms.push_back(unk), have_unk = false;
                syms.push_back({*id, int32_t(i), int32_t(i + 1)});
            } else if (unk_set) {
                if (unk_id < 0) throw Fail{E_UNK_MISSING};
                if (have_unk && fuse_unk) {
                    unk.e = int32_t(i + 1);
                } else {
                    if (have_unk) syms.push_back(unk);
                    unk = {unk_id, int32_t(i), int32_t(i + 1)}, have_unk = true;
                }
            }
        }
        if (have_unk) syms.push_back(unk);
        while (syms.size() > 1) {
            int32_t best_rank = 0, best_new = 0;
            size_t best = SIZE_MAX;
            for (size_t j = 0; j + 1 < syms.size(); j++) {
                auto it = merges.find((uint64_t(uint32_t(syms[j].id)) << 32) | uint32_t(syms[j + 1].id));
                if (it != merges.end() && (best == SIZE_MAX || it->second.first < best_rank))
                    best = j, best_rank = it->second.first, best_new = it->second.second;
            }
            if (best == SIZE_MAX) break;
            syms[best] = {best_new, syms[best].s, syms[best + 1].e};
            syms.erase(syms.begin() + best + 1);
        }
        cache.put(key, syms);
    }
};

struct Unigram {
    Table<int32_t> vocab;                        // a repeated piece: its last id
    Table<std::pair<int32_t, double>> scored;  // non-empty pieces: (id, score)
    int32_t unk_id = -1;                        // -1: None
    double unk_score = 0;
    size_t max_len = 1;

    void tokenize(const uint32_t* w, size_t n, WordCache& cache, U32& key, std::vector<Sym>& out) const {
        out.clear();
        if (n == 0) return;
        if (const std::vector<Sym>* hit = cache.get(w, n, key)) {
            out = *hit;
            return;
        }
        std::vector<double> score(n + 1, 0.0);
        std::vector<int64_t> back_s(n + 1, -1);  // -1: None
        std::vector<int32_t> back_id(n + 1, 0);
        for (size_t s = 0; s < n; s++) {
            double base = score[s];
            bool single = false;
            size_t last = std::min(n, s + max_len);
            for (size_t e = s + 1; e <= last; e++) {
                const std::pair<int32_t, double>* hit = scored.get(w + s, e - s);
                if (!hit) continue;
                double cand = hit->second + base;
                if (back_s[e] < 0 || cand > score[e]) score[e] = cand, back_s[e] = int64_t(s), back_id[e] = hit->first;
                if (e == s + 1) single = true;
            }
            if (!single) {
                if (unk_id < 0) throw Fail{E_NO_UNK_ID};
                double cand = unk_score + base;
                if (back_s[s + 1] < 0 || cand > score[s + 1])
                    score[s + 1] = cand, back_s[s + 1] = int64_t(s), back_id[s + 1] = unk_id;
            }
        }
        std::vector<std::pair<size_t, size_t>> spans;  // from the end
        bool fused = false;
        std::pair<size_t, size_t> f{0, 0};
        size_t e = n;
        while (e > 0) {
            size_t s = size_t(back_s[e]);
            if (back_id[e] == unk_id) {
                f = {s, fused ? f.second : e}, fused = true;
            } else {
                if (fused) spans.push_back(f), fused = false;
                spans.push_back({s, e});
            }
            e = s;
        }
        if (fused) spans.push_back(f);
        for (auto it = spans.rbegin(); it != spans.rend(); ++it) {
            const int32_t* id = vocab.get(w + it->first, it->second - it->first);
            out.push_back({id ? *id : unk_id, int32_t(it->first), int32_t(it->second)});
        }
        cache.put(key, out);
    }
};

// -- the engine -------------------------------------------------------------------

struct Added {
    U32 pat;
    int32_t id;
    bool single_word, lstrip, rstrip;
};

struct Tok {
    int32_t id, s, e;
    int32_t lead, trail;  // the value's leading and trailing trim chars (with a trim)
};

struct Engine {
    int kind = 0;  // 0 WordPiece, 1 a tokenizer.json Pipeline
    // WordPiece
    Table<int32_t> wp_vocab;
    bool wp_lowercase = true;
    int32_t wp_unk = 0, wp_cls = 0, wp_sep = 0, wp_max_chars = 100;
    U32 wp_prefix;
    // Pipeline
    std::vector<NormStep> norms;
    std::vector<PreStep> pres;
    int model = 0;  // 1 BPE, 2 Unigram
    BPE bpe;
    Unigram uni;
    std::vector<std::pair<int32_t, int32_t>> post_pre, post_suf;  // (id, type id)
    int32_t post_type = 0;
    int trim = -1;  // -1 no trim, else its add_prefix_space
    uint32_t trim_space = ' ';
    std::vector<int32_t> bpe_lead, bpe_trail;  // by id: the token string's trim counts
    std::vector<Added> raw, normed;
};

struct Ctx {  // one worker's state for one call
    Scratch s;
    Piece p;
    Pieces pa, pb;
    WordCache cache;
    U32 key, wkey;
    std::vector<Sym> syms;
    std::vector<Tok> toks;
    std::vector<std::pair<size_t, size_t>> segs;
    std::vector<int32_t> seg_tok;
};

inline bool trim_char(const Engine& E, uint32_t c) { return c == E.trim_space || gpt2_space(c); }

void trim_counts(const Engine& E, const uint32_t* t, size_t n, int32_t& lead, int32_t& trail) {
    size_t i = 0;
    while (i < n && trim_char(E, t[i])) i++;
    size_t j = n;
    while (j > 0 && trim_char(E, t[j - 1])) j--;
    lead = int32_t(i);
    trail = int32_t(n - j);
}

// tokenize.WordPieceTokenizer: normalize, pre-tokenize, word pieces
void wordpiece_tokens(const Engine& E, const uint32_t* text, size_t n, Ctx& cx) {
    Piece& p = cx.p;
    p.t.clear();
    cx.s.idx.clear();
    bert_normalize(text, n, E.wp_lowercase, p.t, cx.s.idx, cx.s.buf);
    const std::vector<int32_t>& align = cx.s.idx;
    size_t len = p.t.size();
    auto word = [&](size_t ws, size_t we) {
        size_t wn = we - ws;
        const uint32_t* w = p.t.data() + ws;
        if (wn > size_t(E.wp_max_chars)) {
            cx.toks.push_back({E.wp_unk, align[ws], align[we - 1] + 1, 0, 0});
            return;
        }
        size_t first = cx.toks.size();
        size_t start = 0;
        while (start < wn) {
            size_t end = wn;
            const int32_t* found = nullptr;
            while (start < end) {
                if (start == 0) {
                    found = E.wp_vocab.get(w, end);
                } else {
                    cx.key.assign(E.wp_prefix);
                    cx.key.append(reinterpret_cast<const char32_t*>(w + start), end - start);
                    found = E.wp_vocab.get(cx.key);
                }
                if (found) break;
                end--;
            }
            if (!found) {
                cx.toks.resize(first);
                cx.toks.push_back({E.wp_unk, align[ws], align[we - 1] + 1, 0, 0});
                return;
            }
            cx.toks.push_back({*found, align[ws + start], align[ws + end - 1] + 1, 0, 0});
            start = end;
        }
    };
    size_t start = SIZE_MAX;
    for (size_t i = 0; i < len; i++) {
        uint32_t c = p.t[i];
        if (c == ' ') {
            if (start != SIZE_MAX) word(start, i), start = SIZE_MAX;
        } else if (has(c, UT_F_PUNCT)) {
            if (start != SIZE_MAX) word(start, i), start = SIZE_MAX;
            word(i, i + 1);
        } else if (start == SIZE_MAX) {
            start = i;
        }
    }
    if (start != SIZE_MAX) word(start, len);
}

// tokenizer_json._find_added: (index in pats or -1, start, end) pieces covering t[0:n]
void find_added(const uint32_t* t, size_t n, const std::vector<Added>& pats, std::vector<std::pair<size_t, size_t>>& segs,
                std::vector<int32_t>& which) {
    segs.clear();
    which.clear();
    if (n == 0 || pats.empty()) {
        segs.push_back({0, n});
        which.push_back(-1);
        return;
    }
    View text(reinterpret_cast<const char32_t*>(t), n);
    std::vector<size_t> next(pats.size(), 0);  // each pattern's first match at or after where it was last sought
    std::vector<bool> sought(pats.size(), false);
    size_t start_offset = 0, pos = 0;
    while (true) {
        size_t best_at = View::npos, best = 0;
        for (size_t k = 0; k < pats.size(); k++) {
            if (!sought[k] || (next[k] != View::npos && next[k] < pos)) {
                next[k] = text.find(pats[k].pat, pos);
                sought[k] = true;
            }
            size_t at = next[k];
            if (at == View::npos) continue;
            if (best_at == View::npos || at < best_at || (at == best_at && pats[k].pat.size() > pats[best].pat.size()))
                best_at = at, best = k;
        }
        if (best_at == View::npos) break;
        const Added& tok = pats[best];
        size_t start = best_at, stop = start + tok.pat.size();
        pos = stop;
        if (tok.single_word && ((start > 0 && has(t[start - 1], UT_F_WORD)) || (stop < n && has(t[stop], UT_F_WORD))))
            continue;
        if (tok.lstrip) {
            size_t k = start;
            while (k > 0 && gpt2_space(t[k - 1])) k--;
            start = std::max(k, start_offset);
        }
        if (tok.rstrip)
            while (stop < n && gpt2_space(t[stop])) stop++;
        if (start_offset < start) {
            segs.push_back({start_offset, start});
            which.push_back(-1);
        }
        segs.push_back({start, stop});
        which.push_back(int32_t(best));
        start_offset = stop;
    }
    if (start_offset != n) {
        segs.push_back({start_offset, n});
        which.push_back(-1);
    }
}

void model_tokens(const Engine& E, const uint32_t* t, const int32_t* a, size_t n, Ctx& cx) {
    Pieces* cur = &cx.pa;
    Pieces* nxt = &cx.pb;
    cur->clear();
    cur->begin();
    for (size_t i = 0; i < n; i++) cur->push(t[i], a[i]);
    for (const PreStep& st : E.pres) {
        nxt->clear();
        for (auto& at : cur->at) {
            size_t ps = at.first, pn = at.second - at.first;
            if (pn == 0) continue;
            const uint32_t* pt = cur->t.data() + ps;
            const int32_t* pa = cur->a.data() + ps;
            if (st.kind == PK_BYTE_LEVEL)
                byte_level(st, pt, pa, pn, *nxt, cx.s);
            else if (st.kind == PK_WHITESPACE_SPLIT)
                whitespace_split(pt, pa, pn, *nxt);
            else
                metaspace(st, pt, pa, pn, *nxt, cx.s);
        }
        std::swap(cur, nxt);
    }
    for (auto& at : cur->at) {
        size_t ws = at.first, wn = at.second - at.first;
        if (wn == 0) continue;
        const uint32_t* w = cur->t.data() + ws;
        const int32_t* wa = cur->a.data() + ws;
        if (E.model == 1)
            E.bpe.tokenize(w, wn, cx.cache, cx.wkey, cx.syms);
        else
            E.uni.tokenize(w, wn, cx.cache, cx.wkey, cx.syms);
        for (const Sym& y : cx.syms) {
            auto o = span(wa, y.s, y.e);
            Tok tk{y.id, o.first, o.second, 0, 0};
            if (E.trim >= 0) {
                if (E.model == 1) {
                    bool known = y.id >= 0 && size_t(y.id) < E.bpe_lead.size();
                    tk.lead = known ? E.bpe_lead[y.id] : 0;
                    tk.trail = known ? E.bpe_trail[y.id] : 0;
                } else {
                    trim_counts(E, w + y.s, y.e - y.s, tk.lead, tk.trail);
                }
            }
            cx.toks.push_back(tk);
        }
    }
}

// tokenizer_json.Pipeline._tokens
void pipeline_tokens(const Engine& E, const uint32_t* text, size_t n, Ctx& cx) {
    std::vector<std::pair<size_t, size_t>> segs;
    std::vector<int32_t> which;
    find_added(text, n, E.raw, segs, which);
    for (size_t k = 0; k < segs.size(); k++) {
        size_t s = segs[k].first, e = segs[k].second;
        if (which[k] >= 0) {
            Tok tk{E.raw[which[k]].id, int32_t(s), int32_t(e), 0, 0};
            if (E.trim >= 0) trim_counts(E, text + s, e - s, tk.lead, tk.trail);
            cx.toks.push_back(tk);
            continue;
        }
        if (s == e) continue;
        Piece& p = cx.p;
        p.t.assign(text + s, text + e);
        p.a.resize(e - s);
        for (size_t i = s; i < e; i++) p.a[i - s] = int32_t(i);
        normalize(p, E.norms, cx.s);
        find_added(p.t.data(), p.t.size(), E.normed, cx.segs, cx.seg_tok);
        const std::vector<std::pair<size_t, size_t>>& nsegs = cx.segs;
        const std::vector<int32_t>& ntok = cx.seg_tok;
        for (size_t m = 0; m < nsegs.size(); m++) {
            size_t ns = nsegs[m].first, ne = nsegs[m].second;
            if (ntok[m] >= 0) {
                auto o = span(p.a.data(), ns, ne);
                Tok tk{E.normed[ntok[m]].id, o.first, o.second, 0, 0};
                if (E.trim >= 0) trim_counts(E, p.t.data() + ns, ne - ns, tk.lead, tk.trail);
                cx.toks.push_back(tk);
            } else if (ns < ne) {
                model_tokens(E, p.t.data() + ns, p.a.data() + ns, ne - ns, cx);
            }
        }
    }
}

struct Out {
    std::vector<int32_t> ids, type_ids, offsets;
    std::vector<int8_t> special;
    std::vector<int64_t> lens;
};

void encode_one(const Engine& E, const uint32_t* text, size_t n, bool add_special, int64_t max_length, Ctx& cx,
                Out& out) {
    cx.toks.clear();
    size_t before = out.ids.size();
    if (E.kind == 0) {
        wordpiece_tokens(E, text, n, cx);
        if (max_length >= 0) {
            int64_t budget = std::max<int64_t>(max_length - (add_special ? 2 : 0), 0);
            if (int64_t(cx.toks.size()) > budget) cx.toks.resize(budget);
        }
        auto put = [&](int32_t id, int32_t s, int32_t e, int8_t sp) {
            out.ids.push_back(id);
            out.type_ids.push_back(0);
            out.offsets.push_back(s);
            out.offsets.push_back(e);
            out.special.push_back(sp);
        };
        if (add_special) put(E.wp_cls, 0, 0, 1);
        for (const Tok& t : cx.toks) put(t.id, t.s, t.e, 0);
        if (add_special) put(E.wp_sep, 0, 0, 1);
    } else {
        pipeline_tokens(E, text, n, cx);
        int64_t n_added = int64_t(E.post_pre.size() + E.post_suf.size());
        if (max_length >= 0) {
            int64_t budget = add_special && n_added ? max_length - n_added : max_length;
            budget = std::max<int64_t>(budget, 0);
            if (int64_t(cx.toks.size()) > budget) cx.toks.resize(budget);
        }
        if (E.trim >= 0) {
            for (size_t i = 0; i < cx.toks.size(); i++) {
                Tok& t = cx.toks[i];
                int32_t s = t.s, e = t.e, lead = t.lead, trail = t.trail;
                if (lead && (i == 0 || s == 0) && E.trim && lead == 1) lead = 0;
                if (lead) s = std::min(s + lead, e);
                if (trail && e >= trail) e = std::max(e - trail, s);
                t.s = s, t.e = e;
            }
        }
        auto put = [&](int32_t id, int32_t type, int32_t s, int32_t e, int8_t sp) {
            out.ids.push_back(id);
            out.type_ids.push_back(type);
            out.offsets.push_back(s);
            out.offsets.push_back(e);
            out.special.push_back(sp);
        };
        if (add_special)
            for (auto& x : E.post_pre) put(x.first, x.second, 0, 0, 1);
        for (const Tok& t : cx.toks) put(t.id, E.post_type, t.s, t.e, 0);
        if (add_special)
            for (auto& x : E.post_suf) put(x.first, x.second, 0, 0, 1);
    }
    out.lens.push_back(int64_t(out.ids.size() - before));
}

struct Result {
    std::vector<Out> parts;
    int err_kind = E_OK;
    int64_t err_index = -1;
};

// -- reading the program the Python side wrote --------------------------------------

struct Reader {
    const int32_t* p;
    const int32_t* end;

    int32_t i() {
        if (p >= end) throw Fail{E_INTERNAL};
        return *p++;
    }
    double f() {
        int32_t w[2] = {i(), i()};
        double x;
        std::memcpy(&x, w, sizeof x);
        return x;
    }
    // a table of strings: n, their n lengths, then their code points (into pool)
    std::vector<std::pair<size_t, size_t>> strs(std::vector<uint32_t>& pool) {
        int32_t n = i();
        if (n < 0 || end - p < n) throw Fail{E_INTERNAL};
        std::vector<std::pair<size_t, size_t>> at(n);
        const int32_t* lens = p;
        p += n;
        size_t total = 0;
        for (int32_t k = 0; k < n; k++) {
            if (lens[k] < 0) throw Fail{E_INTERNAL};
            at[k] = {pool.size() + total, size_t(lens[k])};
            total += size_t(lens[k]);
        }
        if (size_t(end - p) < total) throw Fail{E_INTERNAL};
        pool.insert(pool.end(), reinterpret_cast<const uint32_t*>(p), reinterpret_cast<const uint32_t*>(p) + total);
        p += total;
        return at;
    }
    U32 str() {
        std::vector<uint32_t> pool;
        auto at = strs(pool);
        if (at.size() != 1) throw Fail{E_INTERNAL};
        return U32(reinterpret_cast<const char32_t*>(pool.data()), pool.size());
    }
    std::string bytes() {
        int32_t n = i();
        size_t words = (size_t(n) + 3) / 4;
        if (n < 0 || size_t(end - p) < words) throw Fail{E_INTERNAL};
        std::string out(reinterpret_cast<const char*>(p), size_t(n));
        p += words;
        return out;
    }
};

template <class V>
void build_map(Table<V>& tab, const std::vector<std::pair<size_t, size_t>>& at, const std::vector<V>& values) {
    tab.map.reserve(at.size());
    for (size_t k = 0; k < at.size(); k++)
        tab.map[View(reinterpret_cast<const char32_t*>(tab.pool.data()) + at[k].first, at[k].second)] = values[k];
}

// a string -> int32 table: the strings, then their values in order (later entries win)
void read_ids(Reader& r, Table<int32_t>& tab) {
    auto at = r.strs(tab.pool);
    std::vector<int32_t> ids(at.size());
    for (auto& x : ids) x = r.i();
    build_map(tab, at, ids);
}

std::vector<Added> read_added(Reader& r) {
    std::vector<uint32_t> pool;
    auto at = r.strs(pool);
    std::vector<Added> out(at.size());
    for (size_t k = 0; k < at.size(); k++) {
        out[k].pat.assign(reinterpret_cast<const char32_t*>(pool.data()) + at[k].first, at[k].second);
        out[k].id = r.i();
        out[k].single_word = r.i(), out[k].lstrip = r.i(), out[k].rstrip = r.i();
    }
    return out;
}

const int32_t MAGIC = 0x544B4E31;  // "TKN1"

Engine* read_engine(Reader& r) {
    if (r.i() != MAGIC) throw Fail{E_INTERNAL};
    Engine* E = new Engine();
    try {
        E->kind = r.i();
        if (E->kind == 0) {
            E->wp_lowercase = r.i();
            E->wp_unk = r.i(), E->wp_cls = r.i(), E->wp_sep = r.i(), E->wp_max_chars = r.i();
            E->wp_prefix = r.str();
            read_ids(r, E->wp_vocab);
        } else {
            for (int32_t k = r.i(); k > 0; k--) {
                NormStep st;
                st.kind = r.i();
                if (st.kind == NK_REPLACE) {
                    st.needle = r.str();
                    st.content = r.str();
                } else if (st.kind == NK_PRECOMPILED) {
                    int32_t n = r.i();
                    for (int32_t j = 0; j < n; j++) st.map.units.push_back(uint32_t(r.i()));
                    st.map.normalized = r.bytes();
                } else if (st.kind == NK_BERT) {
                    st.lowercase = r.i();
                } else if (st.kind < NK_NFD || st.kind > NK_BERT) {
                    throw Fail{E_INTERNAL};
                }
                E->norms.push_back(std::move(st));
            }
            for (int32_t k = r.i(); k > 0; k--) {
                PreStep st;
                st.kind = r.i();
                if (st.kind == PK_BYTE_LEVEL) {
                    st.add_prefix_space = r.i(), st.use_regex = r.i();
                    for (int b = 0; b < 256; b++) st.bytes_char[b] = uint32_t(r.i());
                } else if (st.kind == PK_METASPACE) {
                    st.replacement = r.str();
                    st.scheme = r.i(), st.split = r.i();
                } else if (st.kind != PK_WHITESPACE_SPLIT) {
                    throw Fail{E_INTERNAL};
                }
                E->pres.push_back(st);
            }
            E->model = r.i();
            std::vector<uint32_t> value_pool;
            std::vector<std::pair<size_t, size_t>> value_at;
            std::vector<int32_t> value_ids;
            if (E->model == 1) {
                BPE& m = E->bpe;
                read_ids(r, m.vocab);
                m.unk_set = r.i(), m.unk_id = r.i(), m.fuse_unk = r.i(), m.ignore_merges = r.i();
                m.prefix = r.str();
                m.suffix = r.str();
                int32_t n = r.i();
                m.merges.reserve(n);
                for (int32_t j = 0; j < n; j++) {
                    uint32_t a = r.i(), b = r.i();
                    int32_t rank = r.i(), id = r.i();
                    m.merges[(uint64_t(a) << 32) | b] = {rank, id};
                }
                // the token string of each id (vocab_r), for the trim's counts
                value_at = r.strs(value_pool);
                value_ids.resize(value_at.size());
                for (auto& x : value_ids) x = r.i();
            } else if (E->model == 2) {
                Unigram& m = E->uni;
                read_ids(r, m.vocab);
                auto at = r.strs(m.scored.pool);
                std::vector<std::pair<int32_t, double>> vals(at.size());
                for (auto& v : vals) v.first = r.i();
                for (auto& v : vals) v.second = r.f();
                build_map(m.scored, at, vals);
                m.unk_id = r.i();
                m.unk_score = r.f();
                m.max_len = size_t(std::max(r.i(), 1));
            } else {
                throw Fail{E_INTERNAL};
            }
            E->trim = r.i();
            E->trim_space = uint32_t(r.i());
            if (E->trim >= 0 && E->model == 1) {
                int32_t top = 0;
                for (int32_t id : value_ids) top = std::max(top, id + 1);
                E->bpe_lead.assign(top, 0);
                E->bpe_trail.assign(top, 0);
                for (size_t k = 0; k < value_at.size(); k++)
                    if (value_ids[k] >= 0)
                        trim_counts(*E, value_pool.data() + value_at[k].first, value_at[k].second,
                                    E->bpe_lead[value_ids[k]], E->bpe_trail[value_ids[k]]);
            }
            for (int32_t k = r.i(); k > 0; k--) {
                int32_t id = r.i(), type = r.i();
                E->post_pre.push_back({id, type});
            }
            for (int32_t k = r.i(); k > 0; k--) {
                int32_t id = r.i(), type = r.i();
                E->post_suf.push_back({id, type});
            }
            E->post_type = r.i();
            E->raw = read_added(r);
            E->normed = read_added(r);
        }
        if (r.i() != MAGIC) throw Fail{E_INTERNAL};
    } catch (...) {
        delete E;
        throw;
    }
    return E;
}

void run_part(const Engine& E, const uint32_t* cps, const int64_t* starts, int64_t lo, int64_t hi, bool add_special,
              int64_t max_length, Out& out, int& err_kind, int64_t& err_index) {
    Ctx cx;
    for (int64_t k = lo; k < hi; k++) {
        try {
            encode_one(E, cps + starts[k], size_t(starts[k + 1] - starts[k]), add_special, max_length, cx, out);
        } catch (const Fail& f) {
            err_kind = f.kind, err_index = k;
            return;
        } catch (...) {
            err_kind = E_INTERNAL, err_index = k;
            return;
        }
    }
}

}  // namespace

extern "C" {

const char* tk_unidata() { return ut_unidata; }

// the engine of a serialized pipeline; null (and a message in err) when the program is malformed
void* tk_new(const int32_t* prog, int64_t n, char* err, int64_t err_len) {
    Reader r{prog, prog + n};
    try {
        return read_engine(r);
    } catch (...) {
        std::snprintf(err, size_t(err_len), "malformed tokenizer program at word %lld",
                      (long long)(r.p - prog));
        return nullptr;
    }
}

void tk_free(void* e) { delete static_cast<Engine*>(e); }

// encode texts [starts[k], starts[k+1]) of cps; max_length < 0: untruncated
void* tk_encode(void* e, const uint32_t* cps, const int64_t* starts, int64_t n_texts, int32_t add_special,
                int64_t max_length, int32_t n_threads) {
    const Engine& E = *static_cast<Engine*>(e);
    Result* res = new (std::nothrow) Result();
    if (!res) return nullptr;
    int64_t total = starts[n_texts] - starts[0];
    int64_t parts = 1;
    if (n_threads > 1 && total >= 65536) parts = std::min<int64_t>({n_threads, n_texts, total / 32768});
    parts = std::max<int64_t>(parts, 1);
    std::vector<int64_t> bounds(parts + 1, n_texts);
    bounds[0] = 0;
    for (int64_t k = 1; k < parts; k++) {
        int64_t target = starts[0] + total * k / parts;
        bounds[k] = std::max(bounds[k - 1], int64_t(std::lower_bound(starts, starts + n_texts, target) - starts));
    }
    std::vector<int> kinds(parts, E_OK);
    std::vector<int64_t> index(parts, -1);
    try {
        res->parts.resize(parts);
    } catch (...) {
        res->err_kind = E_INTERNAL;
        res->err_index = 0;
        return res;
    }
    // parts 1.. on threads of their own (a part whose thread cannot start
    // runs here), part 0 on the caller's
    std::vector<std::thread> threads;
    for (int64_t k = 1; k < parts; k++) {
        try {
            threads.emplace_back(run_part, std::cref(E), cps, starts, bounds[k], bounds[k + 1], bool(add_special),
                                 max_length, std::ref(res->parts[k]), std::ref(kinds[k]), std::ref(index[k]));
        } catch (...) {
            run_part(E, cps, starts, bounds[k], bounds[k + 1], add_special, max_length, res->parts[k], kinds[k],
                     index[k]);
        }
    }
    run_part(E, cps, starts, bounds[0], bounds[1], add_special, max_length, res->parts[0], kinds[0], index[0]);
    for (auto& t : threads) t.join();
    for (int64_t k = 0; k < parts; k++)
        if (kinds[k] != E_OK) {  // the first failing text, as the plain loop meets it
            res->err_kind = kinds[k], res->err_index = index[k];
            break;
        }
    return res;
}

int64_t tk_result_tokens(void* r) {
    int64_t n = 0;
    for (const Out& o : static_cast<Result*>(r)->parts) n += int64_t(o.ids.size());
    return n;
}

int32_t tk_result_error(void* r, int64_t* index) {
    Result* res = static_cast<Result*>(r);
    *index = res->err_index;
    return res->err_kind;
}

// splits: n_texts + 1 token offsets; offsets: 2 per token (start, end)
void tk_result_copy(void* r, int64_t* splits, int32_t* ids, int32_t* type_ids, int8_t* special, int32_t* offsets) {
    int64_t at = 0, row = 0;
    splits[0] = 0;
    for (const Out& o : static_cast<Result*>(r)->parts) {
        if (!o.ids.empty()) {
            std::memcpy(ids + at, o.ids.data(), o.ids.size() * sizeof(int32_t));
            std::memcpy(type_ids + at, o.type_ids.data(), o.type_ids.size() * sizeof(int32_t));
            std::memcpy(special + at, o.special.data(), o.special.size());
            std::memcpy(offsets + 2 * at, o.offsets.data(), o.offsets.size() * sizeof(int32_t));
        }
        for (int64_t len : o.lens) {
            splits[row + 1] = splits[row] + len;
            row++;
        }
        at += int64_t(o.ids.size());
    }
}

void tk_result_free(void* r) { delete static_cast<Result*>(r); }

}  // extern "C"
