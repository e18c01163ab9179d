"""A copy of perceive_tpu/sources/readability.py.

Readability-grade article extraction (arc90 algorithm).

The reference delegates article extraction to the `readability` crate — a
port of Mozilla/arc90 Readability — plus html2text
(crates/perceive-core/sources/parse_html.rs:164-174).  This
module implements the same algorithm on lxml so real-world pages (nav bars,
comment threads, related-article rails, cookie banners) extract the ARTICLE,
not the chrome:

  1. score every text-bearing paragraph: 1 point + one per comma + one per
     100 chars (capped at 3);
  2. propagate each paragraph's points to its parent (x1) and grandparent
     (x0.5) — containers accumulate evidence from their paragraphs;
  3. weight containers by id/class hints (+25 article-ish, -25 chrome-ish)
     and by tag (article/main up, form/aside down);
  4. final score = accumulated * (1 - link_density);
  5. the winner absorbs SIBLINGS scoring >= 20% of it (multi-container
     articles) and any sibling <p> with real text;
  6. emit block-level text joined by newlines, whitespace-normalized.

Content quality feeds straight into embedding quality, so this is a
search-quality component, not cosmetics.
"""

from __future__ import annotations

import re

_POSITIVE_RE = re.compile(
    r"article|body|content|entry|hentry|h-entry|main|page|pagination|post|text|blog|story",
    re.I,
)
_NEGATIVE_RE = re.compile(
    r"-ad-|hidden|banner|combx|comment|com-|contact|foot|footer|footnote|gdpr|masthead|"
    r"media|meta|modal|outbrain|promo|related|scroll|share|shoutbox|sidebar|skyscraper|"
    r"sponsor|shopping|tags|widget|social|teaser|cookie|subscribe|newsletter|menu|nav|"
    r"breadcrumb|popup",
    re.I,
)
# unlikely candidates are dropped OUTRIGHT (whole subtree) unless they also
# look article-ish — this list must stay far narrower than _NEGATIVE_RE,
# which only subtracts 25 points at scoring time: hard-dropping on the broad
# list removed real content wrapped in ubiquitous class names like
# Bootstrap's "media" object or "meta"/"tags"/"teaser" blocks (arc90's
# unlikelyCandidates vs negative lists differ the same way)
_UNLIKELY_RE = re.compile(
    r"-ad-|\bad\b|banner|combx|comment|com-|disqus|foot|gdpr|masthead|outbrain|"
    r"promo|related|scroll|shoutbox|sidebar|skyscraper|sponsor|shopping|widget|"
    r"cookie|subscribe|newsletter|breadcrumb|popup|menu|nav",
    re.I,
)
_MAYBE_RE = re.compile(r"and|article|body|column|content|main|shadow", re.I)

_STRIP_TAGS = {
    "script", "style", "noscript", "template", "svg", "iframe", "form",
    "button", "object", "embed", "link", "select", "option", "dialog",
}
_STRUCTURAL_CHROME = {"nav", "header", "footer", "aside"}
_SCORE_PARENT_TAGS = {"p", "pre", "td", "blockquote", "li", "dd", "dt"}
_BLOCK_TAGS = {
    "p", "pre", "li", "blockquote", "h1", "h2", "h3", "h4", "h5", "h6",
    "td", "th", "dd", "dt", "figcaption", "caption", "summary",
}
_CANDIDATE_TAGS = {"div", "article", "section", "main", "td", "body", "blockquote"}


def _class_weight(el) -> float:
    idcls = f"{el.get('id') or ''} {el.get('class') or ''}"
    w = 0.0
    if _POSITIVE_RE.search(idcls):
        w += 25.0
    if _NEGATIVE_RE.search(idcls):
        w -= 25.0
    return w


def _tag_weight(tag: str) -> float:
    return {
        "article": 15.0, "main": 10.0, "section": 5.0, "div": 5.0,
        "td": 3.0, "blockquote": 3.0, "pre": 3.0,
        "body": 0.0, "form": -10.0, "ol": -3.0, "ul": -3.0, "dl": -3.0,
    }.get(tag, 0.0)


def _text_of(el) -> str:
    return el.text_content() or ""


def _link_density(el) -> float:
    total = len(_text_of(el).strip())
    if not total:
        return 1.0
    links = sum(len((_text_of(a)).strip()) for a in el.findall(".//a"))
    return min(1.0, links / total)


def _looks_unlikely(el) -> bool:
    idcls = f"{el.get('id') or ''} {el.get('class') or ''}"
    if not idcls.strip():
        return False
    return bool(_UNLIKELY_RE.search(idcls)) and not _MAYBE_RE.search(idcls)


def extract_title(doc) -> str:
    title = ""
    t = doc.find(".//title")
    if t is not None and t.text:
        title = t.text.strip()
    og = doc.find('.//meta[@property="og:title"]')
    if og is not None and og.get("content"):
        title = og.get("content").strip() or title
    if not title:
        h1 = doc.find(".//h1")
        if h1 is not None:
            title = _text_of(h1).strip()
    # strip trailing site-name decoration ("Headline | Site", "Headline - Site")
    # — only when the tail actually LOOKS like a site name (<= 3 words, no
    # sentence punctuation): a blanket strip truncated legitimate dash
    # clauses like "Understanding attention - and beyond"
    m = re.match(r"^(.{10,})\s+[|\-–—·»]\s+(\S[^|]{0,40})$", title)
    if m:
        tail = m.group(2).strip()
        if (
            len(tail.split()) <= 3
            and not re.search(r"[.!?,:;]", tail)
            and tail[:1].isupper()  # site names are capitalized; a
            # lowercase tail is a sentence clause ("... - and beyond")
        ):
            title = m.group(1).strip()
    return title


def extract_article(raw: bytes | str) -> tuple[str, str]:
    """(title, text) from raw HTML via the arc90 scoring above.  Empty
    strings when the document is unparseable or has no visible text."""
    import lxml.html

    try:
        doc = lxml.html.fromstring(raw)
    except Exception:
        return "", ""
    # (fromstring may root at a fragment — html/div/body are all handled
    # uniformly below, no special-casing needed)
    title = extract_title(doc)

    # 0. remove non-content machinery + structural chrome (materialize the
    # iterator first: drop_tree() mid-walk dead-ends inside the detached
    # subtree and leaves later chrome intact)
    for el in list(doc.iter()):
        if not isinstance(el.tag, str) or el.getparent() is None:
            continue
        if el.tag in _STRIP_TAGS or el.tag in _STRUCTURAL_CHROME:
            el.drop_tree()
        elif el.get("hidden") is not None or (el.get("aria-hidden") == "true"):
            el.drop_tree()
        elif el.tag == "div" and _looks_unlikely(el):
            el.drop_tree()

    # 1-2. paragraph scoring propagated to parents/grandparents
    scores: dict = {}

    def ensure(el) -> None:
        if el not in scores:
            scores[el] = _tag_weight(el.tag if isinstance(el.tag, str) else "") + _class_weight(el)

    for p in doc.iter():
        if not isinstance(p.tag, str) or p.tag not in _SCORE_PARENT_TAGS:
            continue
        text = re.sub(r"\s+", " ", _text_of(p)).strip()
        if len(text) < 25:
            continue
        points = 1.0 + text.count(",") + text.count("，") + min(len(text) / 100.0, 3.0)
        parent = p.getparent()
        if parent is None:
            continue
        ensure(parent)
        scores[parent] += points
        grand = parent.getparent()
        if grand is not None:
            ensure(grand)
            scores[grand] += points / 2.0

    best, best_score = None, 0.0
    for el, s in scores.items():
        if isinstance(el.tag, str) and el.tag not in _CANDIDATE_TAGS:
            continue
        final = s * (1.0 - _link_density(el))
        if final > best_score:
            best, best_score = el, final

    if best is None:
        body = doc.find(".//body")
        root_nodes = [body if body is not None else doc]
    else:
        # 5. absorb qualifying siblings around the winner
        parent = best.getparent()
        root_nodes = [best]
        if parent is not None:
            threshold = max(10.0, best_score * 0.2)
            for sib in parent:
                if sib is best:
                    continue
                if sib in scores and scores[sib] * (1.0 - _link_density(sib)) >= threshold:
                    root_nodes.append(sib)
                elif isinstance(sib.tag, str) and sib.tag == "p":
                    txt = re.sub(r"\s+", " ", _text_of(sib)).strip()
                    if len(txt) >= 80 or (len(txt) >= 25 and txt.endswith(".")):
                        root_nodes.append(sib)
            root_nodes.sort(key=lambda e: list(parent).index(e) if e in list(parent) else 0)

    # 6. emit leaf block text.  NO text-based dedup here: root_nodes are
    # disjoint siblings and the recursion visits each node once, so any
    # repeated text is genuinely repeated CONTENT (interview answers, table
    # cells, chorus lines) — a global seen-set dropped the repeats from the
    # stored article
    parts: list[str] = []
    leaf_tags = tuple(_BLOCK_TAGS)

    def emit(el) -> None:
        if isinstance(el.tag, str) and el.tag in _BLOCK_TAGS:
            if next(el.iterdescendants(*leaf_tags), None) is None:
                if _link_density(el) > 0.75 and el.tag not in ("h1", "h2", "h3"):
                    return  # link farms inside the article body
                txt = re.sub(r"\s+", " ", _text_of(el)).strip()
                if txt:
                    parts.append(txt)
                return
        # container with block descendants: recurse into block children, but
        # keep the container's DIRECT text flow — bare div text, br-separated
        # lines, and inline children (<b>, <a>, spans) outside any <p> are
        # article body too; dropping them extracted only the wrapped chrome
        run: list[str] = [el.text or ""]
        link_chars = 0

        def flush() -> None:
            nonlocal link_chars
            txt = re.sub(r"\s+", " ", " ".join(run)).strip()
            del run[:]
            if txt and link_chars / max(len(txt), 1) <= 0.75:
                parts.append(txt)
            link_chars = 0

        for child in el:
            if not isinstance(child.tag, str):  # comment/PI: keep its tail
                run.append(child.tail or "")
            elif (
                child.tag in _BLOCK_TAGS
                or next(child.iterdescendants(*leaf_tags), None) is not None
            ):
                flush()
                emit(child)
                run.append(child.tail or "")
            else:  # inline: contributes to this container's text flow
                t = _text_of(child)
                if child.tag == "a":
                    link_chars += len(t.strip())
                else:
                    link_chars += sum(
                        len(_text_of(a).strip()) for a in child.findall(".//a")
                    )
                run.append(t)
                run.append(child.tail or "")
        flush()

    for rn in root_nodes:
        if isinstance(rn.tag, str) and rn.tag in _BLOCK_TAGS and rn.tag != "td":
            txt = re.sub(r"\s+", " ", _text_of(rn)).strip()
            if txt:
                parts.append(txt)
        else:
            emit(rn)
    if not parts:
        root = root_nodes[0]
        txt = re.sub(r"\s+", " ", _text_of(root)).strip()
        parts = [txt] if txt else []
    return title, "\n".join(parts)
