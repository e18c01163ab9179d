"""A copy of perceive_tpu/sources/fs.py, with its third-party imports made
lazy: ``yaml`` loads at the first front-matter block and ``zstandard`` at
the first compress or decompress, so that importing the connector needs
neither.  A front-matter file on a machine without ``yaml`` fails its read
loudly (the read stage reports it) rather than losing its metadata.

Filesystem connector: gitignore-aware tree walk -> Items.

Behavior parity with the reference FileScanner (crates/
perceive-core/sources/fs.rs:17-193): glob filter over a root directory,
hidden/.gitignore'd entries skipped, mtime/atime captured at scan time,
``read`` loads UTF-8 text (Omit on binary/empty), YAML front matter becomes
name/description/author metadata with the body as content and the original
bytes zstd(3)-compressed into raw_content, and ``reprocess`` re-parses front
matter from stored raw bytes.

The glob and gitignore matchers are implemented here (no pathspec in the
image): ``_glob_to_regex`` supports *, **, ?, [...] like the reference's
globset; gitignore handling covers the common pattern forms (name, dir/,
anchored /, *, negation !).
"""

from __future__ import annotations

import os
import re
from typing import Optional

from ..types import Item, ItemCompareStrategy, ItemMetadata
from .scanner import FoundItem, ReadResult

ZSTD_LEVEL = 3


def _utf8_path(path: str) -> bool:
    """False for paths carrying surrogate escapes (non-UTF-8 filename bytes
    from os.scandir / the native walker).  SQLite refuses to bind surrogate
    strings, and a single such external_id would kill the single write stage
    mid-scan — skip the file with a note instead (the reference's Rust walk
    skips non-UTF-8 paths the same way, via Path::to_str)."""
    try:
        path.encode("utf-8")
        return True
    except UnicodeEncodeError:
        import sys

        print(f"skipping non-UTF-8 filename: {path!r}", file=sys.stderr)
        return False


def compress_raw(data: bytes) -> bytes:
    import zstandard

    return zstandard.ZstdCompressor(level=ZSTD_LEVEL).compress(data)


def decompress_raw(data: bytes) -> bytes:
    import zstandard

    return zstandard.ZstdDecompressor().decompress(data)


# -- glob matching -----------------------------------------------------------


def _glob_to_regex(glob: str) -> str:
    """Translate a globset-style pattern to a regex over the full path."""
    out, i, n = [], 0, len(glob)
    while i < n:
        c = glob[i]
        if c == "*":
            if glob[i : i + 3] == "**/":
                out.append("(?:[^/]+/)*")
                i += 3
                continue
            if glob[i : i + 2] == "**":
                out.append(".*")
                i += 2
                continue
            out.append("[^/]*")
        elif c == "?":
            out.append("[^/]")
        elif c == "[":
            j = i + 1
            if j < n and glob[j] in "!^":
                j += 1
            if j < n and glob[j] == "]":
                j += 1
            while j < n and glob[j] != "]":
                j += 1
            if j < n:
                cls = glob[i + 1 : j].replace("!", "^", 1) if glob[i + 1] == "!" else glob[i + 1 : j]
                out.append(f"[{cls}]")
                i = j
            else:
                out.append(re.escape(c))
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


class GlobSet:
    """Match a path against any of several glob patterns.

    Like the reference (fs.rs:26-34): empty set matches everything; a bare
    pattern with no slash matches against the basename (globset semantics
    for patterns like ``*.md``).
    """

    def __init__(self, globs: list[str]):
        self._basename: list[re.Pattern] = []
        self._full: list[re.Pattern] = []
        for g in globs:
            rx = re.compile(_glob_to_regex(g) + r"\Z")
            (self._full if "/" in g else self._basename).append(rx)
        self.match_all = not globs

    def matches(self, path: str) -> bool:
        if self.match_all:
            return True
        base = os.path.basename(path)
        return any(r.match(base) for r in self._basename) or any(
            r.match(path) for r in self._full
        )


# -- gitignore ---------------------------------------------------------------


class _GitignoreRules:
    def __init__(self, lines: list[str], base: str):
        self.base = base.rstrip("/")
        self.rules: list[tuple[re.Pattern, bool, bool]] = []  # (rx, negate, dir_only)
        for raw in lines:
            line = raw.rstrip("\n")
            if not line.strip() or line.startswith("#"):
                continue
            negate = line.startswith("!")
            if negate:
                line = line[1:]
            dir_only = line.endswith("/")
            line = line.rstrip("/")
            anchored = line.startswith("/") or "/" in line
            line = line.lstrip("/")
            body = _glob_to_regex(line)
            if anchored:
                rx = re.compile(body + r"\Z")
            else:  # match at any depth
                rx = re.compile(r"(?:.*/)?" + body + r"\Z")
            self.rules.append((rx, negate, dir_only))

    def ignored(self, rel: str, is_dir: bool) -> Optional[bool]:
        """Last matching rule wins (gitignore semantics); None = no opinion."""
        verdict: Optional[bool] = None
        for rx, negate, dir_only in self.rules:
            if dir_only and not is_dir:
                continue
            if rx.match(rel):
                verdict = not negate
        return verdict

    def rebased(self, base: str) -> "_GitignoreRules":
        """Same compiled rules anchored at a different directory — lets one
        parsed global-gitignore template serve every repo root in a scan."""
        r = _GitignoreRules.__new__(_GitignoreRules)
        r.rules = self.rules
        r.base = base
        return r


def global_ignore_path() -> Optional[str]:
    """The user's global gitignore file, honored like the reference's
    `ignore` crate (fs.rs:42-45 WalkBuilder defaults).  Resolution:
    PERCEIVE_TPU_GLOBAL_GITIGNORE env override (also how tests pin it),
    core.excludesfile from ~/.gitconfig (best effort), then
    $XDG_CONFIG_HOME/git/ignore, then ~/.config/git/ignore."""
    env = os.environ.get("PERCEIVE_TPU_GLOBAL_GITIGNORE")
    if env is not None:
        return env if env and os.path.isfile(env) else None
    gitconfig = os.path.expanduser("~/.gitconfig")
    if os.path.isfile(gitconfig):
        try:
            with open(gitconfig, encoding="utf-8", errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if line.lower().startswith("excludesfile"):
                        _, _, val = line.partition("=")
                        p = os.path.expanduser(val.strip())
                        if os.path.isfile(p):
                            return p
        except OSError:
            pass
    xdg = os.environ.get("XDG_CONFIG_HOME") or os.path.expanduser("~/.config")
    p = os.path.join(xdg, "git", "ignore")
    return p if os.path.isfile(p) else None


def _load_ignore_file(path: str, base: str) -> Optional[_GitignoreRules]:
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            r = _GitignoreRules(f.read().splitlines(), base)
            return r if r.rules else None
    except OSError:
        return None


def _dir_rule_chain(dirpath: str, rules: tuple, memo: Optional[dict] = None) -> tuple:
    """Extend the inherited rule chain with this directory's ignore files.

    Precedence (git semantics; later in the chain wins in _ignored):
    global ignore < .git/info/exclude < .gitignore < .ignore — the first two
    load only where a `.git` marker makes the directory a repo root.  The
    `.ignore` file (same syntax, ignore-crate extension) outranks
    `.gitignore` in the same directory, matching the reference's walker.

    ``memo`` (one per scan) caches the ~/.gitconfig resolution and the
    parsed global-ignore template so a tree full of repos doesn't re-read
    and re-compile the same two files at every repo root (the ingest host
    has one core).
    """
    if os.path.exists(os.path.join(dirpath, ".git")):
        if memo is None:
            gp = global_ignore_path()
            tmpl = _load_ignore_file(gp, dirpath) if gp else None
            r = tmpl
        else:
            if "gp" not in memo:
                memo["gp"] = global_ignore_path()
                memo["tmpl"] = (
                    _load_ignore_file(memo["gp"], "") if memo["gp"] else None
                )
            r = memo["tmpl"].rebased(dirpath) if memo["tmpl"] else None
        if r:
            rules = (*rules, r)
        r = _load_ignore_file(os.path.join(dirpath, ".git", "info", "exclude"), dirpath)
        if r:
            rules = (*rules, r)
    for name in (".gitignore", ".ignore"):
        r = _load_ignore_file(os.path.join(dirpath, name), dirpath)
        if r:
            rules = (*rules, r)
    return rules


def _root_parent_chain(root: str) -> tuple:
    """Rules inherited from ABOVE the walk root: when the root sits inside a
    git repository, the repo root's exclude/global files and every
    .gitignore/.ignore on the path down to the root apply (the reference's
    walker discovers parents the same way)."""
    ancestors: list[str] = []
    cur = os.path.dirname(os.path.abspath(root))
    repo_root = None
    while cur and cur != os.path.dirname(cur):
        ancestors.append(cur)
        if os.path.exists(os.path.join(cur, ".git")):
            repo_root = cur
            break
        cur = os.path.dirname(cur)
    if repo_root is None:
        return ()
    rules: tuple = ()
    for d in reversed(ancestors):  # repo root first, nearest parent last
        rules = _dir_rule_chain(d, rules)
    return rules


# -- front matter ------------------------------------------------------------

_FM_RE = re.compile(r"\A---\s*\n(.*?)\n---\s*\n?", re.DOTALL)


def parse_front_matter(content: str, metadata: ItemMetadata) -> Optional[str]:
    """YAML front matter -> metadata; returns the body, or None when the file
    has no front matter (reference fs.rs:103-114)."""
    m = _FM_RE.match(content)
    if not m:
        return None
    import yaml

    # libyaml C loader when present: ~7x less parse CPU per front-matter
    # block (same safe_load semantics)
    loader = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
    try:
        data = yaml.load(m.group(1), Loader=loader) or {}
    except yaml.YAMLError:
        return None
    if not isinstance(data, dict):
        return None
    def as_str(value):
        """YAML values can be dates/lists/dicts; only strings (or simple
        scalars coerced) may reach metadata — a datetime title would crash
        the embed stage's str handling and abort the scan (the
        reference's typed gray_matter struct got this for free)."""
        if value is None:
            return None
        if isinstance(value, str):
            return value
        if isinstance(value, (int, float, bool)):
            return str(value)
        import datetime

        if isinstance(value, (datetime.date, datetime.datetime)):
            return value.isoformat()
        return None  # lists/dicts: treat as absent

    metadata.name = as_str(data.get("title")) or as_str(data.get("name")) or metadata.name
    metadata.description = (
        as_str(data.get("description")) or as_str(data.get("summary")) or metadata.description
    )
    author = as_str(data.get("author"))
    metadata.author = author if author is not None else metadata.author
    return content[m.end() :]


# -- scanner -----------------------------------------------------------------


class FileScanner:
    """(reference fs.rs:17-101)"""

    def __init__(self, source_id: int, location: str, config: dict):
        self.source_id = source_id
        self.location = location
        self.globs = GlobSet(list(config.get("globs", [])))

    def scan(self, emit) -> None:
        """Walk ``location``, emitting an Item per matching file with
        mtime/atime stamped (content loaded later by ``read``).

        Uses the native parallel walker (perceive_tpu_torch.native.fastwalk, the
        C++ analog of the reference's `ignore` crate parallel walk) when the
        toolchain is available, else the Python walk below."""
        root = os.path.abspath(self.location)

        from ..native import fastwalk

        entries = fastwalk(root)
        if entries is not None:
            for path, mtime, atime in sorted(entries):
                # globs match ROOT-RELATIVE paths: full-path patterns like
                # '**/*.md' can never match an absolute path's leading '/'
                if self.globs.matches(os.path.relpath(path, root)) and _utf8_path(path):
                    emit(
                        Item(
                            id=-1,
                            source_id=self.source_id,
                            external_id=path,
                            metadata=ItemMetadata(mtime=mtime, atime=atime),
                        )
                    )
            return
        self._scan_python(root, emit)

    def _scan_python(self, root: str, emit) -> None:
        # iterative walk (deep trees would blow Python's recursion limit);
        # each stack entry carries its inherited ignore-rule chain, seeded
        # with rules discovered ABOVE the root (enclosing repo)
        stack: list[tuple[str, tuple[_GitignoreRules, ...]]] = [
            (root, _root_parent_chain(root))
        ]
        memo: dict = {}  # per-scan global-ignore cache (_dir_rule_chain)
        while stack:
            dirpath, rules = stack.pop()
            rules = _dir_rule_chain(dirpath, rules, memo)
            try:
                entries = sorted(os.scandir(dirpath), key=lambda e: e.name)
            except OSError:
                entries = []
            for entry in entries:
                if entry.name.startswith("."):  # hidden (ignore-crate default)
                    continue
                try:
                    is_dir = entry.is_dir(follow_symlinks=False)
                    is_file = entry.is_file(follow_symlinks=False)
                except OSError:
                    continue
                if self._ignored(entry.path, is_dir, rules):
                    continue
                if is_dir:
                    stack.append((entry.path, rules))
                elif (
                    is_file
                    and self.globs.matches(os.path.relpath(entry.path, root))
                    and _utf8_path(entry.path)
                ):
                    try:
                        st = entry.stat(follow_symlinks=False)
                    except OSError:
                        continue
                    emit(
                        Item(
                            id=-1,
                            source_id=self.source_id,
                            external_id=entry.path,
                            metadata=ItemMetadata(
                                mtime=int(st.st_mtime), atime=int(st.st_atime)
                            ),
                        )
                    )

    @staticmethod
    def _ignored(path: str, is_dir: bool, stack) -> bool:
        verdict = False
        for rules in stack:  # outer rules first; inner files override
            rel = os.path.relpath(path, rules.base).replace(os.sep, "/")
            v = rules.ignored(rel, is_dir)
            if v is not None:
                verdict = v
        return verdict

    def read(
        self,
        existing: Optional[FoundItem],
        compare_strategy: ItemCompareStrategy,
        item: Item,
    ) -> ReadResult:
        """(reference fs.rs:48-78): Omit on unreadable/binary/empty; front
        matter split -> metadata + compressed raw."""
        try:
            with open(item.external_id, "rb") as f:
                data = f.read()
            content = data.decode("utf-8")
        except (OSError, UnicodeDecodeError):
            return ReadResult.OMIT
        if not content.strip():
            return ReadResult.OMIT

        body = parse_front_matter(content, item.metadata)
        if body is not None:
            item.content = body
            item.raw_content = compress_raw(data)
        else:
            item.content = content
        return ReadResult.FOUND

    def latest_process_version(self) -> int:
        return 0

    def reprocess(self, item: Item) -> ReadResult:
        """Re-run front-matter extraction from stored raw bytes
        (reference fs.rs:84-100)."""
        if item.raw_content is not None:
            import zstandard

            try:
                content = decompress_raw(item.raw_content).decode("utf-8")
            except (zstandard.ZstdError, UnicodeDecodeError):
                return ReadResult.UNCHANGED
        elif item.content is not None:
            content = item.content
        else:
            return ReadResult.UNCHANGED
        body = parse_front_matter(content, item.metadata)
        if body is not None:
            item.content = body
            return ReadResult.FOUND
        return ReadResult.UNCHANGED
