"""Rule engine for raylint: file walking, suppressions, reporting.

A rule is a function ``fn(ctx: FileContext) -> Iterable[Finding]``
registered with the :func:`rule` decorator.  The engine parses each file
once, hands every rule the same :class:`FileContext` (source, lines,
tree, parent links), filters findings through the suppression comments,
and aggregates.  Rules never import the code they lint — everything is
syntactic, so the linter runs in milliseconds with no cluster, no torch,
and no import side effects.

Two rule kinds exist since the whole-program pass landed:

- **per-file rules** (:func:`rule`) see one :class:`FileContext` at a
  time and depend on nothing outside it — their findings are cacheable
  per file content hash;
- **project rules** (:func:`project_rule`) run once per invocation over
  the :class:`ray_tpu_torch.analysis.project.ProjectGraph`, the cross-file
  index of RPC endpoint registrations vs call sites, config knob
  declarations vs reads, and thread-confinement annotations.

Incremental mode (``--incremental``) caches each file's per-file
findings and its project-graph contribution under
``.raylint_torch_cache/``
keyed by content hash; an unchanged file is never re-parsed, and the
project rules re-run each time over the (cached) contributions, so warm
runs report findings identical to cold ones.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import time
from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

# ---------------------------------------------------------------- findings


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def as_dict(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message}


# ------------------------------------------------------------------- rules

#: rule id -> (checker, one-line description)
RULES: Dict[str, tuple] = {}

#: rule id -> (checker(graph) -> Iterable[Finding], description) — run once
#: per invocation over the ProjectGraph, after every file is summarized.
PROJECT_RULES: Dict[str, tuple] = {}

#: rule id -> human-readable file-set scope, shown by `--list-rules`.
#: Kept separate from the (fn, desc) tuples so their shape — unpacked
#: at every call site — stays stable.
RULE_SCOPES: Dict[str, str] = {}

#: Retired rule ids -> the rule that superseded them. Selecting one via
#: `--rules` is a loud error (exit 2 with the pointer), never a silent
#: no-op: a CI invocation pinned to a retired id must fail, not pass
#: with zero findings.
RETIRED_RULES: Dict[str, str] = {"RL006": "RL020"}


def rule(rule_id: str, description: str, scope: str = "all files"):
    """Register a rule checker under `rule_id` (e.g. "RL002")."""

    def deco(fn: Callable[["FileContext"], Iterable[Finding]]):
        RULES[rule_id] = (fn, description)
        RULE_SCOPES[rule_id] = scope
        return fn

    return deco


def project_rule(rule_id: str, description: str, scope: str = "whole program"):
    """Register a whole-program rule checker under `rule_id`."""

    def deco(fn):
        PROJECT_RULES[rule_id] = (fn, description)
        RULE_SCOPES[rule_id] = scope
        return fn

    return deco


def all_rule_ids() -> List[str]:
    return sorted(list(RULES) + list(PROJECT_RULES))


# ------------------------------------------------------------ file context


class FileContext:
    """One parsed file, shared by every rule."""

    def __init__(self, path: str, display_path: str, source: str):
        self.path = path
        self.display_path = display_path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # Parent links let rules climb from a node to its enclosing
        # function/loop/with without every rule re-implementing the walk.
        self._parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return anc
        return None

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        for anc in self.ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc
        return None

    def finding(self, node_or_line, rule_id: str, message: str) -> Finding:
        line = (node_or_line if isinstance(node_or_line, int)
                else getattr(node_or_line, "lineno", 1))
        return Finding(self.display_path, line, rule_id, message)


# ------------------------------------------------------------ AST helpers


def dotted(node: ast.AST) -> Optional[str]:
    """'self._ckpt_lock' / 'time.sleep' for Name/Attribute chains, else
    None (calls, subscripts and literals have no stable dotted name)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_segment(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def walk_excluding_nested_functions(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that does not descend into nested function bodies — code
    in a nested def runs when the closure is *called*, not where it is
    defined, so e.g. it does not execute under an enclosing `with lock`.
    """
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        yield cur
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(cur))


def statements(body: Sequence[ast.stmt]) -> Iterator[ast.stmt]:
    """All statements in `body`, recursively, excluding nested defs."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:
                yield from statements(sub)
        for handler in getattr(stmt, "handlers", ()) or ():
            yield from statements(handler.body)


_LOCKISH = re.compile(r"(^|_)(lock|mutex|mu)($|_|\d)|_lock$|lock$")


def is_lockish(name: Optional[str]) -> bool:
    """Does a dotted name look like a threading lock?  Matches the
    codebase's naming discipline (`_lock`, `_ckpt_lock`, `_state_lock`,
    `send_lock`, `_link_lock`); deliberately does not match `clock` or
    `blocked`."""
    seg = last_segment(name).lower()
    if not seg or seg.endswith("clock"):
        return False
    return bool(_LOCKISH.search(seg))


# ---------------------------------------------------------- suppressions


_DISABLE_LINE = re.compile(r"#\s*raylint:\s*disable=([A-Za-z0-9_,\s]+)")
_DISABLE_FILE = re.compile(r"#\s*raylint:\s*disable-file=([A-Za-z0-9_,\s]+)")


def _parse_rule_list(text: str) -> List[str]:
    return [t.strip().upper() for t in text.split(",") if t.strip()]


def _is_mention(line: str, start: int) -> bool:
    """A marker whose '#' is immediately preceded by a quote or backtick
    is DOCUMENTATION quoting the syntax (docstrings, rule-catalog
    comments: ``# raylint: disable=...``), not a live directive —
    without this, the unused-suppression audit flags every place the
    syntax is explained."""
    return start > 0 and line[start - 1] in "`'\""


class Suppressions:
    def __init__(self, lines: List[str]):
        self.by_line: Dict[int, List[str]] = {}
        self.comment_only: set = set()
        self.file_wide: List[Tuple[int, str]] = []  # (line, rule-or-ALL)
        for i, line in enumerate(lines, start=1):
            m = _DISABLE_LINE.search(line)
            if m and not _is_mention(line, m.start()):
                self.by_line[i] = _parse_rule_list(m.group(1))
                if line.lstrip().startswith("#"):
                    self.comment_only.add(i)
            if i <= 10:
                m = _DISABLE_FILE.search(line)
                if m and not _is_mention(line, m.start()):
                    self.file_wide.extend(
                        (i, r) for r in _parse_rule_list(m.group(1)))

    def _matches(self, ln: int, rid: str) -> Optional[Tuple[int, str]]:
        rules = self.by_line.get(ln)
        if rules:
            if rid in rules:
                return (ln, rid)
            if "ALL" in rules:
                return (ln, "ALL")
        return None

    def match(self, finding: Finding) -> Optional[Tuple[int, str]]:
        """The (line, rule) key of the suppression comment that covers
        `finding`, or None — the key feeds the unused-suppression audit.
        """
        rid = finding.rule.upper()
        for ln, r in self.file_wide:
            if r == rid or r == "ALL":
                return (ln, r)
        # Trailing comment on the flagged line, or a COMMENT-ONLY line
        # directly above it (for lines too long to carry the marker).
        # The comment-only check matters: a trailing marker on the
        # previous code line must not leak onto this one and silently
        # suppress an unannotated neighboring violation.
        m = self._matches(finding.line, rid)
        if m is not None:
            return m
        if finding.line - 1 in self.comment_only:
            return self._matches(finding.line - 1, rid)
        return None

    def suppressed(self, finding: Finding) -> bool:
        return self.match(finding) is not None

    def all_keys(self) -> List[Tuple[int, str]]:
        """Every suppression comment in the file as (line, rule) keys."""
        keys = [(ln, r) for ln, rules in self.by_line.items()
                for r in rules]
        keys.extend(self.file_wide)
        return keys


# --------------------------------------------------------------- running


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    for path in paths:
        if os.path.isfile(path):
            yield path
        elif os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        else:
            raise FileNotFoundError(path)


def _run_file_rules(ctx: FileContext,
                    timings: Optional[Dict[str, float]] = None,
                    only: Optional[set] = None) -> List[Finding]:
    """Per-file rules over one context, unfiltered by suppressions.
    `only` restricts which rules run — it must stay None whenever the
    result lands in the incremental cache (cached entries are complete;
    selection then happens at report time)."""
    out: List[Finding] = []
    for rid, (checker, _desc) in sorted(RULES.items()):
        if only is not None and rid not in only:
            continue
        t0 = time.perf_counter()
        out.extend(checker(ctx))
        if timings is not None:
            timings[rid] = timings.get(rid, 0.0) + time.perf_counter() - t0
    return out


# ------------------------------------------------------ incremental cache
#
# One JSON file per linted tree (default
# `.raylint_torch_cache/cache.json`
# under the cwd): {fingerprint, files: {abspath: {hash, findings,
# summary}}}.  `hash` is the sha256 of the file's bytes; `fingerprint`
# hashes the analysis package's own sources, so editing a rule (or this
# engine) invalidates everything — a stale cache can never mask a rule
# change.  Findings are cached RAW (pre-suppression, all rules):
# suppression comments are file content too, so they are re-parsed each
# run from the bytes the hash already covers.

#: Not the JAX package's `.raylint_cache`: each linter fingerprints its
#: own sources, so a shared cache.json would be thrown away by
#: whichever of the two ran last.
CACHE_DIR_DEFAULT = ".raylint_torch_cache"
_CACHE_SCHEMA = 1


def _tool_fingerprint() -> str:
    h = hashlib.sha256(str(_CACHE_SCHEMA).encode())
    here = os.path.dirname(os.path.abspath(__file__))
    for name in sorted(os.listdir(here)):
        if name.endswith(".py"):
            with open(os.path.join(here, name), "rb") as f:
                h.update(name.encode())
                h.update(f.read())
    return h.hexdigest()


class LintCache:
    def __init__(self, cache_dir: str):
        self.dir = cache_dir
        self.path = os.path.join(cache_dir, "cache.json")
        self.fingerprint = _tool_fingerprint()
        self.files: Dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self._dirty = False

    @classmethod
    def load(cls, cache_dir: str) -> "LintCache":
        cache = cls(cache_dir)
        try:
            with open(cache.path, "r", encoding="utf-8") as f:
                data = json.load(f)
            if data.get("fingerprint") == cache.fingerprint:
                cache.files = data.get("files", {})
        except (OSError, ValueError):
            pass  # cold-cache fallback: everything re-analyzes
        return cache

    def get(self, path: str, content_hash: str,
            need_findings: bool = True) -> Optional[dict]:
        entry = self.files.get(path)
        if entry is not None and entry.get("hash") == content_hash and \
                (not need_findings or entry.get("findings") is not None):
            self.hits += 1
            return entry
        self.misses += 1
        return None

    def put_summary(self, path: str, content_hash: str,
                    summary: dict) -> None:
        """Cache a graph contribution WITHOUT per-file findings (files
        pulled in only for package closure); ``findings: None`` keeps a
        later full run from mistaking it for a complete entry."""
        self.files[path] = {"hash": content_hash, "findings": None,
                            "summary": summary}
        self._dirty = True

    def put(self, path: str, content_hash: str, findings: List[Finding],
            summary: dict) -> None:
        self.files[path] = {
            "hash": content_hash,
            "findings": [{"line": f.line, "rule": f.rule,
                          "message": f.message} for f in findings],
            "summary": summary,
        }
        self._dirty = True

    def prune_missing(self) -> None:
        # Only files that no longer exist leave the cache: an invocation
        # over a SUBSET of the tree must not evict the rest (that would
        # turn the next full gate run fully cold).
        for path in list(self.files):
            if not os.path.isfile(path):
                del self.files[path]
                self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"fingerprint": self.fingerprint,
                           "files": self.files}, f)
            os.replace(tmp, self.path)
        except OSError:
            pass  # cache is an optimization; never fail the lint for it


@dataclass
class UnusedSuppression:
    path: str
    line: int
    rule: str


@dataclass
class LintResult:
    """Everything one lint pass produced: the unsuppressed findings plus
    the side channels the CLI surfaces (per-rule timings, cache hit
    counts, suppression-usage audit)."""

    findings: List[Finding]
    timings: Dict[str, float]
    unused_suppressions: List[UnusedSuppression]
    cache_hits: int = 0
    cache_misses: int = 0


def _display_for(path: str, cwd: str) -> str:
    display = os.path.relpath(path, cwd)
    if display.startswith(".." + os.sep):
        display = path
    return display


def _package_closure(requested: Sequence[str]) -> List[str]:
    """Every ``*.py`` of each package that owns a requested file.

    Project rules are whole-program joins: run over a path SUBSET they
    see a partial graph and report nonsense (every registration in one
    file is "dead", every cross-file call "unregistered").  So the graph
    is always built over the full owning package — the highest ancestor
    directory still carrying an ``__init__.py`` — while findings are
    only reported for the files actually requested.  Files outside any
    package (fixtures in a bare tmp dir) contribute just themselves."""
    roots: List[str] = []
    for path in requested:
        d = os.path.dirname(os.path.abspath(path))
        top: Optional[str] = None
        while os.path.isfile(os.path.join(d, "__init__.py")):
            top = d
            d = os.path.dirname(d)
        if top is not None and top not in roots:
            roots.append(top)
    extra: List[str] = []
    seen = set(os.path.abspath(p) for p in requested)
    for root in roots:
        for f in iter_python_files([root]):
            a = os.path.abspath(f)
            if a not in seen:
                seen.add(a)
                extra.append(a)
    return extra


def lint_file(path: str, rule_ids: Optional[Sequence[str]] = None,
              display_path: Optional[str] = None) -> List[Finding]:
    """Lint ONE file with the per-file rules (the fixture-test entry
    point).  Project rules need the whole-program graph — use
    :func:`lint_paths` for those."""
    display = display_path if display_path is not None else path
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    try:
        ctx = FileContext(path, display, source)
    except SyntaxError as e:
        return [Finding(display, e.lineno or 1, "RL000",
                        f"syntax error: {e.msg}")]
    sup = Suppressions(ctx.lines)
    out: List[Finding] = []
    for rid, (checker, _desc) in sorted(RULES.items()):
        if rule_ids is not None and rid not in rule_ids:
            continue
        for finding in checker(ctx):
            if not sup.suppressed(finding):
                out.append(finding)
    return out


def lint_paths(paths: Sequence[str],
               rule_ids: Optional[Sequence[str]] = None,
               *,
               incremental: bool = False,
               cache_dir: Optional[str] = None) -> List[Finding]:
    """Lint every ``*.py`` under `paths` with per-file AND project rules;
    returns unsuppressed findings sorted by (path, line, rule)."""
    return lint_paths_full(paths, rule_ids, incremental=incremental,
                           cache_dir=cache_dir).findings


def lint_paths_full(paths: Sequence[str],
                    rule_ids: Optional[Sequence[str]] = None,
                    *,
                    incremental: bool = False,
                    cache_dir: Optional[str] = None) -> LintResult:
    """The full pipeline: per-file pass (cache-aware), project-graph
    build, project rules, suppression filtering, suppression-usage
    audit.  `rule_ids` filters REPORTING only — every rule always runs
    so the cache stays complete and the unused-suppression audit sees
    the full picture."""
    from ray_tpu_torch.analysis import project as _project

    cwd = os.getcwd()
    timings: Dict[str, float] = {}
    cache: Optional[LintCache] = None
    if incremental:
        cache = LintCache.load(cache_dir or CACHE_DIR_DEFAULT)

    raw_by_file: Dict[str, List[Finding]] = {}
    sup_by_file: Dict[str, Suppressions] = {}
    display_by_file: Dict[str, str] = {}
    summaries: Dict[str, dict] = {}

    files = list(iter_python_files(paths))
    requested = set()
    for path in files:
        abspath = os.path.abspath(path)
        requested.add(abspath)
        display = _display_for(abspath, cwd)
        display_by_file[abspath] = display
        with open(path, "rb") as f:
            blob = f.read()
        source = blob.decode("utf-8")
        sup_by_file[abspath] = Suppressions(source.splitlines())
        content_hash = hashlib.sha256(blob).hexdigest()
        entry = cache.get(abspath, content_hash) if cache is not None \
            else None
        if entry is not None:
            raw_by_file[abspath] = [
                Finding(display, d["line"], d["rule"], d["message"])
                for d in entry["findings"]]
            summaries[abspath] = entry["summary"]
            continue
        try:
            ctx = FileContext(abspath, display, source)
        except SyntaxError as e:
            raw = [Finding(display, e.lineno or 1, "RL000",
                           f"syntax error: {e.msg}")]
            summary = _project.empty_summary()
        else:
            # With a --rules subset and no cache to fill, unselected
            # per-file rules can be skipped outright (report-time
            # filtering would discard their findings anyway).
            only = None if (cache is not None or rule_ids is None) \
                else set(rule_ids)
            raw = _run_file_rules(ctx, timings, only)
            t0 = time.perf_counter()
            summary = _project.summarize(ctx)
            timings["index"] = timings.get("index", 0.0) \
                + time.perf_counter() - t0
        raw_by_file[abspath] = raw
        summaries[abspath] = summary
        if cache is not None:
            cache.put(abspath, content_hash, raw, summary)

    # ---- package closure: the project graph must always see the whole
    # owning package, even when only a subset was requested — a partial
    # graph calls every registration dead and every cross-file call
    # unregistered.  Closure files contribute summaries only; their
    # per-file rules don't run and their findings are never reported.
    t0 = time.perf_counter()
    for abspath in _package_closure(files):
        display_by_file[abspath] = _display_for(abspath, cwd)
        try:
            with open(abspath, "rb") as f:
                blob = f.read()
            source = blob.decode("utf-8")
        except (OSError, UnicodeDecodeError):
            continue
        content_hash = hashlib.sha256(blob).hexdigest()
        entry = cache.get(abspath, content_hash, need_findings=False) \
            if cache is not None else None
        if entry is not None:
            summaries[abspath] = entry["summary"]
            continue
        try:
            ctx = FileContext(abspath, display_by_file[abspath], source)
            summary = _project.summarize(ctx)
        except SyntaxError:
            summary = _project.empty_summary()
        summaries[abspath] = summary
        if cache is not None:
            cache.put_summary(abspath, content_hash, summary)
    timings["index"] = timings.get("index", 0.0) + time.perf_counter() - t0

    # ---- project pass: build the graph, run whole-program rules.
    t0 = time.perf_counter()
    graph = _project.ProjectGraph(summaries, display_by_file)
    timings["graph"] = time.perf_counter() - t0
    for rid, (checker, _desc) in sorted(PROJECT_RULES.items()):
        t0 = time.perf_counter()
        for finding in checker(graph):
            abspath = graph.abspath_for(finding.path) or finding.path
            if abspath not in requested:
                continue  # closure-only file: out of reporting scope
            raw_by_file.setdefault(abspath, []).append(finding)
        timings[rid] = timings.get(rid, 0.0) + time.perf_counter() - t0

    if cache is not None:
        cache.prune_missing()
        cache.save()

    # ---- suppression filtering + usage audit.
    findings: List[Finding] = []
    unused: List[UnusedSuppression] = []
    for abspath, raw in raw_by_file.items():
        sup = sup_by_file.get(abspath)
        if sup is None:
            findings.extend(raw)
            continue
        used: set = set()
        for f in raw:
            key = sup.match(f)
            if key is not None:
                used.add(key)
            elif rule_ids is None or f.rule in rule_ids \
                    or f.rule == "RL000":
                # RL000 (syntax error) always reports: a --rules subset
                # must not let an unparseable file lint clean.
                findings.append(f)
        if rule_ids is None:
            # The audit only makes sense over a full run: with a --rules
            # subset, a suppression for an unselected rule merely never
            # got the chance to match.
            display = display_by_file.get(abspath, abspath)
            for key in sup.all_keys():
                if key not in used:
                    unused.append(UnusedSuppression(display, key[0], key[1]))

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    unused.sort(key=lambda u: (u.path, u.line, u.rule))
    return LintResult(
        findings=findings, timings=timings, unused_suppressions=unused,
        cache_hits=cache.hits if cache is not None else 0,
        cache_misses=cache.misses if cache is not None else 0)
