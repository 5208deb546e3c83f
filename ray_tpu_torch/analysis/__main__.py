"""CLI: ``python -m ray_tpu_torch.analysis [paths] [--format ...] [--rules ...]``.

Exit-code contract (documented in docs/ANALYSIS.md, pinned by tests):

- **0** — no unsuppressed finding (and, with
  ``--report-unused-suppressions``, no stale suppression comment);
- **1** — at least one unsuppressed finding (or stale suppression when
  auditing them);
- **2** — usage error (unknown rule id, missing path, bad flag combo).

``--format {text,json,sarif}`` selects the findings encoding (``--json``
stays as an alias for ``--format json``); SARIF 2.1.0 output lets CI
attach findings as annotations.  ``--incremental`` caches per-file
results under ``.raylint_torch_cache/`` (content-hash keyed, cold-cache safe);
``--timings`` prints a per-rule wall-time table to stderr so a slow rule
is visible before it bloats the gate.  ``--sleep-report`` is a side tool
for the test-budget audit: it sums literal ``time.sleep`` seconds (times
constant loop bounds) per test function so heavy tests can be found and
marked ``@pytest.mark.slow`` before they drift the tier-1 suite into its
timeout.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from typing import List, Tuple

from ray_tpu_torch.analysis.engine import (
    CACHE_DIR_DEFAULT,
    PROJECT_RULES,
    RETIRED_RULES,
    RULES,
    RULE_SCOPES,
    FileContext,
    all_rule_ids,
    dotted,
    iter_python_files,
    lint_paths_full,
)


def _default_paths() -> List[str]:
    import ray_tpu_torch

    return [os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))]


# ------------------------------------------------------- sleep accounting


def _const_float(node: ast.AST) -> float:
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return float(node.value)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        return _const_float(node.left) * _const_float(node.right)
    return 0.0


def _trip_count(range_call: ast.Call) -> float:
    """Trip count of a `range(...)` loop; non-literal bounds count the
    loop once (factor 1.0) rather than zeroing the sleeps inside it —
    the report must under-estimate, never erase."""
    args = range_call.args
    stop = args[1] if len(args) > 1 else args[0]
    if not isinstance(stop, ast.Constant):
        return 1.0
    start = 0.0
    if len(args) > 1:
        if not isinstance(args[0], ast.Constant):
            return 1.0
        start = _const_float(args[0])
    return max(_const_float(stop) - start, 0.0)


def _loop_multiplier(fn: ast.AST, node: ast.AST, ctx: FileContext) -> float:
    """Product of constant trip counts of loops enclosing `node` in `fn`
    (unknown bounds count as 1 — the report under-estimates, it never
    invents)."""
    mult = 1.0
    cur = ctx.parent(node)
    while cur is not None and cur is not fn:
        if isinstance(cur, (ast.For, ast.AsyncFor)):
            it = cur.iter
            if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                    and it.func.id == "range" and it.args:
                mult *= _trip_count(it)
        cur = ctx.parent(cur)
    return mult


def sleep_report(paths: List[str]) -> List[Tuple[str, str, float]]:
    """(path, function, aggregate literal sleep seconds), descending."""
    rows: List[Tuple[str, str, float]] = []
    for path in iter_python_files(paths):
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        try:
            ctx = FileContext(path, path, source)
        except SyntaxError:
            continue
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            total = 0.0
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call):
                    name = dotted(sub.func) or ""
                    if name.endswith("sleep") and sub.args:
                        total += _const_float(sub.args[0]) \
                            * _loop_multiplier(fn, sub, ctx)
            if total > 0:
                rows.append((os.path.relpath(path), fn.name, total))
    rows.sort(key=lambda r: -r[2])
    return rows


# ----------------------------------------------------------------- main


def _sarif(findings) -> dict:
    """Minimal SARIF 2.1.0 document: one run, one result per finding,
    relative artifact URIs — the shape CI annotation uploaders accept."""
    descs = dict(RULES)
    descs.update(PROJECT_RULES)
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "raylint",
                "informationUri": "docs/ANALYSIS.md",
                "rules": [{"id": rid,
                           "shortDescription": {"text": desc}}
                          for rid, (_fn, desc) in sorted(descs.items())],
            }},
            "results": [{
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path.replace(os.sep, "/"),
                        "uriBaseId": "SRCROOT"},
                    "region": {"startLine": f.line},
                }}],
            } for f in findings],
        }],
    }


def _print_timings(timings) -> None:
    total = sum(timings.values())
    print(f"raylint timings ({total * 1000:.0f}ms total):", file=sys.stderr)
    for rid, secs in sorted(timings.items(), key=lambda kv: -kv[1]):
        print(f"  {rid:<8} {secs * 1000:8.1f}ms", file=sys.stderr)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.analysis",
        description="raylint: AST-based invariant checker for the "
                    "ray_tpu_torch control plane")
    parser.add_argument("paths", nargs="*",
                        help="files or directories (default: the ray_tpu_torch "
                             "package)")
    parser.add_argument("--format", choices=("text", "json", "sarif"),
                        default="text", dest="fmt",
                        help="findings encoding on stdout")
    parser.add_argument("--json", action="store_true",
                        help="alias for --format json")
    parser.add_argument("--rules",
                        help="comma-separated subset, e.g. RL001,RL014")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--incremental", action="store_true",
                        help="cache per-file results keyed by content hash "
                             "(cold-cache safe); project rules re-run over "
                             "the cached index every time")
    parser.add_argument("--cache-dir", default=CACHE_DIR_DEFAULT,
                        help="incremental cache location "
                             f"(default: {CACHE_DIR_DEFAULT})")
    parser.add_argument("--timings", action="store_true",
                        help="per-rule wall time on stderr")
    parser.add_argument("--report-unused-suppressions", action="store_true",
                        help="also report `# raylint: disable=...` comments "
                             "whose rule no longer fires there (full rule "
                             "set only: incompatible with --rules)")
    parser.add_argument("--sleep-report", action="store_true",
                        help="per-function aggregate literal sleep seconds "
                             "(test-budget audit), instead of linting")
    parser.add_argument("--sleep-threshold", type=float, default=0.0,
                        help="only report functions above this many seconds")
    args = parser.parse_args(argv)
    if args.json:
        args.fmt = "json"

    if args.list_rules:
        for rid in all_rule_ids():
            _fn, desc = RULES.get(rid) or PROJECT_RULES[rid]
            kind = "file" if rid in RULES else "project"
            title, sep, doc = desc.partition(": ")
            print(f"{rid}  [{kind}] {title}")
            if sep:
                print(f"       {' '.join(doc.split())}")
            print(f"       scope: {RULE_SCOPES.get(rid, 'all files')}")
        for rid, successor in sorted(RETIRED_RULES.items()):
            print(f"{rid}  [retired] superseded by {successor}")
        return 0

    paths = args.paths or _default_paths()

    if args.sleep_report:
        rows = [r for r in sleep_report(paths)
                if r[2] >= args.sleep_threshold]
        if args.fmt == "json":
            print(json.dumps([{"path": p, "function": fn, "sleep_s": s}
                              for p, fn, s in rows], indent=2))
        else:
            for p, fn, s in rows:
                print(f"{s:8.1f}s  {p}::{fn}")
        return 0

    rule_ids = None
    if args.rules:
        rule_ids = [r.strip().upper() for r in args.rules.split(",")]
        retired = [r for r in rule_ids if r in RETIRED_RULES]
        if retired:
            for r in retired:
                print(f"rule {r} is retired — superseded by "
                      f"{RETIRED_RULES[r]}; update the invocation "
                      f"(--rules {RETIRED_RULES[r]})", file=sys.stderr)
            return 2
        unknown = [r for r in rule_ids if r not in all_rule_ids()]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} — "
                  "`--list-rules` prints the catalog", file=sys.stderr)
            return 2
        if args.report_unused_suppressions:
            print("--report-unused-suppressions needs the full rule set "
                  "(a suppression for an unselected rule never gets the "
                  "chance to match); drop --rules", file=sys.stderr)
            return 2

    try:
        result = lint_paths_full(paths, rule_ids,
                                 incremental=args.incremental,
                                 cache_dir=args.cache_dir)
    except FileNotFoundError as e:
        print(f"no such path: {e}", file=sys.stderr)
        return 2

    findings = result.findings
    if args.fmt == "json":
        print(json.dumps([f.as_dict() for f in findings], indent=2))
    elif args.fmt == "sarif":
        print(json.dumps(_sarif(findings), indent=2))
    else:
        for f in findings:
            print(f.render())
        if findings:
            print(f"raylint: {len(findings)} finding(s)", file=sys.stderr)

    unused = result.unused_suppressions if args.report_unused_suppressions \
        else []
    for u in unused:
        print(f"{u.path}:{u.line}: unused suppression of {u.rule} — the "
              "rule no longer fires here; drop the comment",
              file=sys.stderr)

    if args.incremental:
        print(f"raylint cache: {result.cache_hits} unchanged, "
              f"{result.cache_misses} analyzed", file=sys.stderr)
    if args.timings:
        _print_timings(result.timings)
    return 1 if (findings or unused) else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # `... | head` closed the pipe: fine
        sys.exit(0)
