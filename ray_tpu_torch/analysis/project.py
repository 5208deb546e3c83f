"""Whole-program project graph + the cross-module raylint rules.

Every rule before this module was per-function AST matching; the failure
modes that hurt most in a distributed control plane are *cross-process*
ones a single file cannot witness: a client ``call("method", ...)``
whose method no server ever registers, a config knob read that isn't in
the declaration table (so the read raises — or a typo'd override that
silently never takes effect), event-loop state handed to an executor
thread.  This module parses nothing itself — the engine summarizes each
file once (:func:`summarize`, JSON-serializable so summaries cache per
content hash) and :class:`ProjectGraph` joins the summaries into the
indexes the project rules consume:

- **RPC wire contract** — every endpoint registration
  (``RpcServer.register``/``register_raw``/``register_instance`` with
  its ``handle_*`` + prefix expansion) against every literal-name call
  site (``call``/``call_async``/``call_raw``/``call_raw_async``/
  ``call_raw_into``), with the handler's arity where the callable is
  resolvable and the lane (pickled vs raw) on both sides;
- **config knob table** — ``_flag("name", ...)`` declarations against
  every ``GLOBAL_CONFIG.<name>`` read and write, plus the docs/ knob
  tables;
- **thread confinement** — ``# raylint: confine=loop`` attribute
  annotations against executor/thread escape paths one call hop deep.

The dead-endpoint check is deliberately reference-based, not call-based:
an endpoint with no *indexed* call site may still be reached through a
dispatch wrapper (``self._call("collective_take", ...)``), a direct
in-process handler call (``raylet.handle_chaos_kill_worker(...)``), or
a non-Python client.  An endpoint counts as referenced when its name
appears as a string literal anywhere beyond its own registration, or
its ``handle_*`` attribute is referenced beyond its definition —
surfaces with callers wholly outside the tree (the C++ xlang gateway)
carry an explicit suppression instead.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ray_tpu_torch.analysis.engine import (
    FileContext,
    Finding,
    dotted,
    last_segment,
    project_rule,
)
from ray_tpu_torch.analysis import dataflow

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

#: client API -> the lane its payload travels on.
CALL_APIS = {
    "call": "pickled",
    "call_async": "pickled",
    "call_raw": "raw",
    "call_raw_async": "raw",
    "call_raw_into": "raw",
}

_IDENTIFIER = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{1,60}$")
_CONFINE_LINE = re.compile(r"#\s*raylint:\s*confine=loop")
_CONFIG_CTOR = "_flag"
_CONTAINER_CTORS = {"dict", "defaultdict", "OrderedDict", "list", "set",
                    "deque", "Counter"}
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore"}
_MUTATORS = {"append", "add", "setdefault", "update", "extend", "insert",
             "appendleft"}
_EXECUTORISH = re.compile(r"executor|pool", re.I)


def empty_summary() -> dict:
    return {"registrations": [], "calls": [], "knob_decls": [],
            "knob_reads": [], "knob_writes": [], "str_literals": {},
            "handle_refs": [], "classes": {},
            "torch_extract": dataflow.empty_extract()}


# ----------------------------------------------------------- summarize


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _signature(fn: ast.AST, drop_self: bool) -> dict:
    args = fn.args
    names = [a.arg for a in args.args]
    if drop_self and names and names[0] in ("self", "cls"):
        names = names[1:]
    required = len(names) - len(args.defaults)
    return {"required": max(required, 0), "total": len(names),
            "vararg": args.vararg is not None}


def _lambda_signature(fn: ast.Lambda) -> dict:
    args = fn.args
    required = len(args.args) - len(args.defaults)
    return {"required": max(required, 0), "total": len(args.args),
            "vararg": args.vararg is not None}


def _class_methods(cls: ast.ClassDef) -> Dict[str, ast.AST]:
    return {n.name: n for n in cls.body if isinstance(n, _FUNC_NODES)}


def _class_methods_with_bases(ctx: FileContext,
                              cls: ast.ClassDef) -> Dict[str, ast.AST]:
    """Methods including same-file base classes (derived wins), since
    the runtime's register_instance walks dir(obj) — an inherited
    handle_* registers too.  Out-of-file bases stay unresolvable; a
    server built that way carries an RL014 suppression."""
    out: Dict[str, ast.AST] = {}
    seen = {cls.name}
    stack = [cls]
    while stack:
        cur = stack.pop(0)
        for name, m in _class_methods(cur).items():
            out.setdefault(name, m)
        for base in cur.bases:
            if isinstance(base, ast.Name) and base.id not in seen:
                seen.add(base.id)
                for top in ast.walk(ctx.tree):
                    if isinstance(top, ast.ClassDef) and \
                            top.name == base.id:
                        stack.append(top)
                        break
    return out


def _instance_class(ctx: FileContext, node: ast.Call,
                    arg: ast.AST) -> Optional[ast.ClassDef]:
    """The class behind a register_instance target: `self` resolves to
    the enclosing class; a bare name assigned from `ClassName(...)` in
    the same function resolves to that same-file class."""
    if isinstance(arg, ast.Name) and arg.id == "self":
        return ctx.enclosing_class(node)
    if isinstance(arg, ast.Name):
        fn = ctx.enclosing_function(node)
        scope = fn if fn is not None else ctx.tree
        for sub in ast.walk(scope):
            if isinstance(sub, ast.Assign) and \
                    isinstance(sub.value, ast.Call) and \
                    any(isinstance(t, ast.Name) and t.id == arg.id
                        for t in sub.targets):
                ctor = sub.value.func
                if isinstance(ctor, ast.Name):
                    for top in ast.walk(ctx.tree):
                        if isinstance(top, ast.ClassDef) and \
                                top.name == ctor.id:
                            return top
    return None


def _resolve_handler(ctx: FileContext, node: ast.AST,
                     enclosing_cls: Optional[ast.ClassDef]) -> Optional[dict]:
    """Best-effort signature of a handler expression: a lambda, a
    ``self._method`` in the enclosing class, or a module-level def."""
    if isinstance(node, ast.Lambda):
        return _lambda_signature(node)
    attr = _self_attr(node)
    if attr is not None and enclosing_cls is not None:
        m = _class_methods_with_bases(ctx, enclosing_cls).get(attr)
        if m is not None:
            return _signature(m, drop_self=True)
        return None
    if isinstance(node, ast.Name):
        for top in ctx.tree.body:
            if isinstance(top, _FUNC_NODES) and top.name == node.id:
                return _signature(top, drop_self=False)
    return None


def _has_confine_marker(ctx: FileContext, lineno: int) -> bool:
    """Trailing ``# raylint: confine=loop`` on the line, or on a
    comment-only line directly above (same convention as suppressions)."""
    if 1 <= lineno <= len(ctx.lines) and \
            _CONFINE_LINE.search(ctx.lines[lineno - 1]):
        return True
    if lineno >= 2:
        above = ctx.lines[lineno - 2]
        return bool(above.lstrip().startswith("#")
                    and _CONFINE_LINE.search(above))
    return False


def _callable_escape(ctx: FileContext, expr: ast.AST,
                     method: ast.AST) -> Optional[dict]:
    """Summarize what an escaped callable can reach: a self-method name,
    or (for a closure/lambda defined in `method`) the self attrs it
    touches and self methods it calls directly."""
    if isinstance(expr, ast.Call):
        # functools.partial(self.m, ...) — unwrap one level.
        if last_segment(dotted(expr.func)) == "partial" and expr.args:
            return _callable_escape(ctx, expr.args[0], method)
        return None
    target = _self_attr(expr)
    if target is not None:
        return {"target": target, "touches": [], "calls": []}
    node: Optional[ast.AST] = None
    if isinstance(expr, ast.Lambda):
        node = expr
    elif isinstance(expr, ast.Name):
        for sub in ast.walk(method):
            if isinstance(sub, _FUNC_NODES) and sub.name == expr.id:
                node = sub
                break
    if node is None:
        return None
    touches: Set[str] = set()
    calls: Set[str] = set()
    for sub in ast.walk(node):
        attr = _self_attr(sub)
        if attr is not None:
            parent = ctx.parent(sub)
            if isinstance(parent, ast.Call) and parent.func is sub:
                calls.add(attr)
            else:
                touches.add(attr)
    return {"target": None, "touches": sorted(touches),
            "calls": sorted(calls)}


def _summarize_class(ctx: FileContext, cls: ast.ClassDef) -> dict:
    methods = _class_methods(cls)
    confined: Dict[str, int] = {}
    init_containers: Dict[str, int] = {}
    has_lock = False
    for node in ast.walk(cls):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            val = node.value
            for tgt in targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                if _has_confine_marker(ctx, node.lineno):
                    confined.setdefault(attr, node.lineno)
                if isinstance(val, ast.Call):
                    seg = last_segment(dotted(val.func))
                    if seg in _LOCK_CTORS:
                        has_lock = True
                    elif seg in _CONTAINER_CTORS:
                        init_containers.setdefault(attr, node.lineno)
                elif isinstance(val, (ast.Dict, ast.List, ast.Set)):
                    init_containers.setdefault(attr, node.lineno)

    method_info: Dict[str, dict] = {}
    escapes: List[dict] = []
    for name, m in methods.items():
        touches: Set[str] = set()
        mutates: Set[str] = set()
        calls: Set[str] = set()
        for sub in ast.walk(m):
            attr = _self_attr(sub)
            if attr is not None:
                parent = ctx.parent(sub)
                if isinstance(parent, ast.Call) and parent.func is sub:
                    calls.add(attr)
                else:
                    touches.add(attr)
                if isinstance(parent, ast.Subscript):
                    gp = ctx.parent(parent)
                    if isinstance(gp, (ast.Assign, ast.AugAssign, ast.Delete)):
                        mutates.add(attr)
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _MUTATORS:
                recv = _self_attr(sub.func.value)
                if recv is not None:
                    mutates.add(recv)
            # Escape points: callables handed to another thread.
            if not isinstance(sub, ast.Call):
                continue
            seg = last_segment(dotted(sub.func)) or (
                sub.func.attr if isinstance(sub.func, ast.Attribute)
                else "")
            escaped_expr = None
            if seg == "run_in_executor" and len(sub.args) >= 2:
                escaped_expr = sub.args[1]
            elif seg == "Thread":
                for kw in sub.keywords:
                    if kw.arg == "target":
                        escaped_expr = kw.value
            elif seg == "submit" and sub.args and \
                    isinstance(sub.func, ast.Attribute) and \
                    _EXECUTORISH.search(dotted(sub.func.value) or ""):
                escaped_expr = sub.args[0]
            if escaped_expr is None:
                continue
            info = _callable_escape(ctx, escaped_expr, m)
            if info is not None:
                info["line"] = sub.lineno
                info["method"] = name
                escapes.append(info)
        method_info[name] = {"touches": sorted(touches),
                             "mutates": sorted(mutates),
                             "calls": sorted(calls)}
    return {"confined": confined, "init_containers": init_containers,
            "has_lock": has_lock, "methods": method_info,
            "escapes": escapes}


def summarize(ctx: FileContext) -> dict:
    """One file's JSON-serializable contribution to the project graph."""
    out = empty_summary()
    literals: Dict[str, int] = out["str_literals"]
    handle_refs: Set[str] = set()

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if _IDENTIFIER.match(node.value):
                literals[node.value] = literals.get(node.value, 0) + 1
        elif isinstance(node, ast.Attribute):
            if node.attr.startswith("handle_"):
                handle_refs.add(node.attr)
            recv = dotted(node.value)
            if recv is not None and recv.rsplit(".", 1)[-1] == \
                    "GLOBAL_CONFIG" and not node.attr.startswith("_"):
                parent = ctx.parent(node)
                if isinstance(parent, ast.Call) and parent.func is node:
                    continue  # GLOBAL_CONFIG.refresh() — a method, not a knob
                kind = "knob_writes" if isinstance(node.ctx, ast.Store) \
                    else "knob_reads"
                out[kind].append({"name": node.attr, "line": node.lineno})
        elif isinstance(node, ast.Name) and node.id.startswith("handle_"):
            handle_refs.add(node.id)

        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        attr = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        lit0 = node.args[0].value if node.args and \
            isinstance(node.args[0], ast.Constant) and \
            isinstance(node.args[0].value, str) else None

        if attr == _CONFIG_CTOR and isinstance(fn, ast.Name) and lit0:
            out["knob_decls"].append({"name": lit0, "line": node.lineno})
        elif attr in ("register", "register_raw") and \
                isinstance(fn, ast.Attribute) and lit0 and \
                len(node.args) >= 2:
            cls = ctx.enclosing_class(node)
            out["registrations"].append({
                "name": lit0, "line": node.lineno,
                "lane": "raw" if attr == "register_raw" else "pickled",
                "via": attr, "literal": True, "handler_attr": None,
                "sig": _resolve_handler(ctx, node.args[1], cls)})
        elif attr == "register_instance" and isinstance(fn, ast.Attribute) \
                and node.args:
            prefix = ""
            if len(node.args) > 1 and isinstance(node.args[1], ast.Constant):
                prefix = node.args[1].value
            for kw in node.keywords:
                if kw.arg == "prefix" and isinstance(kw.value, ast.Constant):
                    prefix = kw.value.value
            cls = _instance_class(ctx, node, node.args[0])
            if cls is not None:
                for mname, m in _class_methods_with_bases(
                        ctx, cls).items():
                    if not mname.startswith("handle_"):
                        continue
                    out["registrations"].append({
                        "name": prefix + mname[len("handle_"):],
                        "line": m.lineno, "lane": "pickled",
                        "via": "register_instance", "literal": False,
                        "handler_attr": mname,
                        "sig": _signature(m, drop_self=True)})
        elif attr in CALL_APIS and isinstance(fn, ast.Attribute) and lit0:
            out["calls"].append({"name": lit0, "line": node.lineno,
                                 "api": attr, "lane": CALL_APIS[attr]})

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef) and \
                ctx.enclosing_class(node) is None:
            out["classes"][node.name] = _summarize_class(ctx, node)

    out["handle_refs"] = sorted(handle_refs)
    out["torch_extract"] = dataflow.torch_extract(ctx)
    return out


# ---------------------------------------------------------------- graph


class ProjectGraph:
    """Join of every file summary: the whole-program indexes RL014-016
    read.  Built fresh each run (milliseconds of dict work) from
    summaries that are themselves cached per file content hash."""

    def __init__(self, summaries: Dict[str, dict],
                 display_by_file: Dict[str, str]):
        self.display_by_file = display_by_file
        self._abspath_by_display = {v: k for k, v in
                                    display_by_file.items()}
        self.endpoints: Dict[str, List[dict]] = {}
        self.calls: Dict[str, List[dict]] = {}
        self.knob_decls: Dict[str, List[dict]] = {}
        self.knob_reads: Dict[str, List[dict]] = {}
        self.knob_writes: Dict[str, List[dict]] = {}
        self.literal_counts: Dict[str, int] = {}
        self.handle_refs: Set[str] = set()
        self.classes: List[Tuple[str, str, dict]] = []  # (display, cls, data)
        #: from the per-file `torch_extract` sections
        #: (dataflow.torch_extract), each dict with file= attached: mesh
        #: declarations, logical-axis rule entries, logical axes at
        #: sharding call sites and PartitionSpec literals (RL023's join);
        #: modules with their import-time imports and CUDA
        #: initialisations, the forge's preimport list and the
        #: init-before-fork paths (RL024's).
        self.mesh_axes: List[dict] = []
        self.axis_rules: List[dict] = []
        self.logical_uses: List[dict] = []
        self.specs: List[dict] = []
        self.modules: Dict[str, dict] = {}
        self.preimports: List[str] = []
        self.fork_after_init: List[dict] = []
        self._config_files: List[str] = []

        for abspath, s in summaries.items():
            display = display_by_file.get(abspath, abspath)
            for r in s.get("registrations", ()):
                self.endpoints.setdefault(r["name"], []).append(
                    dict(r, file=display))
            for c in s.get("calls", ()):
                self.calls.setdefault(c["name"], []).append(
                    dict(c, file=display))
            for d in s.get("knob_decls", ()):
                self.knob_decls.setdefault(d["name"], []).append(
                    dict(d, file=display))
                if abspath not in self._config_files:
                    self._config_files.append(abspath)
            for d in s.get("knob_reads", ()):
                self.knob_reads.setdefault(d["name"], []).append(
                    dict(d, file=display))
            for d in s.get("knob_writes", ()):
                self.knob_writes.setdefault(d["name"], []).append(
                    dict(d, file=display))
            for lit, n in s.get("str_literals", {}).items():
                self.literal_counts[lit] = self.literal_counts.get(lit, 0) + n
            self.handle_refs.update(s.get("handle_refs", ()))
            for cname, cdata in s.get("classes", {}).items():
                self.classes.append((display, cname, cdata))
            tx = s.get("torch_extract") or {}
            for key in ("mesh_axes", "axis_rules", "logical_uses", "specs",
                        "fork_after_init"):
                getattr(self, key).extend(
                    dict(d, file=display) for d in tx.get(key, ()))
            if tx.get("module"):
                self.modules[tx["module"]] = {
                    "file": display, "imports": tx.get("imports", []),
                    "cuda_at_import": tx.get("cuda_at_import", [])}
            self.preimports.extend(tx.get("preimports", ()))

    def abspath_for(self, display: str) -> Optional[str]:
        return self._abspath_by_display.get(display)

    def referenced_beyond_registration(self, name: str,
                                       regs: List[dict]) -> bool:
        """Whether an endpoint name is reachable by anything the graph
        can see besides its own registration (see module docstring)."""
        literal_regs = sum(1 for r in regs if r.get("literal"))
        if self.literal_counts.get(name, 0) > literal_regs:
            return True
        return any(r.get("handler_attr") in self.handle_refs
                   for r in regs if r.get("handler_attr"))

    def docs_text(self) -> Optional[str]:
        """Concatenated ``docs/*.md`` of the repo that owns the config
        declarations; None when no docs directory exists (fixture trees
        without docs skip the documentation check)."""
        for config_file in self._config_files:
            root = os.path.dirname(os.path.abspath(config_file))
            while os.path.isfile(os.path.join(root, "__init__.py")):
                root = os.path.dirname(root)
            docs = os.path.join(root, "docs")
            if not os.path.isdir(docs):
                continue
            chunks = []
            for f in sorted(os.listdir(docs)):
                if f.endswith(".md"):
                    try:
                        with open(os.path.join(docs, f), "r",
                                  encoding="utf-8") as fh:
                            chunks.append(fh.read())
                    except OSError:
                        continue
            return "\n".join(chunks)
        return None


# ======================================================================
# RL014 rpc-contract
# ======================================================================


def _arity_ok(sig: Optional[dict]) -> bool:
    if sig is None:
        return True  # unresolvable handler: benefit of the doubt
    if sig["vararg"]:
        return True
    return sig["required"] <= 2 <= sig["total"]


@project_rule("RL014", "rpc-contract: call sites must target a registered "
                       "endpoint on the matching lane; handlers must take "
                       "(conn, data); registered endpoints must be "
                       "reachable")
def rl014_rpc_contract(graph: ProjectGraph) -> Iterable[Finding]:
    for name, sites in sorted(graph.calls.items()):
        regs = graph.endpoints.get(name)
        if not regs:
            for s in sites:
                yield Finding(
                    s["file"], s["line"], "RL014",
                    f"RPC {s['api']}(\"{name}\", ...) targets an endpoint "
                    "no server registers — the call can only ever fail "
                    "with 'no handler'; register the method, fix the "
                    "name, or annotate why the receiver is not an "
                    "RpcClient")
            continue
        lanes = {r["lane"] for r in regs}
        for s in sites:
            if s["lane"] not in lanes:
                want, have = s["lane"], "/".join(sorted(lanes))
                yield Finding(
                    s["file"], s["line"], "RL014",
                    f"lane mismatch: {s['api']}(\"{name}\", ...) sends a "
                    f"{want}-lane request but the endpoint is registered "
                    f"{have} — a raw client cannot parse a pickled reply "
                    "(nor vice versa); use the matching call/register "
                    "variant")
    for name, regs in sorted(graph.endpoints.items()):
        for r in regs:
            if not _arity_ok(r.get("sig")):
                sig = r["sig"]
                yield Finding(
                    r["file"], r["line"], "RL014",
                    f"handler for endpoint '{name}' takes "
                    f"{sig['required']}..{sig['total']} args but the "
                    "RpcServer always invokes handler(conn, data) — the "
                    "first real request dies with a TypeError")
        if name in graph.calls:
            continue
        if graph.referenced_beyond_registration(name, regs):
            continue
        r = regs[0]
        yield Finding(
            r["file"], r["line"], "RL014",
            f"dead endpoint: '{name}' is registered but nothing in the "
            "tree calls it or references its name — remove it, wire a "
            "real caller, or annotate the out-of-tree caller")


# ======================================================================
# RL015 config-knob-drift
# ======================================================================

@project_rule("RL015", "config-knob-drift: every GLOBAL_CONFIG read/write "
                       "names a declared knob; every declared knob is read "
                       "somewhere and documented")
def rl015_config_knob_drift(graph: ProjectGraph) -> Iterable[Finding]:
    if not graph.knob_decls:
        return  # no declaration table in the linted tree: nothing to check
    for name, sites in sorted(graph.knob_reads.items()):
        if name in graph.knob_decls:
            continue
        for s in sites:
            yield Finding(
                s["file"], s["line"], "RL015",
                f"read of undeclared config knob '{name}' — there is no "
                "_flag() declaration, so this raises AttributeError on "
                "first touch; declare the knob or fix the typo")
    for name, sites in sorted(graph.knob_writes.items()):
        if name in graph.knob_decls:
            continue
        for s in sites:
            yield Finding(
                s["file"], s["line"], "RL015",
                f"write to undeclared config knob '{name}' — the override "
                "lands in a name nothing ever reads, so the intended "
                "setting silently stays at its default; declare the knob "
                "or fix the typo")
    docs = graph.docs_text()
    for name, decls in sorted(graph.knob_decls.items()):
        d = decls[0]
        if name not in graph.knob_reads:
            yield Finding(
                d["file"], d["line"], "RL015",
                f"config knob '{name}' is declared but never read in the "
                "linted tree — the documented behavior does not exist; "
                "wire a consumer or remove the declaration")
        if docs is not None and \
                re.search(r"\b%s\b" % re.escape(name), docs) is None:
            yield Finding(
                d["file"], d["line"], "RL015",
                f"config knob '{name}' is missing from the docs/ knob "
                "tables — add it to docs/CONFIG.md (or the owning "
                "subsystem doc)")


# ======================================================================
# RL016 loop-confined-escape
# ======================================================================


@project_rule("RL016", "loop-confined-escape: attributes marked "
                       "`# raylint: confine=loop` must not be reachable "
                       "from executor/thread escape paths; loop-confined "
                       "classes must annotate all their mutable state")
def rl016_loop_confined_escape(graph: ProjectGraph) -> Iterable[Finding]:
    for display, cname, cdata in graph.classes:
        confined = cdata.get("confined") or {}
        if not confined:
            continue
        methods = cdata.get("methods", {})

        def reachable_attrs(esc: dict) -> Set[str]:
            touches = set(esc.get("touches", ()))
            frontier = set(esc.get("calls", ()))
            target = esc.get("target")
            if target and target in methods:
                touches |= set(methods[target]["touches"])
                frontier |= set(methods[target]["calls"])
            # One call hop: methods invoked by the escaped callable.
            for m in frontier:
                if m in methods:
                    touches |= set(methods[m]["touches"])
            return touches

        for esc in cdata.get("escapes", ()):
            hit = sorted(reachable_attrs(esc) & set(confined))
            if hit:
                yield Finding(
                    display, esc["line"], "RL016",
                    f"loop-confined state self.{hit[0]} of {cname} is "
                    "reachable from a thread/executor escape in "
                    f"'{esc['method']}' — confine=loop attributes are "
                    "mutated without locks BY DESIGN, so an off-loop "
                    "touch is a data race; marshal back onto the loop "
                    "(call_soon_threadsafe) or drop the annotation and "
                    "add locking")
        if cdata.get("has_lock"):
            continue  # mixed locking discipline: the annotation only
            # promises what it covers
        for attr, line in sorted(cdata.get("init_containers", {}).items()):
            if attr in confined:
                continue
            mutated = any(attr in m["mutates"] for m in methods.values())
            if mutated:
                yield Finding(
                    display, line, "RL016",
                    f"self.{attr} is mutable steady-state container "
                    f"state in {cname}, whose other attributes are "
                    "annotated `# raylint: confine=loop` — annotate it "
                    "too (it lives on the same loop) or protect it with "
                    "a lock; unannotated siblings are where the next "
                    "off-loop touch lands unreviewed")
