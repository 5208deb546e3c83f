"""The raylint rule set: framework-specific invariants, statically.

Each rule targets a discipline the control plane depends on but that no
runtime test can prove on paths it never executes (see docs/ANALYSIS.md
for the catalog with real before/after examples):

- RL001 deferred-reply-leak    — DEFERRED replies must always complete
- RL002 blocking-under-lock    — nothing blocking under a control lock
- RL003 raw-buffer-leak        — put_raw segments freed on every path
- RL004 swallowed-exception    — broad excepts must log or re-raise
- RL005 thread-leak            — threads daemonized or joined
- RL007 static-lock-order      — lock acquisition graph is acyclic
- RL008 span-leak              — tracing spans always end()ed
- RL009 gang-without-death-hook — placement-grouped gangs abort cleanly
                                  and register group death handling
- RL010 retry-without-deadline — poll/retry loops carry a deadline or a
                                  bounded attempt count (the hang-shaped
                                  class the chaos plane hunts)
- RL011 unbounded-keyed-state  — per-key dicts on long-lived control-
                                  plane objects have an eviction path
                                  (the model-zoo churn leak shape)
- RL012 lease-cache-invalidation — structures caching worker/lease
                                  addresses show a death-hook or a
                                  sweep-against-liveness removal path
                                  (the stale-lease double-push shape)
- RL013 unbounded-block-buffer  — data-plane operators accumulating
                                  blocks into list/dict attributes show
                                  a budget/bound check or a drain path
                                  (the sustained-ingest OOM shape)
- RL017 deferred-reply-completeness — the interprocedural upgrade of
                                  RL001: a DEFERRED handler that hands
                                  (conn, msg_id) to a helper is traced
                                  one call hop to prove the helper
                                  replies, parks, or hands off on every
                                  path
- RL018 job-scoped-state       — dicts keyed by job identifiers are
                                  evicted on a job-teardown path (the
                                  multi-job platform's churn contract:
                                  job state dies WITH the job, not with
                                  an unrelated LRU — docs/JOBS.md)
- RL019 driver-materialization — data-plane code never collects a whole
                                  row/block iterator into driver memory
                                  (the query tier's scalability
                                  contract: drivers hold bounded
                                  metadata, operators run in the
                                  exchange — docs/DATA_QUERY.md)

(RL014 rpc-contract, RL015 config-knob-drift and RL016
loop-confined-escape are whole-program rules — they live in
:mod:`ray_tpu_torch.analysis.project` on top of the ProjectGraph.  RL006
jit-retrace-hazard is retired: RL020-RL024, the dataflow-powered torch
accelerator-hazard family, live in :mod:`ray_tpu_torch.analysis.torchrules`.)
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.analysis.engine import (
    FileContext,
    Finding,
    dotted,
    is_lockish,
    last_segment,
    rule,
    statements,
    walk_excluding_nested_functions,
)

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _functions(ctx: FileContext) -> Iterator[ast.AST]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, _FUNC_NODES):
            yield node


def _calls_in(node: ast.AST) -> Iterator[ast.Call]:
    for sub in walk_excluding_nested_functions(node):
        if isinstance(sub, ast.Call):
            yield sub


# =====================================================================
# RL001 deferred-reply-leak
# =====================================================================
#
# The RPC server's contract (core/rpc.py): a handler that returns
# DEFERRED owns the reply — some later code MUST call conn.reply /
# conn.reply_raw with the parked msg id, or the caller hangs until its
# client-side timeout.  Raising BEFORE the DEFERRED return is safe (the
# server loop converts it to an error reply); the two statically
# checkable leaks are:
#
#  (a) a completion closure (the code that runs later, off the server
#      thread) that can raise before its reply call with no except/
#      finally path that also replies — the parked caller hangs;
#  (b) a `raise` after the handler has already parked (conn, msg_id) in
#      a waiter structure — the server sends an error reply AND the
#      waiter drain later replies again to the same msg id.


def _returns_deferred(fn: ast.AST) -> Optional[int]:
    for sub in walk_excluding_nested_functions(fn):
        if (isinstance(sub, ast.Return)
                and last_segment(dotted(sub.value)) == "DEFERRED"):
            return sub.lineno
    return None


_REPLY_METHODS = {"reply", "reply_raw"}


def _is_reply_call(call: ast.Call, reply_fn_names: Set[str]) -> bool:
    name = dotted(call.func)
    return (last_segment(name) in _REPLY_METHODS
            or (name is not None and name in reply_fn_names))


def _nested_functions(fn: ast.AST) -> List[ast.AST]:
    out = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        cur = stack.pop()
        if isinstance(cur, _FUNC_NODES):
            out.append(cur)
        stack.extend(ast.iter_child_nodes(cur))
    return out


def _reply_fn_fixpoint(nested: List[ast.AST]) -> Set[str]:
    """Names of nested functions that (transitively) issue a reply."""
    names: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for nf in nested:
            if nf.name in names:
                continue
            for call in _calls_in(nf):
                if _is_reply_call(call, names):
                    names.add(nf.name)
                    changed = True
                    break
    return names


def _completion_guarded(nf: ast.AST, reply_fn_names: Set[str]) -> bool:
    """Every risky statement of a completion closure must sit inside a
    try whose except/finally also replies (the worker.py idiom:
    ``try: reply_ok(run()) except BaseException as e: reply_err(e)``)."""

    def try_replies(t: ast.Try) -> bool:
        for blk in list(t.handlers) + ([ast.Try(body=t.finalbody,
                                                handlers=[], orelse=[],
                                                finalbody=[])]
                                       if t.finalbody else []):
            body = blk.body if hasattr(blk, "body") else []
            for stmt in statements(body):
                for call in _calls_in(stmt):
                    if _is_reply_call(call, reply_fn_names):
                        return True
        return False

    def walk(body: Sequence[ast.stmt], guarded: bool) -> bool:
        for stmt in body:
            if isinstance(stmt, _FUNC_NODES):
                continue
            if isinstance(stmt, ast.Try):
                inner_ok = try_replies(stmt)
                if not walk(stmt.body, guarded or inner_ok):
                    return False
                for h in stmt.handlers:
                    if not walk(h.body, guarded):
                        return False
                if not walk(stmt.finalbody, guarded):
                    return False
                continue
            if (isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Call)
                    and _is_reply_call(stmt.value, reply_fn_names)):
                continue  # the reply itself
            has_call = any(True for _ in _calls_in(stmt))
            if (has_call or isinstance(stmt, ast.Raise)) and not guarded:
                return False
            for field in ("body", "orelse"):
                sub = getattr(stmt, field, None)
                if sub and not walk(sub, guarded):
                    return False
        return True

    return walk(nf.body, False)


def _msgid_vars(fn: ast.AST) -> Set[str]:
    out = {"current_msg_id"}
    for sub in walk_excluding_nested_functions(fn):
        if (isinstance(sub, ast.Assign)
                and last_segment(dotted(sub.value)) == "current_msg_id"):
            for tgt in sub.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _mentions_msgid(node: ast.AST, msgid_vars: Set[str]) -> bool:
    """A bare msg-id name, or `conn.current_msg_id` used inline (the
    one-liner park idiom: ``waiters.append((conn, conn.current_msg_id))``
    never binds a local)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in msgid_vars:
            return True
        if isinstance(n, ast.Attribute) and n.attr == "current_msg_id":
            return True
    return False


def _registration_line(fn: ast.AST, msgid_vars: Set[str]) -> Optional[int]:
    """Line of the first statement that stores a msg-id var into a waiter
    structure (an .append/.add call or a subscript/attribute store whose
    value mentions the var) — after this the reply is co-owned by the
    drain path.  The park call is matched by its attribute name so
    subscripted receivers (``slot["waiters"].append(...)``, which have
    no dotted name) count too."""
    for stmt in fn.body and statements(fn.body):
        if isinstance(stmt, _FUNC_NODES):
            continue
        if not _mentions_msgid(stmt, msgid_vars):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            func = stmt.value.func
            if isinstance(func, ast.Attribute) and \
                    func.attr in ("append", "add", "put", "setdefault"):
                return stmt.lineno
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, (ast.Subscript, ast.Attribute))
                for t in stmt.targets):
            return stmt.lineno
    return None


@rule("RL001", "deferred-reply-leak: a DEFERRED handler has a path that "
               "neither replies nor fails the parked caller")
def check_deferred_reply(ctx: FileContext) -> Iterable[Finding]:
    for fn in _functions(ctx):
        if ctx.enclosing_function(fn) is not None:
            continue  # visit outermost handlers; closures checked within
        deferred_line = _returns_deferred(fn)
        if deferred_line is None:
            continue
        nested = _nested_functions(fn)
        reply_fns = _reply_fn_fixpoint(nested)
        for nf in nested:
            if nf.name in reply_fns and not _completion_guarded(nf, reply_fns):
                yield ctx.finding(
                    nf, "RL001",
                    f"completion path '{nf.name}' of a DEFERRED reply can "
                    "raise before replying — the parked caller would hang; "
                    "wrap it so every exception path also replies "
                    "(try/except that sends the error)")
        reg_line = _registration_line(fn, _msgid_vars(fn))
        if reg_line is not None:
            for sub in walk_excluding_nested_functions(fn):
                if (isinstance(sub, ast.Raise)
                        and reg_line < sub.lineno < deferred_line):
                    yield ctx.finding(
                        sub, "RL001",
                        "raise after parking a DEFERRED waiter: the server "
                        "sends an error reply AND the waiter drain later "
                        "replies again to the same msg id — park last, or "
                        "unregister the waiter before raising")


# =====================================================================
# RL002 blocking-under-lock
# =====================================================================
#
# The static twin of lock_witness's watchdog: a blocking call under a
# control-plane lock turns every other thread that needs the lock into a
# hostage of the slow operation (and an RPC back to the lock holder
# deadlocks outright).  The witness only sees executed interleavings;
# this sees every path.

_BLOCKING_LAST = {"sleep", "result", "call", "call_raw", "call_raw_into",
                  "get_raw", "get_bytes", "allreduce", "allgather",
                  "reducescatter", "barrier"}
_SUBPROCESS_LAST = {"run", "Popen", "check_output", "check_call", "call"}


def _thread_vars(fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in walk_excluding_nested_functions(fn):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
            callee = dotted(sub.value.func)
            if last_segment(callee) == "Thread":
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
    return out


def _blocking_reason(call: ast.Call, thread_vars: Set[str],
                     held_locks: Sequence[Optional[str]] = ()) -> Optional[str]:
    name = dotted(call.func)
    # A dotted name can be unavailable (`self._kv().call`) while the
    # method name still is: fall back to the raw attribute.
    if name is None and isinstance(call.func, ast.Attribute):
        last = call.func.attr
        name = f"<expr>.{last}"
    else:
        last = last_segment(name)
    if name and name.startswith("subprocess.") and last in _SUBPROCESS_LAST:
        return f"subprocess call {name}()"
    if last in _BLOCKING_LAST:
        if last == "call" and name is not None and "." not in name:
            return None  # bare call() — not an RPC client method
        return f"blocking call {name or last}()"
    if last == "join" and name is not None:
        recv = name.rsplit(".", 1)[0]
        if recv in thread_vars or "thread" in recv.lower():
            return f"thread join {name}()"
    if last == "get":
        for kw in call.keywords:
            if kw.arg in ("timeout", "block"):
                return f"blocking queue get {name}()"
    if last == "wait" and (call.args or call.keywords):
        # Argument-carrying waits (Event.wait(timeout), Future.wait(...))
        # block under the lock like any other call. Condition.wait is
        # exempt: it holds its own lock by contract and releases it while
        # parked — recognized either by waiting on the very object the
        # `with` holds, or by a condition-ish receiver name.
        recv = (name or "").rsplit(".", 1)[0]
        if recv in held_locks or "cond" in recv.lower():
            return None
        return f"blocking wait {name or last}()"
    return None


@rule("RL002", "blocking-under-lock: blocking API called while holding a "
               "control-plane lock")
def check_blocking_under_lock(ctx: FileContext) -> Iterable[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        lock_names = [dotted(item.context_expr) for item in node.items
                      if is_lockish(dotted(item.context_expr))]
        if not lock_names:
            continue
        fn = ctx.enclosing_function(node)
        tvars = _thread_vars(fn) if fn is not None else set()
        for stmt in node.body:
            if isinstance(stmt, _FUNC_NODES):
                continue  # closure bodies run later, not under the lock
            # Calls inside a NESTED lock-with are attributed to the
            # innermost lock by that With's own pass of the outer walk —
            # scanning them here too would duplicate every finding once
            # per enclosing lock.
            nested: set = set()
            # walk_excluding_nested_functions yields descendants only, so
            # include stmt itself: the nested lock-with is often the
            # direct child statement of the outer body.
            for sub in (stmt, *walk_excluding_nested_functions(stmt)):
                if isinstance(sub, (ast.With, ast.AsyncWith)) and any(
                        is_lockish(dotted(item.context_expr))
                        for item in sub.items):
                    for inner in sub.body:
                        nested.update(walk_excluding_nested_functions(inner))
            for sub in walk_excluding_nested_functions(stmt):
                if sub in nested or not isinstance(sub, ast.Call):
                    continue
                reason = _blocking_reason(sub, tvars, lock_names)
                if reason is not None:
                    yield ctx.finding(
                        sub, "RL002",
                        f"{reason} while holding {lock_names[0]} — move "
                        "the blocking work outside the lock (snapshot "
                        "state under the lock, act on it after release)")


# =====================================================================
# RL003 raw-buffer-leak
# =====================================================================
#
# put_raw/put_bytes mint a store segment with NO ObjectRef and therefore
# no refcount GC — whoever holds the ObjectID owns the bytes until
# free_raw.  A function that creates one and neither hands ownership off
# nor guarantees the free on exception paths leaks a pinned segment per
# failure, which under load exhausts the store (the exact leak class the
# transfer plane's delete-on-failure paths exist to prevent).

_ALLOC_LAST = {"put_raw", "put_bytes", "make_buffer", "create_buffer"}
_FREE_LAST = {"free_raw", "free", "free_objects", "delete", "release"}


def _name_mentioned(node: ast.AST, var: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == var
               for n in ast.walk(node))


@rule("RL003", "raw-buffer-leak: put_raw segment not freed on every path")
def check_raw_buffer_leak(ctx: FileContext) -> Iterable[Finding]:
    for fn in _functions(ctx):
        allocs: List[Tuple[str, ast.Assign]] = []
        for sub in walk_excluding_nested_functions(fn):
            if (isinstance(sub, ast.Assign)
                    and isinstance(sub.value, ast.Call)
                    and last_segment(dotted(sub.value.func)) in _ALLOC_LAST
                    and len(sub.targets) == 1
                    and isinstance(sub.targets[0], ast.Name)):
                allocs.append((sub.targets[0].id, sub))
        for var, assign in allocs:
            escaped = False
            freed_in_finally = False
            freed_anywhere = False
            for sub in walk_excluding_nested_functions(fn):
                if sub is assign or getattr(sub, "lineno", 0) < assign.lineno:
                    continue
                if isinstance(sub, ast.Return) and sub.value is not None \
                        and _name_mentioned(sub.value, var):
                    escaped = True
                elif isinstance(sub, ast.Assign) \
                        and _name_mentioned(sub.value, var) \
                        and any(isinstance(t, (ast.Attribute, ast.Subscript))
                                for t in sub.targets):
                    # Stored into an attribute/container: ownership handed
                    # to whatever owns that structure.
                    escaped = True
                elif isinstance(sub, ast.Call):
                    callee = dotted(sub.func)
                    last = last_segment(callee)
                    mentioned = any(_name_mentioned(a, var)
                                    for a in list(sub.args)
                                    + [kw.value for kw in sub.keywords])
                    if not mentioned:
                        continue
                    if last in _FREE_LAST:
                        freed_anywhere = True
                        for anc in ctx.ancestors(sub):
                            if anc is fn:
                                break
                            if isinstance(anc, ast.Try) and any(
                                    s.lineno <= sub.lineno <= (
                                        getattr(s, "end_lineno", s.lineno)
                                        or s.lineno)
                                    for s in anc.finalbody):
                                freed_in_finally = True
                        continue
                    # Any other call taking the id transfers ownership
                    # (registry append, RPC carrying the id, constructor).
                    escaped = True
            if escaped:
                continue
            if not freed_anywhere:
                yield ctx.finding(
                    assign, "RL003",
                    f"'{var}' holds a raw store segment that is never "
                    "freed or handed off in this function — call "
                    "free_raw in a finally, or transfer ownership")
            elif not freed_in_finally:
                yield ctx.finding(
                    assign, "RL003",
                    f"'{var}' holds a raw store segment freed only on the "
                    "fall-through path — an exception between put_raw and "
                    "the free leaks the segment; move the free into a "
                    "finally")


# =====================================================================
# RL004 swallowed-exception
# =====================================================================
#
# A bare `except:`/`except Exception:` that neither re-raises nor logs
# can eat CollectiveError and task-cancellation signals — a rank death
# becomes a silent wrong answer instead of an abort.  Scoped to the
# packages where those signals travel (core/, collective/, inference/,
# serve/); an intentional best-effort swallow must say so: either narrow
# the type, log at debug, or carry a `# raylint: disable=RL004` (the
# codebase's `# noqa: BLE001 — reason` convention is honored too).

_RL004_PACKAGES = {"core", "collective", "inference", "serve"}
_LOGGISH = ("log", "warn", "exception", "print", "reply", "fail", "abort",
            "record", "error")


#: The package whose subpackages scope RL004, RL011, RL013, RL018, RL019.
PACKAGE = "ray_tpu_torch"


def _in_package_scope(path: str, packages: Set[str]) -> bool:
    # Scope from the file's real location, not its display path: the
    # display string is cwd-relative, and deriving scope from it made the
    # same tree lint clean from the repo root but dirty from inside the
    # package. The package root is the `ray_tpu_torch` directory that
    # actually carries an `__init__.py` (innermost wins, for checkouts
    # nested under a directory that happens to carry the same name).
    parts = os.path.abspath(path).replace("\\", "/").split("/")
    for idx in range(len(parts) - 1, -1, -1):
        if parts[idx] != PACKAGE:
            continue
        root = "/".join(parts[:idx + 1])
        if os.path.isfile(os.path.join(root, "__init__.py")):
            return len(parts) > idx + 2 and parts[idx + 1] in packages
    return True  # fixtures and out-of-tree files: always checked


def _in_scope_rl004(path: str) -> bool:
    return _in_package_scope(path, _RL004_PACKAGES)


def _broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    return any(isinstance(n, ast.Name)
               and n.id in ("Exception", "BaseException") for n in names)


@rule("RL004", "swallowed-exception: broad except neither re-raises nor "
               "logs (can eat CollectiveError/cancellation)")
def check_swallowed_exception(ctx: FileContext) -> Iterable[Finding]:
    if not _in_scope_rl004(ctx.path):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler) or not _broad_handler(node):
            continue
        line = ctx.lines[node.lineno - 1] if node.lineno <= len(ctx.lines) \
            else ""
        if "noqa" in line and "BLE001" in line:
            continue
        handled = False
        for stmt in statements(node.body):
            if isinstance(stmt, ast.Raise):
                handled = True
            for call in _calls_in(stmt):
                name = (dotted(call.func) or "").lower()
                if any(k in name for k in _LOGGISH):
                    handled = True
        if not handled:
            yield ctx.finding(
                node, "RL004",
                "broad except swallows the error silently — re-raise, log "
                "it, narrow the exception type, or annotate why it is safe")


# =====================================================================
# RL005 thread-leak
# =====================================================================
#
# A non-daemon thread with no tracked join outlives shutdown() and holds
# the interpreter (and the test suite) hostage; every long-lived loop in
# this codebase is `daemon=True` plus an explicit stop signal.


@rule("RL005", "thread-leak: Thread without daemon=True and no tracked join")
def check_thread_leak(ctx: FileContext) -> Iterable[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) \
                or last_segment(dotted(node.func)) != "Thread":
            continue
        name = dotted(node.func)
        if name not in ("threading.Thread", "Thread"):
            continue
        daemon_kw = next((kw for kw in node.keywords
                          if kw.arg == "daemon"), None)
        if daemon_kw is not None:
            # daemon=False is exactly the leak this rule exists to flag;
            # a non-constant value gets the benefit of the doubt.
            if not isinstance(daemon_kw.value, ast.Constant) \
                    or bool(daemon_kw.value.value):
                continue
        parent = ctx.parent(node)
        target_names: List[str] = []
        if isinstance(parent, ast.Assign):
            for tgt in parent.targets:
                tname = dotted(tgt)
                if tname:
                    target_names.append(tname)
        handled = False
        fn = ctx.enclosing_function(node)
        scope = fn if fn is not None else ctx.tree
        if target_names:
            for sub in ast.walk(ctx.tree if any("." in t
                                                for t in target_names)
                                else scope):
                if isinstance(sub, ast.Call):
                    callee = dotted(sub.func)
                    if callee and last_segment(callee) == "join" \
                            and callee.rsplit(".", 1)[0] in target_names:
                        handled = True
                if isinstance(sub, ast.Assign):
                    for tgt in sub.targets:
                        tname = dotted(tgt)
                        if tname and tname.endswith(".daemon") \
                                and tname.rsplit(".", 1)[0] in target_names:
                            handled = True
        if not handled:
            yield ctx.finding(
                node, "RL005",
                "thread is neither daemon=True nor joined — it will outlive "
                "shutdown and pin the process; pass daemon=True or track "
                "and join it")


# RL006 jit-retrace-hazard RETIRED: superseded by RL020 (torchrules.py:
# device-value control flow in per-step code, eager PyTorch's form of
# the hazard).  engine.RETIRED_RULES makes `--rules RL006` fail loudly
# with the pointer.


# =====================================================================
# RL007 static-lock-order
# =====================================================================
#
# The compile-time twin of lock_witness: per class, every lexically
# nested `with lock:` acquisition (including one hop through self-method
# calls) becomes an edge in a lock-order graph; a cycle is a lock-order
# inversion that will deadlock under the right timing even though no
# test ever produces that interleaving.  Self-edges are reported only
# for locks known to be plain (non-reentrant) Locks.


def _lock_key(cls_name: str, name: str) -> str:
    if name.startswith("self."):
        return f"{cls_name}.{name[len('self.'):]}"
    return name


def _class_lock_kinds(cls: ast.ClassDef) -> Dict[str, str]:
    """self attr -> 'lock' | 'rlock' for `self._x = threading.Lock()`."""
    kinds: Dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            callee = last_segment(dotted(node.value.func))
            if callee in ("Lock", "RLock"):
                for tgt in node.targets:
                    name = dotted(tgt)
                    if name and name.startswith("self."):
                        kinds[_lock_key(cls.name, name)] = callee.lower()
    return kinds


def _method_lock_info(cls: ast.ClassDef):
    """Per method: directly acquired lock keys and called self-methods."""
    methods: Dict[str, ast.AST] = {}
    for node in cls.body:
        if isinstance(node, _FUNC_NODES):
            methods[node.name] = node
    direct: Dict[str, Set[str]] = {}
    calls: Dict[str, Set[str]] = {}
    for mname, m in methods.items():
        locks: Set[str] = set()
        callees: Set[str] = set()
        for sub in walk_excluding_nested_functions(m):
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    name = dotted(item.context_expr)
                    if is_lockish(name):
                        locks.add(_lock_key(cls.name, name))
            elif isinstance(sub, ast.Call):
                callee = dotted(sub.func)
                if callee and callee.startswith("self.") \
                        and callee.count(".") == 1:
                    callees.add(callee[len("self."):])
        direct[mname] = locks
        calls[mname] = callees
    # Transitive may-acquire set per method (fixpoint over self-calls).
    may: Dict[str, Set[str]] = {m: set(direct[m]) for m in methods}
    changed = True
    while changed:
        changed = False
        for m in methods:
            for callee in calls[m]:
                if callee in may and not may[callee] <= may[m]:
                    may[m] |= may[callee]
                    changed = True
    return methods, may


@rule("RL007", "static-lock-order: cyclic lock acquisition order")
def check_lock_order(ctx: FileContext) -> Iterable[Finding]:
    edges: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], int] = {}

    def add_edge(a: str, b: str, line: int):
        if a == b:
            return
        edges.setdefault(a, set())
        if b not in edges[a]:
            edges[a].add(b)
            sites[(a, b)] = line

    self_deadlocks: List[Tuple[str, int]] = []

    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        kinds = _class_lock_kinds(cls)
        methods, may = _method_lock_info(cls)
        for mname, m in methods.items():
            for w in walk_excluding_nested_functions(m):
                if not isinstance(w, (ast.With, ast.AsyncWith)):
                    continue
                held = [_lock_key(cls.name, dotted(i.context_expr))
                        for i in w.items
                        if is_lockish(dotted(i.context_expr))]
                if not held:
                    continue
                for sub in walk_excluding_nested_functions(
                        ast.Module(body=w.body, type_ignores=[])):
                    if isinstance(sub, (ast.With, ast.AsyncWith)):
                        for item in sub.items:
                            name = dotted(item.context_expr)
                            if is_lockish(name):
                                inner = _lock_key(cls.name, name)
                                for h in held:
                                    if (inner == h and
                                            kinds.get(h) == "lock"):
                                        self_deadlocks.append(
                                            (h, sub.lineno))
                                    add_edge(h, inner, sub.lineno)
                    elif isinstance(sub, ast.Call):
                        callee = dotted(sub.func)
                        if callee and callee.startswith("self.") \
                                and callee.count(".") == 1:
                            for inner in may.get(callee[len("self."):], ()):
                                for h in held:
                                    if (inner == h
                                            and kinds.get(h) == "lock"):
                                        self_deadlocks.append(
                                            (h, sub.lineno))
                                    add_edge(h, inner, sub.lineno)

    for lock_name, line in self_deadlocks:
        yield ctx.finding(
            line, "RL007",
            f"re-acquisition of non-reentrant lock {lock_name} while "
            "already held — this deadlocks; use an _locked variant of the "
            "callee or an RLock")

    # Cycle detection: report each strongly connected component once.
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Dict[str, bool] = {}
    stack: List[str] = []
    counter = [0]
    sccs: List[List[str]] = []

    def strongconnect(v: str):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack[v] = True
        for w_ in edges.get(v, ()):
            if w_ not in index:
                strongconnect(w_)
                low[v] = min(low[v], low[w_])
            elif on_stack.get(w_):
                low[v] = min(low[v], index[w_])
        if low[v] == index[v]:
            comp = []
            while True:
                w_ = stack.pop()
                on_stack[w_] = False
                comp.append(w_)
                if w_ == v:
                    break
            if len(comp) > 1:
                sccs.append(comp)

    for v in list(edges):
        if v not in index:
            strongconnect(v)

    for comp in sccs:
        comp_set = set(comp)
        edge_list = [(a, b) for (a, b) in sites
                     if a in comp_set and b in comp_set]
        line = min(sites[e] for e in edge_list)
        order = " ; ".join(f"{a} -> {b} (line {sites[(a, b)]})"
                           for a, b in sorted(edge_list))
        yield ctx.finding(
            line, "RL007",
            f"lock-order cycle between {sorted(comp_set)}: {order} — pick "
            "one global order and restructure the odd acquisition out")


# =====================================================================
# RL008 span-leak
# =====================================================================
#
# Tracing contract (observability/tracing.py): a span returned by
# `tracer.start_span(...)` must be ENDED — end() records it into the
# flight recorder and restores the previous trace context.  An un-ended
# span silently corrupts the trace tree: its children re-parent to it
# forever (the contextvar never resets) and the span itself never reaches
# the GCS.  Statically enforceable discipline:
#
#   with tracer.start_span("name") as span: ...        # preferred
#   span = tracer.start_span("name"); try: ... finally: span.end()
#
# Anything else — a bare expression statement, an assignment whose name
# is neither `with`-entered later nor `.end()`ed inside a `finally` of
# the same function — is flagged.  Detection is by the CALL SHAPE
# (`<anything>.start_span(...)` or a bare `start_span(...)`), so
# `get_tracer().start_span(...)` — the dominant production form, whose
# receiver is itself a call and has no dotted name — is covered.
# Factory helpers that `return` a started span annotate the call with
# `# raylint: disable=RL008` (the caller is then the owner).


def _is_start_span(call: ast.Call) -> bool:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr == "start_span"
    return isinstance(call.func, ast.Name) and call.func.id == "start_span"


def _span_closer_names(fn: ast.AST) -> Set[str]:
    """Names that provably end their span somewhere in `fn`: `x` with an
    `x.end(...)` call inside a finally block, or `x` used as a bare
    `with x:` context expression (the guarded-assign idiom:
    ``span = NOOP; if enabled: span = start_span(...)`` then
    ``with span:``). Nested defs excluded — they run on another frame."""
    names: Set[str] = set()
    for sub in walk_excluding_nested_functions(fn):
        if isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                if isinstance(item.context_expr, ast.Name):
                    names.add(item.context_expr.id)
            continue
        if not isinstance(sub, ast.Try) or not sub.finalbody:
            continue
        for stmt in sub.finalbody:
            for call in ast.walk(stmt):
                if not isinstance(call, ast.Call):
                    continue
                name = dotted(call.func)
                if name and name.endswith(".end"):
                    names.add(name[: -len(".end")])
    return names


@rule("RL008", "span-leak: start_span not context-managed or end()ed "
               "in a finally")
def rl008_span_leak(ctx: FileContext) -> Iterable[Finding]:
    for fn in _functions(ctx):
        closers: Optional[Set[str]] = None  # computed lazily per function
        for call in _calls_in(fn):
            if not _is_start_span(call):
                continue
            parent = ctx.parent(call)
            # `with ... start_span(...) [as s]:` — the context manager
            # ends the span on every path.
            if isinstance(parent, ast.withitem):
                continue
            if isinstance(parent, ast.Assign) \
                    and len(parent.targets) == 1:
                target = dotted(parent.targets[0])
                if target is not None:
                    if closers is None:
                        closers = _span_closer_names(fn)
                    if target in closers:
                        continue
                    yield ctx.finding(
                        call, "RL008",
                        f"span assigned to {target!r} is neither entered "
                        "with `with` nor end()ed in a finally block — an "
                        "un-ended span corrupts the trace tree (context "
                        "never restored)")
                    continue
            yield ctx.finding(
                call, "RL008",
                "start_span() result discarded — the span can never be "
                "ended; use it as a context manager")


# =====================================================================
# RL009 gang-without-death-hook
# =====================================================================
#
# Gang discipline (shardgroup/gang.py): creating MULTIPLE actors
# into one placement group — a loop whose body both constructs a
# PlacementGroupSchedulingStrategy and calls `.remote(...)` — is a gang,
# and gangs have two non-negotiable obligations no runtime test proves
# on the paths that matter:
#
#  (a) ABORT: the creation loop must sit inside a `try` whose except/
#      finally path releases everything (a call to
#      `remove_placement_group`, or an abort helper — name containing
#      "abort" — that does).  A mid-gang create failure otherwise leaks
#      every acquired bundle and leaves a half-alive gang serving
#      nothing.
#
#  (b) DEATH HOOK: the function must register group death handling — a
#      `GangMonitor(...)`, a call whose name mentions "death", or an
#      `on_death=`/`death_hook=` keyword — so one dead rank kills/fails
#      the whole gang instead of survivors hanging on a peer that will
#      never answer (the serve controller's group health check plays
#      this role for serve gangs via `create_gang`).
#
# The blessed APIs (`shardgroup.create_gang` / `create_replica_group`)
# satisfy both; hand-rolled gangs that cannot take a hook annotate with
# `# raylint: disable=RL009` and own the consequences.


_RL009_DEATH_NAMES = {"GangMonitor"}
_RL009_DEATH_KWARGS = {"on_death", "death_hook"}


def _rl009_gang_loop(fn: ast.AST) -> Optional[ast.AST]:
    """The first loop in `fn` that creates placement-grouped actors."""
    for sub in walk_excluding_nested_functions(fn):
        if not isinstance(sub, (ast.For, ast.While, ast.AsyncFor)):
            continue
        has_pgss = has_remote = False
        for call in ast.walk(sub):
            if not isinstance(call, ast.Call):
                continue
            seg = last_segment(dotted(call.func))
            if seg == "PlacementGroupSchedulingStrategy":
                has_pgss = True
            elif seg == "remote" or (
                    # `Cls.options(...).remote(...)` — the dominant real
                    # shape: the receiver is itself a Call, so dotted()
                    # has no name for it; match the attribute directly.
                    isinstance(call.func, ast.Attribute)
                    and call.func.attr == "remote"):
                has_remote = True
        if has_pgss and has_remote:
            return sub
    return None


def _rl009_is_cleanup(call: ast.Call) -> bool:
    seg = last_segment(dotted(call.func))
    return seg == "remove_placement_group" or "abort" in seg.lower()


def _rl009_abort_guarded(ctx: FileContext, loop: ast.AST,
                         fn: ast.AST) -> bool:
    """Is the gang loop inside a try whose except/finally cleans up?"""
    for anc in ctx.ancestors(loop):
        if anc is fn:
            break
        if not isinstance(anc, ast.Try):
            continue
        blocks = [h.body for h in anc.handlers]
        if anc.finalbody:
            blocks.append(anc.finalbody)
        for body in blocks:
            for stmt in statements(body):
                for call in _calls_in(stmt):
                    if _rl009_is_cleanup(call):
                        return True
    return False


def _rl009_has_death_hook(fn: ast.AST) -> bool:
    for call in _calls_in(fn):
        seg = last_segment(dotted(call.func))
        if seg in _RL009_DEATH_NAMES or "death" in seg.lower():
            return True
        for kw in call.keywords:
            if kw.arg in _RL009_DEATH_KWARGS:
                return True
    return False


@rule("RL009", "gang-without-death-hook: placement-grouped multi-actor "
               "creation without abort cleanup and a group death hook")
def rl009_gang_without_death_hook(ctx: FileContext) -> Iterable[Finding]:
    for fn in _functions(ctx):
        loop = _rl009_gang_loop(fn)
        if loop is None:
            continue
        missing = []
        if not _rl009_abort_guarded(ctx, loop, fn):
            missing.append(
                "no abort path (wrap the creation loop in try/except "
                "that kills created ranks and remove_placement_group()s)")
        if not _rl009_has_death_hook(fn):
            missing.append(
                "no group death hook (register a GangMonitor / on_death "
                "handler so one dead rank fails the whole gang)")
        if missing:
            yield ctx.finding(
                loop, "RL009",
                "multi-actor gang on a placement group: "
                + "; ".join(missing)
                + " — or use shardgroup.create_gang/create_replica_group")


# =====================================================================
# RL010 retry-without-deadline
# =====================================================================
#
# The hang-shaped bug class the chaos plane hunts (docs/FAULT_TOLERANCE
# .md): a retry/poll loop that can spin forever. Under fault injection
# "forever" is the common case — the peer it polls died, the state it
# waits for will never arrive — and an unbounded loop converts one fault
# into a silent wedge the watchdog then has to attribute from thread
# stacks. Statically checkable shape:
#
#   while True:            # constant-true condition
#       ...retry work...
#       time.sleep(x)      # or asyncio.sleep / <event>.wait(t): a POLL
#
# with NO evidence of a bound anywhere in the loop: no deadline/timeout/
# remaining/attempt/retries-style name (including keyword arguments like
# `timeout=30`), no bounded counter. Loops conditioned on an event
# (`while not self._stopped.is_set()`) are service loops, not retries —
# their bound is the stop signal — and a `while True` body consisting of
# NOTHING but a sleep is a signal-driven keep-alive (it polls nothing);
# neither is flagged.
#
# Loops that are unbounded BY API CONTRACT (an `await ref` with no
# deadline parameter, a tail-the-logs-until-the-job-ends generator)
# annotate with `# raylint: disable=RL010 — <why the bound lives
# elsewhere>` and should make themselves visible to the hang watchdog.

_RL010_BOUND = re.compile(
    r"deadline|timeout|remaining|attempt|retr|tries|budget|expir"
    r"|give_?up|max_|_left", re.I)


def _rl010_const_true(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value) is True


def _rl010_is_sleepish(call: ast.Call) -> bool:
    seg = last_segment(dotted(call.func))
    if seg == "sleep":
        return True
    # <event>.wait(t) inside while True is the same poll idiom; a bare
    # .wait() (no args) parks on the event instead of polling.
    return seg == "wait" and bool(call.args or call.keywords)


def _rl010_bound_evidence(loop: ast.While) -> bool:
    for sub in walk_excluding_nested_functions(loop):
        names = []
        if isinstance(sub, ast.Name):
            names.append(sub.id)
        elif isinstance(sub, ast.Attribute):
            names.append(sub.attr)
        elif isinstance(sub, ast.Call):
            names.extend(kw.arg for kw in sub.keywords if kw.arg)
        if any(_RL010_BOUND.search(n) for n in names):
            return True
    return False


def _rl010_keepalive(loop: ast.While) -> bool:
    """Body is nothing but sleep statements: a signal-driven keep-alive
    (standalone daemon mains) — it retries nothing."""
    return all(
        isinstance(s, ast.Expr) and isinstance(s.value, ast.Call)
        and last_segment(dotted(s.value.func)) == "sleep"
        for s in loop.body)


@rule("RL010", "retry-without-deadline: constant-true poll/retry loop "
               "with no deadline or bounded attempt count")
def rl010_retry_without_deadline(ctx: FileContext) -> Iterable[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.While) or \
                not _rl010_const_true(node.test):
            continue
        if _rl010_keepalive(node):
            continue
        has_poll = any(
            isinstance(sub, ast.Call) and _rl010_is_sleepish(sub)
            for sub in walk_excluding_nested_functions(node))
        if not has_poll:
            continue
        if _rl010_bound_evidence(node):
            continue
        yield ctx.finding(
            node, "RL010",
            "unbounded retry/poll loop: `while True` + sleep with no "
            "deadline, timeout, or attempt bound — under a fault this "
            "spins forever; bound it (deadline/attempts) or justify "
            "with a disable comment and watchdog visibility")


# =====================================================================
# RL011 unbounded-keyed-state
# =====================================================================
#
# The model-zoo churn leak shape (docs/MULTITENANCY.md): a long-lived
# control-plane object grows a dict keyed by per-request / per-tenant /
# per-replica identifiers and nothing ever removes an entry. Tenants
# register and leave, replicas restart forever, deployments churn — a
# registry keyed by every id that EVER existed passes every test and
# OOMs in week three. Statically checkable shape:
#
#   class Router:                     # control-plane module
#       def __init__(self):
#           self._inflight = {}       # dict attribute born empty
#       def reserve(self, rid):
#           self._inflight[rid] = 1   # keyed write, non-constant key
#
# with NO eviction evidence for that attribute anywhere in the class:
# no .pop()/.popitem()/.clear(), no `del d[k]`, no whole-dict
# reassignment outside __init__, and the dict never handed off bare as
# a call argument (ownership/pruning may live with the callee).
# Constant keys (fixed enum-like state) are exempt — the key space
# cannot grow.
#
# Caches that are bounded BY CONSTRUCTION (keys drawn from a finite set
# the checker cannot see, e.g. a user class's method names) annotate
# with `# raylint: disable=RL011 — <why the key space is bounded>`.

_RL011_PACKAGES = {"core", "serve", "inference", "tenancy", "collective",
                   "shardgroup", "observability", "chaos", "autoscaler"}


def _in_scope_rl011(path: str) -> bool:
    # Same real-location scoping as RL004: fixtures and out-of-tree
    # files are always checked; in-tree files only in the long-lived
    # control-plane packages.
    return _in_package_scope(path, _RL011_PACKAGES)


_RL011_DICT_CTORS = {"dict", "defaultdict", "OrderedDict", "Counter"}
_RL011_EVICT_METHODS = {"pop", "popitem", "clear"}


def _rl011_self_attr(node: ast.AST) -> Optional[str]:
    """'x' for a plain `self.x` attribute node, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _rl011_dict_attrs(cls: ast.ClassDef) -> Dict[str, int]:
    """Attr -> lineno for `self.x = {}`-style dicts born in __init__."""
    out: Dict[str, int] = {}
    for fn in cls.body:
        if not (isinstance(fn, _FUNC_NODES) and fn.name == "__init__"):
            continue
        for stmt in statements(fn.body):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt, val = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                tgt, val = stmt.target, stmt.value
            else:
                continue
            attr = _rl011_self_attr(tgt)
            if attr is None:
                continue
            if isinstance(val, ast.Dict) and not val.keys:
                out[attr] = stmt.lineno
            elif isinstance(val, ast.Call) and not val.args and \
                    last_segment(dotted(val.func)) in _RL011_DICT_CTORS:
                out[attr] = stmt.lineno
    return out


def _rl011_cleaned_attrs(cls: ast.ClassDef,
                         method_ok=None) -> Set[str]:
    """Attrs with eviction/handoff evidence anywhere in the class.
    `method_ok(name)` restricts which methods count as evidence sites
    (RL018 passes its teardown-name filter; RL011 accepts any)."""
    out: Set[str] = set()
    for fn in cls.body:
        if not isinstance(fn, _FUNC_NODES):
            continue
        if method_ok is not None and not method_ok(fn.name):
            continue
        init = fn.name == "__init__"
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                # self.x.pop(...) / .popitem() / .clear()
                if isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _RL011_EVICT_METHODS:
                    attr = _rl011_self_attr(node.func.value)
                    if attr:
                        out.add(attr)
                # Bare handoff: helper(self.x) — pruning may live with
                # the callee (mirrors RL003's ownership-handoff rule).
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    attr = _rl011_self_attr(arg)
                    if attr:
                        out.add(attr)
            elif isinstance(node, ast.Delete):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        attr = _rl011_self_attr(tgt.value)
                        if attr:
                            out.add(attr)
            elif not init and isinstance(node, ast.Assign):
                # Whole-dict reassignment outside __init__ rebuilds /
                # resets the container.
                for tgt in node.targets:
                    attr = _rl011_self_attr(tgt)
                    if attr:
                        out.add(attr)
    return out


def _rl011_keyed_writes(cls: ast.ClassDef) -> Dict[str, ast.AST]:
    """Attr -> first steady-state keyed write with a non-constant key
    (`self.x[k] = v`, `self.x[k] += v`, `self.x.setdefault(k, ...)`)."""
    out: Dict[str, ast.AST] = {}
    for fn in cls.body:
        if not isinstance(fn, _FUNC_NODES) or fn.name == "__init__":
            continue
        for node in ast.walk(fn):
            attr, key = None, None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    if isinstance(tgt, ast.Subscript):
                        a = _rl011_self_attr(tgt.value)
                        if a:
                            attr, key = a, tgt.slice
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "setdefault" and node.args:
                a = _rl011_self_attr(node.func.value)
                if a:
                    attr, key = a, node.args[0]
            if attr is None or isinstance(key, ast.Constant):
                continue  # constant keys: the key space cannot grow
            if attr not in out or node.lineno < out[attr].lineno:
                out[attr] = node
    return out


@rule("RL011", "unbounded-keyed-state: per-key dict on a long-lived "
               "object with no eviction/cleanup path")
def rl011_unbounded_keyed_state(ctx: FileContext) -> Iterable[Finding]:
    if not _in_scope_rl011(ctx.path):
        return
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        dicts = _rl011_dict_attrs(cls)
        if not dicts:
            continue
        cleaned = _rl011_cleaned_attrs(cls)
        writes = _rl011_keyed_writes(cls)
        for attr, node in sorted(writes.items(),
                                 key=lambda kv: kv[1].lineno):
            if attr not in dicts or attr in cleaned:
                continue
            yield ctx.finding(
                node, "RL011",
                f"`self.{attr}` grows one entry per key and nothing in "
                f"{cls.name} ever removes one — under churn (tenants, "
                "replicas, requests) this dict grows forever; add an "
                "eviction/prune path or annotate why the key space is "
                "bounded")


# =====================================================================
# RL012 lease-cache-invalidation
# =====================================================================
#
# RL011 specialized to the fast-task-path contract (docs/TASK_FASTPATH
# .md): a structure caching WORKER/LEASE NETWORK IDENTITIES — leases,
# RPC clients, peer connections, worker handles, address maps — is not
# merely a memory leak when stale, it is a CORRECTNESS hazard: a cached
# address that outlives its process gets tasks pushed into a dead socket
# (best case: a timeout-shaped hang) or, after a port reuse, into the
# WRONG process (worst case: double execution). The contract every such
# cache must exhibit, statically:
#
#   (a) a DEATH HOOK — a method on the death/disconnect path (name
#       mentioning lost/dead/died/down/disconnect/drop/evict/expire/
#       invalid/sweep/reap/purge/fail) that removes entries, e.g.
#       DirectTaskTransport._on_worker_lost purging its lease; or
#   (b) a LIVENESS SWEEP — a method that consults liveness evidence
#       (is_closed/alive/dead/heartbeat/last_seen/stale) and removes
#       what failed the check, e.g. the peer-client sweep dropping
#       closed RpcClients; or
#   (c) a bare HANDOFF of the whole structure to a helper (ownership —
#       and therefore invalidation — lives with the callee, mirroring
#       RL003/RL011's handoff rule).
#
# Cleanup that only runs at shutdown/stop/close does NOT count: a cache
# purged only at process exit still serves stale addresses for the whole
# life of the process after a node death. Caches whose entries are
# provably rebuilt-on-read or process-local annotate with
# `# raylint: disable=RL012 — <why stale entries are harmless>`.

_RL012_NAME = re.compile(r"lease|client|peer|conn|addr|worker", re.I)
_RL012_DEATH = re.compile(
    r"lost|dead|death|died|down|disconnect|drop|invalid|evict|expir"
    r"|sweep|reap|purge|fail|gone", re.I)
_RL012_LIVE = re.compile(
    r"is_closed|closed|alive|dead|live|heartbeat|last_seen|stale", re.I)
_RL012_CTORS = {"dict", "defaultdict", "OrderedDict", "list", "set",
                "WeakValueDictionary"}
_RL012_REMOVALS = {"pop", "popitem", "clear", "remove", "discard"}
_RL012_GROWERS = {"append", "add", "setdefault", "insert"}


def _rl012_cache_attrs(cls: ast.ClassDef) -> Dict[str, int]:
    """Attr -> lineno for worker/lease-ish containers born in __init__."""
    out: Dict[str, int] = {}
    for fn in cls.body:
        if not (isinstance(fn, _FUNC_NODES) and fn.name == "__init__"):
            continue
        for stmt in statements(fn.body):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt, val = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                tgt, val = stmt.target, stmt.value
            else:
                continue
            attr = _rl011_self_attr(tgt)
            if attr is None or not _RL012_NAME.search(attr):
                continue
            if isinstance(val, (ast.Dict, ast.List, ast.Set)) or (
                    isinstance(val, ast.Call)
                    and last_segment(dotted(val.func)) in _RL012_CTORS):
                out[attr] = stmt.lineno
    return out


def _rl012_grown_attrs(cls: ast.ClassDef) -> Dict[str, ast.AST]:
    """Attr -> first steady-state write that grows the container."""
    out: Dict[str, ast.AST] = {}
    for fn in cls.body:
        if not isinstance(fn, _FUNC_NODES) or fn.name == "__init__":
            continue
        for node in ast.walk(fn):
            attr = None
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        attr = _rl011_self_attr(tgt.value)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _RL012_GROWERS:
                attr = _rl011_self_attr(node.func.value)
            if attr is None:
                continue
            if attr not in out or node.lineno < out[attr].lineno:
                out[attr] = node
    return out


def _rl012_method_removes(fn: ast.AST, attr: str) -> bool:
    """Does `fn` remove entries from `self.<attr>` — directly, via a
    filtered whole reassignment, or through a local alias drawn from the
    attr (``leases = self._leases.get(k); ...; leases.remove(x)``)?"""
    aliases: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            src = node.value
            # v = self.attr.get(...) / self.attr[...] / list(self.attr...)
            mentions = any(
                _rl011_self_attr(sub) == attr for sub in ast.walk(src))
            if mentions:
                aliases.add(node.targets[0].id)
        elif isinstance(node, ast.For):
            # Loop targets drawn from the attr count as aliases too:
            # ``for k, leases in self._leases.items(): leases.remove(x)``
            if any(_rl011_self_attr(sub) == attr
                   for sub in ast.walk(node.iter)):
                for tgt in ast.walk(node.target):
                    if isinstance(tgt, ast.Name):
                        aliases.add(tgt.id)
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _RL012_REMOVALS:
            recv = node.func.value
            if _rl011_self_attr(recv) == attr:
                return True
            if isinstance(recv, ast.Name) and recv.id in aliases:
                return True
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and \
                        _rl011_self_attr(tgt.value) == attr:
                    return True
        elif isinstance(node, ast.Assign):
            # Whole reassignment outside __init__: rebuild/filter/reset.
            for tgt in node.targets:
                if _rl011_self_attr(tgt) == attr:
                    return True
    return False


def _rl012_mentions_liveness(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg and _RL012_LIVE.search(kw.arg):
                    return True
        if name and _RL012_LIVE.search(name):
            return True
    return False


def _rl012_handed_off(cls: ast.ClassDef, attr: str) -> bool:
    for fn in cls.body:
        if not isinstance(fn, _FUNC_NODES):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if _rl011_self_attr(arg) == attr:
                    return True
    return False


_RL012_SHUTDOWN_ONLY = re.compile(r"^(close|stop|shutdown|__del__|__exit__)$")


@rule("RL012", "lease-cache-invalidation: worker/lease address cache "
               "with no death-hook or liveness-sweep removal path")
def rl012_lease_cache_invalidation(ctx: FileContext) -> Iterable[Finding]:
    if not _in_scope_rl011(ctx.path):
        return
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        caches = _rl012_cache_attrs(cls)
        if not caches:
            continue
        grown = _rl012_grown_attrs(cls)
        for attr, node in sorted(grown.items(), key=lambda kv: kv[1].lineno):
            if attr not in caches:
                continue
            covered = _rl012_handed_off(cls, attr)
            shutdown_only_removal = False
            for fn in cls.body:
                if covered or not isinstance(fn, _FUNC_NODES) \
                        or fn.name == "__init__":
                    continue
                if not _rl012_method_removes(fn, attr):
                    continue
                if _RL012_SHUTDOWN_ONLY.match(fn.name):
                    shutdown_only_removal = True
                    continue  # exit-time cleanup is not invalidation
                if _RL012_DEATH.search(fn.name) or \
                        _rl012_mentions_liveness(fn):
                    covered = True
            if covered:
                continue
            why = ("its only removal path runs at shutdown"
                   if shutdown_only_removal else
                   "nothing removes entries on a death or liveness signal")
            yield ctx.finding(
                node, "RL012",
                f"`self.{attr}` caches worker/lease network identities "
                f"and {why} — a node/worker death leaves a stale address "
                "that pushes tasks into a dead (or reused) socket; purge "
                "it from the death hook or sweep it against liveness "
                "(is_closed/alive), or annotate why stale entries are "
                "harmless")


# =====================================================================
# RL013 unbounded-block-buffer
# =====================================================================
#
# The sustained-ingest OOM shape (docs/DATA_STREAMING.md): a data-plane
# operator accumulates BLOCKS — multi-MB units, not per-key bookkeeping
# — into a list/dict attribute with nothing bounding the accumulation.
# Burst-shaped tests never see it: the buffer drains at the end and
# peak residency stays under the arena. Under sustained many-GB
# dataflow the same buffer IS the working set, and an unbudgeted one
# converts backpressure into an OOM kill. Statically checkable shape:
#
#   class WindowBuffer:               # data-plane module
#       def __init__(self):
#           self._blocks = []         # container born unbounded
#       def on_block(self, b):
#           self._blocks.append(b)    # steady-state accumulation
#
# with, anywhere in the class, NEITHER:
#  (a) a DRAIN path — .pop()/.popleft()/.popitem()/.clear()/.remove(),
#      `del d[k]`, whole reassignment outside __init__, or a bare
#      handoff of the container (ownership lives with the callee,
#      mirroring RL003/RL011); NOR
#  (b) a BUDGET check in the accumulating method — an acquire/admission
#      call or bound comparison (budget/acquire/admit/limit/max_*/
#      capacity/window/bound/drop, incl. keyword arguments), e.g.
#      `self._budget.acquire(op, nbytes)` before the append, or
#      `if len(self._blocks) >= self._max_buffered: ...`.
#
# Containers bounded by construction (`deque(maxlen=...)`) are exempt.
# Buffers whose bound genuinely lives with the producer annotate with
# `# raylint: disable=RL013 — <where the budget is enforced>`.

_RL013_PACKAGES = {"data"}
_RL013_CTORS = {"dict", "defaultdict", "OrderedDict", "list", "deque"}
_RL013_GROWERS = {"append", "extend", "appendleft", "setdefault", "insert"}
_RL013_BOUND = re.compile(
    r"budget|acquire|admit|limit|max_|capacity|window|bound|drop|maxsize"
    r"|maxlen|full", re.I)


def _in_scope_rl013(path: str) -> bool:
    # Fixtures and out-of-tree files are always checked; in-tree files
    # only in the data-plane package (same real-location scoping as
    # RL004/RL011).
    return _in_package_scope(path, _RL013_PACKAGES)


def _rl013_buffer_attrs(cls: ast.ClassDef) -> Dict[str, int]:
    """Attr -> lineno for unbounded list/dict/deque attrs born in
    __init__ (`deque(maxlen=...)` is bounded by construction)."""
    out: Dict[str, int] = {}
    for fn in cls.body:
        if not (isinstance(fn, _FUNC_NODES) and fn.name == "__init__"):
            continue
        for stmt in statements(fn.body):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                tgt, val = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                tgt, val = stmt.target, stmt.value
            else:
                continue
            attr = _rl011_self_attr(tgt)
            if attr is None:
                continue
            if isinstance(val, (ast.List, ast.Dict)) and not (
                    isinstance(val, ast.Dict) and val.keys):
                out[attr] = stmt.lineno
            elif isinstance(val, ast.Call) and \
                    last_segment(dotted(val.func)) in _RL013_CTORS:
                if any(kw.arg == "maxlen" for kw in val.keywords):
                    continue  # bounded by construction
                out[attr] = stmt.lineno
    return out


def _rl013_grown(cls: ast.ClassDef) -> Dict[str, Tuple[ast.AST, ast.AST]]:
    """Attr -> (first steady-state accumulating write, enclosing method)
    — the method node feeds the budget-evidence scan."""
    out: Dict[str, Tuple[ast.AST, ast.AST]] = {}
    for fn in cls.body:
        if not isinstance(fn, _FUNC_NODES) or fn.name == "__init__":
            continue
        for node in ast.walk(fn):
            attr = None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    if isinstance(tgt, ast.Subscript):
                        a = _rl011_self_attr(tgt.value)
                        if a:
                            attr = a
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _RL013_GROWERS:
                attr = _rl011_self_attr(node.func.value)
            if attr is None:
                continue
            if attr not in out or node.lineno < out[attr][0].lineno:
                out[attr] = (node, fn)
    return out


def _rl013_budget_evidence(fn: ast.AST) -> bool:
    """Does the accumulating method consult a budget/bound? Same
    name-evidence scan as RL010: any name, attribute, or keyword
    argument matching the budget vocabulary counts."""
    for sub in walk_excluding_nested_functions(fn):
        names = []
        if isinstance(sub, ast.Name):
            names.append(sub.id)
        elif isinstance(sub, ast.Attribute):
            names.append(sub.attr)
        elif isinstance(sub, ast.Call):
            names.extend(kw.arg for kw in sub.keywords if kw.arg)
        if any(_RL013_BOUND.search(n) for n in names):
            return True
    return False


def _rl013_drained(cls: ast.ClassDef) -> Set[str]:
    """Attrs with drain/handoff evidence anywhere in the class (the
    RL011 eviction scan plus deque/list removers)."""
    out = set(_rl011_cleaned_attrs(cls))
    for fn in cls.body:
        if not isinstance(fn, _FUNC_NODES):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("popleft", "remove", "discard"):
                attr = _rl011_self_attr(node.func.value)
                if attr:
                    out.add(attr)
    return out


@rule("RL013", "unbounded-block-buffer: data-plane operator accumulates "
               "blocks with no budget check or drain path")
def rl013_unbounded_block_buffer(ctx: FileContext) -> Iterable[Finding]:
    if not _in_scope_rl013(ctx.path):
        return
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        buffers = _rl013_buffer_attrs(cls)
        if not buffers:
            continue
        drained = _rl013_drained(cls)
        grown = _rl013_grown(cls)
        for attr, (node, fn) in sorted(grown.items(),
                                       key=lambda kv: kv[1][0].lineno):
            if attr not in buffers or attr in drained:
                continue
            if _rl013_budget_evidence(fn):
                continue
            yield ctx.finding(
                node, "RL013",
                f"`self.{attr}` accumulates blocks and {cls.name} neither "
                "drains it nor checks a budget before growing it — under "
                "sustained ingest this buffer IS the working set and OOMs "
                "the node; acquire from the pipeline ByteBudget, bound "
                "it, or drain it (or annotate where the bound lives)")


# =====================================================================
# RL017 deferred-reply-completeness
# =====================================================================
#
# RL001's two checks are intraprocedural: they see completion closures
# nested INSIDE the DEFERRED handler.  The shape that grew as handlers
# matured is delegation — the handler parks nothing itself and instead
# hands (conn, msg_id) to a helper (`self._start_pull(conn, mid, ...)`)
# that owns the completion.  RL001 never looks inside the helper, so a
# helper that can raise before replying (or that simply never replies)
# ships unchecked and the parked caller hangs to its client timeout.
# This rule traces ONE call hop:
#
#  - a DEFERRED handler with no local completion evidence (no nested
#    reply closure, no waiter-structure park, no direct reply) must
#    delegate — each resolvable delegate (same-class method or
#    same-module function receiving the conn/msg-id) is analyzed:
#      * no reply, no park, no further handoff anywhere -> finding
#        (the reply obligation evaporated inside the helper);
#      * completion closures nested in the delegate get RL001's
#        guardedness check (an unguarded one hangs the caller exactly
#        like an unguarded closure in the handler itself);
#  - a DEFERRED handler with NO completion evidence and NO delegation
#    at all is flagged: nothing visible can ever answer the caller.
#
# Delegates that hand the ids onward (a second hop) or park them into a
# structure are trusted — one hop is the contract; deeper chains carry
# a `# raylint: disable=RL017 — <who replies>` at the delegation site.

_RL017_PARK_CALLS = {"append", "add", "put", "setdefault", "park",
                     "register"}


def _rl017_conn_params(fn: ast.AST) -> Set[str]:
    names = [a.arg for a in fn.args.args]
    return {n for n in names
            if n in ("conn", "connection") or n.endswith("_conn")}


def _rl017_mentions(node: ast.Call, names: Set[str]) -> bool:
    for a in list(node.args) + [kw.value for kw in node.keywords]:
        for sub in ast.walk(a):
            if isinstance(sub, ast.Name) and sub.id in names:
                return True
    return False


def _rl017_delegations(fn: ast.AST, tracked: Set[str]) -> List[ast.Call]:
    out: List[ast.Call] = []
    for sub in walk_excluding_nested_functions(fn):
        if not isinstance(sub, ast.Call) or not _rl017_mentions(sub, tracked):
            continue
        if _is_reply_call(sub, set()):
            continue
        seg = last_segment(dotted(sub.func)) or (
            sub.func.attr if isinstance(sub.func, ast.Attribute) else "")
        if seg in _RL017_PARK_CALLS:
            continue  # parking into a waiter structure: the drain owns it
        out.append(sub)
    return out


def _rl017_resolve(ctx: FileContext, call: ast.Call,
                   fn: ast.AST) -> Optional[ast.AST]:
    """The delegate's def when it lives in this file: `self.x(...)` in
    the enclosing class, or a bare-name module-level function."""
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "self":
        cls = ctx.enclosing_class(fn)
        if cls is not None:
            for n in cls.body:
                if isinstance(n, _FUNC_NODES) and n.name == f.attr:
                    return n
        return None
    if isinstance(f, ast.Name):
        for n in ctx.tree.body:
            if isinstance(n, _FUNC_NODES) and n.name == f.id:
                return n
    return None


def _rl017_received_params(call: ast.Call, delegate: ast.AST,
                           conn_vars: Set[str],
                           msgid_vars: Set[str]) -> Tuple[Set[str],
                                                          Set[str]]:
    """Map the delegation call's arguments onto the delegate's parameter
    names: which params received the connection, which the msg id."""
    params = [a.arg for a in delegate.args.args]
    if params and params[0] in ("self", "cls") and \
            isinstance(call.func, ast.Attribute):
        params = params[1:]
    conn_received: Set[str] = set()
    msgid_received: Set[str] = set()

    def classify(arg: ast.AST, pname: str) -> None:
        if isinstance(arg, ast.Name) and arg.id in conn_vars:
            conn_received.add(pname)
        elif _mentions_msgid(arg, msgid_vars):
            msgid_received.add(pname)

    for i, arg in enumerate(call.args):
        if i < len(params):
            classify(arg, params[i])
    for kw in call.keywords:
        if kw.arg:
            classify(kw.value, kw.arg)
    return conn_received, msgid_received


def _rl017_delegate_evidence(delegate: ast.AST, conn_params: Set[str],
                             msgid_params: Set[str]
                             ) -> Tuple[str, Set[str], List[ast.AST]]:
    """(kind, reply_fn_names, nested) where kind is 'reply' | 'park' |
    'handoff' | 'none' — the strongest completion evidence found
    anywhere in the delegate (nested closures included).  A handoff must
    move the CONNECTION onward: a call that only mentions the msg id
    (logging, bookkeeping) cannot complete the reply."""
    nested = _nested_functions(delegate)
    reply_fns = _reply_fn_fixpoint(nested)
    received = conn_params | msgid_params
    kind = "none"
    for sub in ast.walk(delegate):
        if isinstance(sub, ast.Call):
            if _is_reply_call(sub, reply_fns):
                return "reply", reply_fns, nested
            seg = last_segment(dotted(sub.func)) or (
                sub.func.attr if isinstance(sub.func, ast.Attribute)
                else "")
            if seg in _RL017_PARK_CALLS and _rl017_mentions(sub, received):
                kind = "park"
            elif kind == "none" and _rl017_mentions(sub, conn_params):
                kind = "handoff"
        elif isinstance(sub, ast.Assign) and any(
                isinstance(t, (ast.Subscript, ast.Attribute))
                for t in sub.targets):
            if any(isinstance(n, ast.Name) and n.id in received
                   for n in ast.walk(sub.value)):
                kind = "park"
    return kind, reply_fns, nested


@rule("RL017", "deferred-reply-completeness: a DEFERRED handler's "
               "delegated completion helper must reply, park, or hand "
               "off on every path")
def rl017_deferred_reply_completeness(ctx: FileContext
                                      ) -> Iterable[Finding]:
    for fn in _functions(ctx):
        if ctx.enclosing_function(fn) is not None:
            continue
        if _returns_deferred(fn) is None:
            continue
        nested = _nested_functions(fn)
        local_replies = bool(_reply_fn_fixpoint(nested))
        if not local_replies:
            for sub in walk_excluding_nested_functions(fn):
                if isinstance(sub, ast.Call) and _is_reply_call(sub, set()):
                    local_replies = True
                    break
        tracked = _msgid_vars(fn) | _rl017_conn_params(fn)
        parked = _registration_line(fn, tracked) is not None
        delegations = _rl017_delegations(fn, tracked)
        if local_replies or parked:
            continue  # RL001's jurisdiction: completion is local
        if not delegations:
            yield ctx.finding(
                fn, "RL017",
                f"'{fn.name}' returns DEFERRED but nothing visible can "
                "complete the reply: no reply call, no waiter park, and "
                "the conn/msg id are never handed to a helper — the "
                "caller hangs to its client timeout on every request")
            continue
        conn_vars = _rl017_conn_params(fn)
        for call in delegations:
            delegate = _rl017_resolve(ctx, call, fn)
            if delegate is None:
                continue  # unresolvable receiver: treated as a handoff
            conn_p, msgid_p = _rl017_received_params(
                call, delegate, conn_vars, _msgid_vars(fn))
            kind, reply_fns, dnested = _rl017_delegate_evidence(
                delegate, conn_p, msgid_p)
            if kind == "none":
                yield ctx.finding(
                    call, "RL017",
                    f"'{fn.name}' returns DEFERRED and delegates "
                    f"completion to '{delegate.name}', which neither "
                    "replies, parks the caller, nor hands the ids "
                    "onward — the parked caller can never be answered")
            elif kind == "reply":
                for nf in dnested:
                    if nf.name in reply_fns and \
                            not _completion_guarded(nf, reply_fns):
                        yield ctx.finding(
                            nf, "RL017",
                            f"completion path '{nf.name}' in "
                            f"'{delegate.name}' (delegated from DEFERRED "
                            f"handler '{fn.name}') can raise before "
                            "replying — the parked caller would hang; "
                            "wrap it so every exception path also "
                            "replies")


# =====================================================================
# RL018 job-scoped-state
# =====================================================================
#
# RL011 specialized to the multi-job platform's churn contract
# (docs/JOBS.md "Job-scoped isolation"): control-plane state keyed by a
# JOB identifier (job_id / job_hex / submission_id) must be evicted on a
# job-TEARDOWN path, not merely "somewhere". Jobs are the tenancy unit —
# they arrive and finish forever on a shared cluster, so a per-job entry
# that survives its job is a leak with a guaranteed driver (every
# submission grows it by one), and an entry evicted only by an unrelated
# LRU/TTL is a correctness hazard: a recycled job id would inherit the
# previous tenant's quota, forge refs, or KV. Statically checkable
# shape:
#
#   class Admission:                        # control-plane module
#       def __init__(self):
#           self._jobs = {}                 # dict attribute born empty
#       def admit(self, job_hex):
#           self._jobs[job_hex] = now()     # job-keyed steady-state write
#
# with NO eviction evidence for that attribute inside any
# teardown-shaped method — one whose name says it runs when a job (or
# the hosting object) dies: finish/terminal/unregister/release/reclaim/
# sweep/stop/shutdown/cleanup/close/purge/expire/evict/prune/dead/gc.
# Eviction in such a method (pop/del/clear, wholesale reassignment, or a
# bare handoff to a pruner) is the evidence the contract asks for.
#
# State that is genuinely bounded without per-job eviction (e.g. keyed
# by a fixed roster the checker cannot see) annotates with
# `# raylint: disable=RL018 — <why the key space is bounded>`.

_RL018_PACKAGES = _RL011_PACKAGES | {"jobs", "job_submission"}

_RL018_TEARDOWN_RE = re.compile(
    r"(finish|terminal|unregister|release|reclaim|sweep|stop|shutdown|"
    r"cleanup|close|purge|expire|evict|prune|dead|reap|delete|remove|gc)",
    re.I)

_RL018_JOBISH_RE = re.compile(r"(job|submission)", re.I)


def _in_scope_rl018(path: str) -> bool:
    # RL011's real-location scoping, widened to the jobs packages.
    return _in_package_scope(path, _RL018_PACKAGES)


def _rl018_jobish_key(key: ast.AST) -> bool:
    """Does the key expression mention a job-shaped identifier?"""
    for node in ast.walk(key):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name and (_RL018_JOBISH_RE.search(name)
                     or name in ("sid", "jid")):
            return True
    return False


def _rl018_job_keyed_writes(cls: ast.ClassDef) -> Dict[str, ast.AST]:
    """Attr -> first steady-state write whose key is job-derived."""
    out: Dict[str, ast.AST] = {}
    for fn in cls.body:
        if not isinstance(fn, _FUNC_NODES) or fn.name == "__init__":
            continue
        for node in ast.walk(fn):
            attr, key = None, None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    if isinstance(tgt, ast.Subscript):
                        a = _rl011_self_attr(tgt.value)
                        if a:
                            attr, key = a, tgt.slice
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "setdefault" and node.args:
                a = _rl011_self_attr(node.func.value)
                if a:
                    attr, key = a, node.args[0]
            if attr is None or isinstance(key, ast.Constant) \
                    or not _rl018_jobish_key(key):
                continue
            if attr not in out or node.lineno < out[attr].lineno:
                out[attr] = node
    return out


@rule("RL018", "job-scoped-state: per-job keyed dict with no eviction "
               "on a job-teardown path")
def rl018_job_scoped_state(ctx: FileContext) -> Iterable[Finding]:
    if not _in_scope_rl018(ctx.path):
        return
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        dicts = _rl011_dict_attrs(cls)
        if not dicts:
            continue
        cleaned = _rl011_cleaned_attrs(
            cls, method_ok=lambda n: bool(_RL018_TEARDOWN_RE.search(n)))
        writes = _rl018_job_keyed_writes(cls)
        for attr, node in sorted(writes.items(),
                                 key=lambda kv: kv[1].lineno):
            if attr not in dicts or attr in cleaned:
                continue
            yield ctx.finding(
                node, "RL018",
                f"`self.{attr}` is keyed by a job identifier but no "
                f"teardown-shaped method of {cls.name} ever removes an "
                "entry — job-scoped state must die with its job "
                "(docs/JOBS.md): evict it on the job-finished/"
                "unregister/sweep path or annotate why the key space "
                "is bounded")


# =====================================================================
# RL019 driver-materialization
# =====================================================================
#
# The query tier's scalability contract (docs/DATA_QUERY.md): sort,
# groupby and join run as budget-bounded dataflows through the
# exchange; the DRIVER holds bounded metadata — refs, a capped key
# sample, range boundaries — never the rows. The shape that silently
# breaks this is a helper that collects a whole row/block iterator into
# driver memory:
#
#   rows = [r for r in ds.iter_rows()]          # every row, driver-RAM
#   blocks = list(parent._iter_block_values())  # every block
#   vals = ray_tpu_torch.get([r for r in refs])  # every block, at once
#
# Each is O(dataset) driver memory: correct on toy inputs, an OOM (and
# a scalability lie — the operator LOOKS distributed) at width.
# Flagged shapes, in data-plane modules only:
#
#  (a) list()/sorted()/tuple() directly over a row/block iterator call
#      (.iter_rows() / ._iter_block_values() / .take_all());
#  (b) a list/set/dict comprehension iterating such a call;
#  (c) ray_tpu_torch.get / ray.get of a LIST of refs (literal or
#      comprehension) — a bulk get materializes every block at once
#      even though each ref is bounded metadata on its own.
#
# Streaming a `for` loop over the same iterators is fine (one block
# resident at a time; accumulation is RL013's jurisdiction), and
# ref-level iteration (`_iter_block_refs`) is always fine — refs are
# bounded metadata. Deliberately driver-resident ENDPOINTS — take_all,
# to_pandas, the user asked for a local copy — annotate with
# `# raylint: disable=RL019 — <why the copy is the contract>`.

_RL019_ITERS = {"iter_rows", "_iter_block_values", "take_all"}
_RL019_COLLECTORS = {"list", "sorted", "tuple"}
_RL019_GETTERS = {"ray_tpu_torch.get", "ray.get"}


def _rl019_iter_call(node: ast.AST) -> Optional[str]:
    """The iterator-method name when `node` is a call of a whole-dataset
    row/block iterator, else None."""
    if isinstance(node, ast.Call):
        name = last_segment(dotted(node.func))
        if name in _RL019_ITERS:
            return name
    return None


@rule("RL019", "driver-materialization: data-plane code collects a whole "
               "row/block iterator (or a ref list, by value) into driver "
               "memory")
def rl019_driver_materialization(ctx: FileContext) -> Iterable[Finding]:
    if not _in_scope_rl013(ctx.path):  # same patrol area: the data plane
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in _RL019_COLLECTORS and node.args:
            name = _rl019_iter_call(node.args[0])
            if name:
                yield ctx.finding(
                    node, "RL019",
                    f"{node.func.id}(...{name}()) materializes the whole "
                    "dataset in driver memory — O(dataset) RAM where the "
                    "contract is bounded metadata; stream the iterator, "
                    "push the work through the exchange, or annotate why "
                    "this endpoint is deliberately driver-resident")
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp)):
            for gen in node.generators:
                name = _rl019_iter_call(gen.iter)
                if name:
                    yield ctx.finding(
                        node, "RL019",
                        f"comprehension over {name}() materializes the "
                        "whole dataset in driver memory — O(dataset) RAM "
                        "where the contract is bounded metadata; stream "
                        "it block-by-block or run the operator in the "
                        "exchange (or annotate the deliberate endpoint)")
                    break
        elif isinstance(node, ast.Call) \
                and dotted(node.func) in _RL019_GETTERS and node.args \
                and isinstance(node.args[0], (ast.List, ast.ListComp)):
            yield ctx.finding(
                node, "RL019",
                "bulk get of a ref list resolves every block into driver "
                "memory simultaneously — pass refs onward (tasks resolve "
                "them where they run) or get them one window at a time")
