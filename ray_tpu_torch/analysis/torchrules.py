"""RL020-RL024: the accelerator-hazard rule family over the torch surface.

These rules run on :mod:`ray_tpu_torch.analysis.dataflow` — a
per-function CFG with device / host / static-python value provenance —
and target the eager-PyTorch hazards that no runtime check sees on paths
a run does not execute (the JAX package's RL020-RL024 guard the XLA
counterparts; each id here stands for the same hazard as far as eager
PyTorch has it):

- RL020 device-value-control-flow — ``if`` / ``while`` / ``assert``,
                              ``bool()`` / ``int()`` / ``float()`` or
                              ``range()`` on a device tensor in a
                              per-step function: an implicit sync on
                              every step.  (Eager mode has no trace:
                              the reference's retrace, static_argnums
                              and jit-per-call halves have no
                              counterpart.)
- RL021 host-sync-in-hot-loop — a device→host sync (``.item()``,
                              ``.tolist()``, ``.cpu()``, ``.numpy()``,
                              ``np.asarray``, ``int()`` ...,
                              ``.synchronize()``, ``.nonzero()``,
                              boolean-mask indexing) inside a loop of a
                              per-step/per-token method; the prescribed
                              idiom is one ``.cpu()`` before the loop,
                              indexing the host copy after
- RL022 use-after-inplace   — a view of a buffer (slice, ``.view``,
                              ``.reshape``, ``.flatten``, ``.narrow``
                              ...) taken before an in-place write to the
                              buffer (``index_copy_``, ``copy_``,
                              ``add_`` and the other ``*_`` methods,
                              ``out=``, ``optimizer.step()``) and read
                              after it on some CFG path: the view holds
                              the new values (the port's counterpart of
                              use-after-donate: where the reference
                              donated the paged arena, the port updates
                              it in place)
- RL023 sharding-axis-hygiene (whole-program) — logical-axis rule
                              entries, logical axes at sharding call
                              sites and PartitionSpec literals that
                              reach no mesh axis a MeshSpec / ShardSpec
                              declares: the dim is silently replicated.
                              (DTensor placements have no jit cache
                              key: the trailing-``None`` half has no
                              counterpart.)
- RL024 cuda-before-fork (whole-program) — CUDA initialised at import
                              time of a module the worker forge
                              preimports, or before ``os.fork()`` / a
                              fork-context ``Process`` on a CFG path of
                              one function: the child cannot use the
                              card ("Cannot re-initialize CUDA in forked
                              subprocess").  (Eager mode has no jit
                              closure: the reference's stale-capture
                              half has no counterpart.)

Per-file rules fire only in files that mention torch at all, so the
control plane never pays for the dataflow pass.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterable, Iterator, List, Set, Tuple

from ray_tpu_torch.analysis.engine import (
    FileContext,
    Finding,
    dotted,
    project_rule,
    rule,
)
from ray_tpu_torch.analysis import dataflow as df

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

_TORCH_SCOPE = ("torch surface: files importing torch (models/, "
                "inference/, ops/, train/, rllib/, parallel/)")
_PROJECT_SCOPE = "whole program (the port's package)"

_FACTORY_PREFIXES = ("make", "build", "create", "get", "init", "setup",
                     "compile", "_make", "_build", "_create", "_get",
                     "_init", "_setup", "_compile", "__init__")
_HOT_NAMES = {"_run", "decode", "prefill", "generate", "sample",
              "propose", "verify", "forward"}


def _uses_torch(ctx: FileContext) -> bool:
    return "torch" in ctx.source


def _functions(ctx: FileContext) -> Iterator[ast.AST]:
    for node in ast.walk(ctx.tree):
        if isinstance(node, _FUNC_NODES):
            yield node


def _is_hot(name: str) -> bool:
    low = name.lower()
    return "step" in low or low in _HOT_NAMES or low.endswith("_loop")


def _is_per_step(name: str) -> bool:
    return _is_hot(name) and not name.lower().startswith(_FACTORY_PREFIXES)


class _FileFlows:
    """Shared per-file dataflow state, computed once and reused by
    RL020/RL021 (the engine hands every rule the same FileContext)."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.modules = df.module_callables(ctx)
        self._flows: Dict[int, df.FlowAnalysis] = {}

    def flow(self, fn: ast.AST) -> df.FlowAnalysis:
        got = self._flows.get(id(fn))
        if got is None:
            got = df.FlowAnalysis(self.ctx, fn,
                                  device_callables=self.modules)
            self._flows[id(fn)] = got
        return got


def _file_flows(ctx: FileContext) -> _FileFlows:
    got = getattr(ctx, "_torch_flows", None)
    if got is None or got.ctx is not ctx:
        got = _FileFlows(ctx)
        ctx._torch_flows = got
    return got


def _in_loop_within(ctx: FileContext, node: ast.AST, fn: ast.AST) -> bool:
    for anc in ctx.ancestors(node):
        if anc is fn:
            return False
        if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
            return True
    return False


def _in_loop(ctx: FileContext, ev: df.Materialization, fn: ast.AST) -> bool:
    """Whether the sync runs once per iteration: in a comprehension, or
    in a loop's body.  A `while` test is evaluated every iteration too."""
    if ev.in_comprehension or _in_loop_within(ctx, ev.stmt, fn):
        return True
    return ev.kind == "while"


# =====================================================================
# RL020 device-value-control-flow
# =====================================================================
#
# Eager PyTorch runs Python control flow on the host: `if loss > 0:` on
# a CUDA tensor calls bool(), which copies the value to the host and
# waits for every queued kernel — a full pipeline drain on every step.
# The fix keeps the decision on the device (`torch.where`, masking,
# `clamp`), or decides from host state the step already has.  Inside a
# loop the same sync is RL021's (once per iteration); RL020 owns the
# once-per-step ones.


@rule("RL020", "device-value-control-flow: if/while/assert, bool()/"
               "int()/float() or range() on a device tensor in a "
               "per-step function — an implicit host sync every step "
               "(eager counterpart of the retired RL006's retrace "
               "hazard)",
      scope=_TORCH_SCOPE)
def check_device_control_flow(ctx: FileContext) -> Iterable[Finding]:
    if not _uses_torch(ctx):
        return
    flows = _file_flows(ctx)
    for fn in _functions(ctx):
        if not _is_per_step(fn.name):
            continue
        flow = flows.flow(fn)
        for ev in flow.materializations:
            if ev.kind not in df.IMPLICIT_KINDS or _in_loop(ctx, ev, fn):
                continue
            yield ctx.finding(
                ev.node, "RL020",
                f"Python `{ev.kind}` on a device tensor in per-step "
                f"function '{fn.name}' — Python asks the card for the "
                "value, an implicit sync that drains the queue every "
                "step; keep the decision on the device (torch.where, "
                "masking) or decide from host state")


# =====================================================================
# RL021 host-sync-in-hot-loop
# =====================================================================
#
# The inference engine's decode step budget is one device sync per step:
# the step's outputs come back with ONE `.cpu()` before the per-request
# bookkeeping loop reads plain host memory.  A sync inside the loop
# instead blocks on the card once per request per token.  Provenance
# keeps this precise: `int(host_copy[slot])` after the hoisted copy is
# silent, `int(nxt[slot])` on the device value fires.


@rule("RL021", "host-sync-in-hot-loop: device value synced to host "
               "inside a loop of a per-step/per-token method",
      scope=_TORCH_SCOPE)
def check_host_sync_in_hot_loop(ctx: FileContext) -> Iterable[Finding]:
    if not _uses_torch(ctx):
        return
    flows = _file_flows(ctx)
    for fn in _functions(ctx):
        if not _is_hot(fn.name):
            continue
        flow = flows.flow(fn)
        for ev in flow.materializations:
            if not _in_loop(ctx, ev, fn):
                continue                   # the deliberate post-step sync
            yield ctx.finding(
                ev.node, "RL021",
                f"host sync ({ev.kind}) of a device value inside a loop "
                f"of per-step method '{fn.name}' — every iteration "
                "blocks on the card; sync once before the loop "
                "(host = x.cpu()) and index the host copy")


# =====================================================================
# RL022 use-after-inplace
# =====================================================================
#
# A view shares its buffer's storage.  Taken before an in-place write to
# the buffer and read after it, the view no longer holds the values it
# was taken from — no error, wrong numbers.  The port's counterpart of
# the reference's use-after-donate: where XLA was handed the paged arena
# (donate_argnums), the port writes it in place (`index_copy_`), so a
# window kept across that write is the stale-buffer shape.  The fix is
# `.clone()` when the old values are meant, or taking the view after the
# write.

_Fact = Tuple[str, str, int]        # (view name, buffer root, line)


def _bound_names(stmt: ast.stmt) -> Set[str]:
    """Dotted names the statement rebinds."""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign, ast.For,
                           ast.AsyncFor)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        targets = [i.optional_vars for i in stmt.items
                   if i.optional_vars is not None]
    elif isinstance(stmt, ast.Delete):
        targets = list(stmt.targets)
    out: Set[str] = set()
    while targets:
        t = targets.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            targets.extend(t.elts)
        elif isinstance(t, ast.Starred):
            targets.append(t.value)
        else:
            d = dotted(t)
            if d:
                out.add(d)
    return out


_MULTI_VIEW = {"chunk", "split", "unbind", "tensor_split"}


def _new_views(stmt: ast.stmt, facts: FrozenSet[_Fact]) -> List[_Fact]:
    """Views the statement binds: `a = buf[...]`, `a = buf.view(...)`,
    `a, b = buf.chunk(2)` (the root followed through live views)."""
    if not isinstance(stmt, (ast.Assign, ast.AnnAssign)) or \
            stmt.value is None:
        return []
    value = stmt.value
    targets = stmt.targets if isinstance(stmt, ast.Assign) \
        else [stmt.target]
    roots = {v: r for v, r, _ in facts}
    out: List[_Fact] = []
    names: List[str] = []
    root = df.view_root(value)
    if root is not None:
        names = [dotted(t) for t in targets if dotted(t)]
    elif isinstance(value, ast.Call) and \
            isinstance(value.func, ast.Attribute) and \
            value.func.attr in _MULTI_VIEW:
        root = dotted(value.func.value)
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                names.extend(d for d in map(dotted, t.elts) if d)
    if root is None:
        return []
    root = roots.get(root, root)
    return [(n, root, stmt.lineno) for n in names if n != root]


def _param_names(fn: ast.AST) -> Set[str]:
    """Loop targets over `.parameters()` / `.named_parameters()`."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.For, ast.comprehension)) and \
                isinstance(node.iter, ast.Call) and \
                isinstance(node.iter.func, ast.Attribute) and \
                node.iter.func.attr in ("parameters", "named_parameters"):
            tgt = node.target
            if isinstance(tgt, ast.Tuple) and tgt.elts:
                tgt = tgt.elts[-1]
            d = dotted(tgt)
            if d:
                out.add(d)
    return out


def _writes_any(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and df.inplace_writes(node):
            return True
    return False


def _live_views(cfg: df.CFG) -> Dict[int, FrozenSet[_Fact]]:
    """Forward may-analysis: the views live on entry to each statement
    (a view dies when its name or its buffer's name is rebound)."""
    live: Dict[int, FrozenSet[_Fact]] = {}
    if cfg.entry is None:
        return live
    live[id(cfg.entry)] = frozenset()
    work = [cfg.entry]
    while work:
        stmt = work.pop()
        facts = live[id(stmt)]
        bound = _bound_names(stmt)
        out = frozenset(f for f in facts
                        if f[0] not in bound and f[1] not in bound)
        out |= frozenset(_new_views(stmt, facts))
        for succ in cfg.successors(stmt):
            cur = live.get(id(succ))
            merged = out if cur is None else cur | out
            if cur is None or merged != cur:
                live[id(succ)] = merged
                work.append(succ)
    return live


@rule("RL022", "use-after-inplace: a view of a buffer taken before an "
               "in-place write to the buffer and read after it on a CFG "
               "path (eager counterpart of use-after-donate)",
      scope=_TORCH_SCOPE)
def check_use_after_inplace(ctx: FileContext) -> Iterable[Finding]:
    if not _uses_torch(ctx):
        return
    for fn in _functions(ctx):
        if not _writes_any(fn):
            continue
        cfg = df.build_cfg(fn)
        live = _live_views(cfg)
        params = _param_names(fn)
        reported: Set[Tuple[int, str]] = set()
        for stmt in cfg.stmts:
            facts = live.get(id(stmt))
            if not facts:
                continue
            roots = {v: r for v, r, _ in facts}
            for call in df.calls_in_stmt(stmt):
                for buf, _node, how in df.inplace_writes(call):
                    for view, root, line in sorted(facts):
                        if buf == "<parameters>":
                            if not (df.is_parameter_like(root)
                                    or root in params):
                                continue
                        elif root != roots.get(buf, buf) or view == buf:
                            continue
                        hit = df.first_read_after(cfg, stmt, view)
                        if hit is None or (hit[0].lineno, view) in reported:
                            continue
                        reported.add((hit[0].lineno, view))
                        yield ctx.finding(
                            hit[0], "RL022",
                            f"`{view}` is a view of `{root}` taken at line "
                            f"{line}; `{root}` is updated in place at line "
                            f"{stmt.lineno} ({how}) and `{view}` is read "
                            "here — a view shares the buffer's storage, so "
                            "it now holds the new values, not the ones it "
                            "was taken from; `.clone()` it before the write "
                            "if the old values are meant, or take the view "
                            "after the write")


# =====================================================================
# RL023 sharding-axis-hygiene (whole-program)
# =====================================================================
#
# Joined over the per-file `torch_extract` summaries: logical axes reach
# mesh axes through rule tables (`parallel/sharding.py` DEFAULT_RULES,
# `rules=` overrides), and `placements_for` drops an axis the mesh does
# not have — so a rule naming an axis no MeshSpec / ShardSpec in the
# package declares, a logical axis no rule table maps, or a
# PartitionSpec literal over an undeclared axis all place the dim
# replicated, silently.


def _declared_axes(graph) -> Set[str]:
    declared: Set[str] = set()
    for m in graph.mesh_axes:
        declared.update(m["axes"])
    return declared


@project_rule("RL023", "sharding-axis-hygiene: logical-axis rules, "
                       "logical axes at sharding call sites and "
                       "PartitionSpec literals that reach no mesh axis a "
                       "MeshSpec/ShardSpec declares (the dim is silently "
                       "replicated)",
              scope=_PROJECT_SCOPE)
def rl023_sharding_axis_hygiene(graph) -> Iterable[Finding]:
    declared = _declared_axes(graph)
    listing = ", ".join(sorted(declared))
    if declared:
        for r in graph.axis_rules:
            for a in r["axes"]:
                if a not in declared:
                    yield Finding(
                        r["file"], r["line"], "RL023",
                        f"logical axis '{r['logical']}' maps to mesh axis "
                        f"'{a}', which no MeshSpec/ShardSpec in the package "
                        f"declares (declared: {listing}) — placements_for "
                        "drops it and the dim is silently replicated; fix "
                        "the axis name or declare the mesh")
        for s in graph.specs:
            where = (f" (partition rule {s['rule']!r})"
                     if s.get("rule") else "")
            for dim in s["dims"]:
                for a in (dim if isinstance(dim, list) else [dim]):
                    if isinstance(a, str) and a != "?" and \
                            a not in declared:
                        yield Finding(
                            s["file"], s["line"], "RL023",
                            f"PartitionSpec{where} names mesh axis '{a}' "
                            "but no MeshSpec/ShardSpec in the package "
                            f"declares it (declared: {listing}) — "
                            "placements_for drops it and the dim is "
                            "silently replicated; fix the axis name or "
                            "declare the mesh")
    known = {r["logical"] for r in graph.axis_rules}
    if not known:
        return                             # no rule table in the tree
    for use in graph.logical_uses:
        for name in use["names"]:
            if name not in known:
                yield Finding(
                    use["file"], use["line"], "RL023",
                    f"logical axis '{name}' at this {use['call']} call is "
                    "mapped by no rule table in the package (known: "
                    f"{', '.join(sorted(known))}) — the rules resolve it "
                    "to None and the dim is silently replicated; fix the "
                    "name or add a rule")


# =====================================================================
# RL024 cuda-before-fork (whole-program)
# =====================================================================
#
# A process that has initialised CUDA cannot hand the card to a forked
# child: the child's first CUDA call raises "Cannot re-initialize CUDA
# in forked subprocess".  The worker forge forks CPU workers from a
# template that preimports `worker_forge_preimports` (and the modules
# they import): CUDA initialised at import time of any of them breaks
# every fork, and the forge's runtime guard (core/config.py) catches it
# only on the paths a run executes.  Within one function, an
# initialisation followed by os.fork() or a fork-context Process on
# some CFG path is the same hazard.  The fix is a "spawn" context, or
# initialising CUDA in the child.


def _forge_closure(graph) -> Dict[str, str]:
    """Modules imported when the forge preimports its list: module ->
    the preimport that pulls it in (parent packages included)."""
    reached: Dict[str, str] = {}
    work: List[Tuple[str, str]] = [(m, m) for m in graph.preimports]
    while work:
        mod, via = work.pop()
        parts = mod.split(".")
        for i in range(1, len(parts) + 1):
            name = ".".join(parts[:i])
            if name in reached or name not in graph.modules:
                continue
            reached[name] = via
            work.extend((imp, via)
                        for imp in graph.modules[name]["imports"])
    return reached


@project_rule("RL024", "cuda-before-fork: CUDA initialised at import "
                       "time of a module the worker forge preimports, or "
                       "before os.fork()/a fork-context Process on a CFG "
                       "path of one function",
              scope=_PROJECT_SCOPE)
def rl024_cuda_before_fork(graph) -> Iterable[Finding]:
    for mod, via in sorted(_forge_closure(graph).items()):
        info = graph.modules[mod]
        for hit in info["cuda_at_import"]:
            chain = "" if mod == via else f" (imported through {via})"
            yield Finding(
                info["file"], hit["line"], "RL024",
                f"{hit['what']} initialises CUDA when {mod} is imported, "
                f"and the worker forge preimports it{chain} — every "
                "worker forked from the template then fails on its first "
                "CUDA call (\"Cannot re-initialize CUDA in forked "
                "subprocess\"); initialise CUDA lazily, inside the "
                "function that uses it")
    for f in graph.fork_after_init:
        yield Finding(
            f["file"], f["line"], "RL024",
            f"{f['fork']} here forks a process that initialised CUDA at "
            f"line {f['init_line']} ({f['init']}) in "
            f"'{f['function']}' — the child cannot use the card "
            "(\"Cannot re-initialize CUDA in forked subprocess\"); use a "
            "\"spawn\" context, or fork before touching CUDA")
