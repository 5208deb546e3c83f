"""Per-function value-provenance dataflow for the torch-surface rules.

The lexical rules (RL001-RL019) match shapes; the accelerator-hazard
family (RL020-RL024, :mod:`ray_tpu_torch.analysis.torchrules`) needs to
know *what a value is* at a program point.  This module provides that
layer: a lightweight statement-level CFG over one function body plus a
forward fixpoint that tags every expression with a provenance:

- **device** — a tensor that may live on the card: the result of a
  ``torch.*`` / ``F.*`` op (a factory only when its ``device=`` is not
  the CPU: torch's default device is), of ``.to(device)`` / ``.cuda()``,
  or of calling an ``nn.Module`` the file builds; formals annotated
  ``torch.Tensor`` start as device values;
- **static-python** — ordinary host Python values (the default);
- **host** — a device value pulled back to the host: ``.item()`` /
  ``.tolist()`` / ``.cpu()`` / ``.numpy()``, ``np.asarray`` of a tensor,
  ``float()`` / ``int()`` / ``bool()`` of one.  Each such call is a
  device sync and is recorded as a :class:`Materialization` event, as are
  ``.synchronize()``, ``.nonzero()`` (and the other ops whose output
  shape the host must wait for), boolean-mask indexing, ``range()`` over
  a device scalar, and Python control flow on a device value (an
  implicit ``bool()``).

Two bits ride along the lattice: SHAPE (``x.shape`` / ``x.size()`` /
``len(x)`` of a device value is host metadata: reading it never syncs)
and BOOL (a device comparison or mask op, whose use as an index makes
the host wait for the number of true elements).

Everything here is syntactic and per-function: self attributes are
tracked as dotted names within one body, nothing crosses function
boundaries, unknown calls propagate the join of their argument tags.
Under-approximation (a device value the analysis cannot see) costs a
missed finding, never a false one — with one deliberate exception:
``.cpu()`` of a value of unknown provenance counts as a sync, since only
tensors have the method and in per-step code it is the device-to-host
copy.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.analysis.engine import FileContext, dotted, last_segment

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

# ------------------------------------------------------------- the lattice
#
# Low two bits: STATIC < HOST < DEVICE (join = max).  Bit 4: the value
# derives from shape metadata of a tensor; bit 8: a boolean mask (both OR
# under join).

STATIC = 0
HOST = 1
DEVICE = 2
SHAPE = 4
BOOL = 8


def tag_of(mask: int) -> int:
    return mask & 3


def is_device(mask: int) -> bool:
    return (mask & 3) == DEVICE


def join(a: int, b: int) -> int:
    return max(a & 3, b & 3) | ((a | b) & (SHAPE | BOOL))


# --------------------------------------------------- torch call vocabulary

#: torch namespaces whose calls return host values or objects, not
#: tensors (queries, modes, process groups, profilers).
_TORCH_HOST_PREFIXES = (
    "torch.cuda.", "torch.backends.", "torch.distributed.", "torch.utils.",
    "torch.multiprocessing.", "torch.profiler.", "torch.testing.",
    "torch.jit.", "torch.compiler.", "torch.library.", "torch.hub.",
    "torch._dynamo.", "torch.autograd.profiler.", "torch.nn.", "torch.set_",
    "torch.get_", "torch.is_", "torch.use_")
_TORCH_HOST_CALLS = {
    "torch.device", "torch.dtype", "torch.finfo", "torch.iinfo",
    "torch.Size", "torch.Generator", "torch.no_grad", "torch.enable_grad",
    "torch.inference_mode", "torch.autocast", "torch.manual_seed",
    "torch.seed", "torch.initial_seed", "torch.save", "torch.load",
    "torch.compile", "torch.numel", "torch.typename",
    "torch.are_deterministic_algorithms_enabled"}
#: factories: on the CPU unless `device=` says otherwise.
_FACTORIES = {"empty", "zeros", "ones", "full", "arange", "tensor",
              "as_tensor", "rand", "randn", "randint", "randperm",
              "linspace", "logspace", "eye", "empty_strided"}
#: ops whose output SHAPE depends on the data: the host waits for it.
_SHAPE_SYNC_OPS = {"nonzero", "masked_select", "unique",
                   "unique_consecutive", "argwhere"}
#: ops returning boolean masks.
_BOOL_OPS = {"isnan", "isinf", "isfinite", "isin", "isneginf", "isposinf",
             "logical_and", "logical_or", "logical_not", "logical_xor",
             "eq", "ne", "gt", "ge", "lt", "le", "bool"}
#: tensor metadata: host values, no sync.
_SHAPE_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                "requires_grad", "is_leaf", "grad_fn", "names"}
_SHAPE_METHODS = {"size", "dim", "numel", "stride", "element_size",
                  "nelement", "ndimension", "data_ptr", "is_contiguous",
                  "get_device", "storage_offset", "is_floating_point",
                  "is_complex", "untyped_storage"}

#: host materializers: receiver-method style (of a device tensor).
_MAT_METHODS = {"item", "tolist", "numpy"}
#: host materializers: np namespace functions over a tensor.
_MAT_NP = {"np.asarray", "numpy.asarray", "np.array", "numpy.array",
           "np.ascontiguousarray", "numpy.ascontiguousarray"}
#: host materializers: builtins over one arg.
_MAT_BUILTINS = {"float", "int", "bool"}
#: the implicit conversions RL020 owns (Python asks a tensor for a value).
IMPLICIT_KINDS = {"if", "while", "assert", "ifexp", "not", "and/or",
                  "float", "int", "bool", "range"}


def _is_cpu_literal(node: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and dotted(node.func) == "torch.device" \
            and node.args:
        return _is_cpu_literal(node.args[0])
    return False


def _kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _to_target(call: ast.Call) -> Optional[ast.AST]:
    """The device argument of `x.to(...)`, or None for a dtype-only move
    (`.to(torch.float32)`, `.to(dtype=...)`, `.to(other.dtype)`)."""
    dev = _kwarg(call, "device")
    if dev is not None:
        return dev
    if call.args:
        a = call.args[0]
        name = dotted(a) or ""
        if (name.startswith("torch.") and name != "torch.device") \
                or last_segment(name) == "dtype":
            return None
        return a
    return None


def module_callables(ctx: FileContext) -> Set[str]:
    """Dotted names the file binds to an ``nn.Module`` it builds
    (``self.proj = nn.Linear(...)``): calling one returns device values."""
    out: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
                isinstance(node.value, ast.Call):
            fname = dotted(node.value.func) or ""
            if fname.startswith(("nn.", "torch.nn.")) and \
                    fname.rsplit(".", 1)[-1][:1].isupper():
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    d = dotted(t)
                    if d:
                        out.add(d)
    return out


def _tensor_annotated(arg: ast.arg) -> bool:
    ann = arg.annotation
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        text = ann.value
    else:
        text = ast.unparse(ann)
    return text in ("torch.Tensor", "Tensor")


def tensor_params(fn: ast.AST) -> Dict[str, int]:
    """Seed: formals annotated ``torch.Tensor`` start as device values."""
    args = getattr(fn, "args", None)
    if args is None:
        return {}
    return {a.arg: DEVICE
            for a in args.posonlyargs + args.args + args.kwonlyargs
            if _tensor_annotated(a)}


# ------------------------------------------------------- statement-level CFG


class CFG:
    """Successor edges between the statements of ONE function body.
    Compound headers (If/While/For/Try/With) are nodes themselves; their
    nested statements are separate nodes.  Nested defs do not flow."""

    def __init__(self) -> None:
        self.entry: Optional[ast.stmt] = None
        self.stmts: List[ast.stmt] = []
        self.succ: Dict[int, List[ast.stmt]] = {}

    def _edge(self, frm: ast.stmt, to: Optional[ast.stmt]) -> None:
        if to is not None:
            lst = self.succ.setdefault(id(frm), [])
            if all(s is not to for s in lst):
                lst.append(to)

    def successors(self, stmt: ast.stmt) -> List[ast.stmt]:
        return self.succ.get(id(stmt), [])


def build_cfg(fn: ast.AST) -> CFG:
    cfg = CFG()
    body = getattr(fn, "body", None)
    if not isinstance(body, list):         # Lambda: no statements
        return cfg
    cfg.entry = _wire(cfg, body, None, [])
    return cfg


def _wire(cfg: CFG, body: Sequence[ast.stmt], follow: Optional[ast.stmt],
          loops: List[Tuple[ast.stmt, Optional[ast.stmt]]]
          ) -> Optional[ast.stmt]:
    """Wire `body`; `follow` is what executes after it.  Returns the
    body's entry statement (or `follow` when the body is empty)."""
    entry = follow
    for stmt in reversed(list(body)):
        entry = _wire_stmt(cfg, stmt, entry, loops)
    return entry


def _wire_stmt(cfg: CFG, stmt: ast.stmt, follow: Optional[ast.stmt],
               loops: List[Tuple[ast.stmt, Optional[ast.stmt]]]
               ) -> ast.stmt:
    cfg.stmts.append(stmt)
    if isinstance(stmt, ast.If):
        cfg._edge(stmt, _wire(cfg, stmt.body, follow, loops))
        if stmt.orelse:
            cfg._edge(stmt, _wire(cfg, stmt.orelse, follow, loops))
        else:
            cfg._edge(stmt, follow)
    elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
        exit_to = _wire(cfg, stmt.orelse, follow, loops) \
            if stmt.orelse else follow
        body_entry = _wire(cfg, stmt.body, stmt, loops + [(stmt, exit_to)])
        cfg._edge(stmt, body_entry)
        cfg._edge(stmt, exit_to)           # zero-iteration path
    elif isinstance(stmt, (ast.Return, ast.Raise)):
        pass                               # terminates the path
    elif isinstance(stmt, ast.Break):
        if loops:
            cfg._edge(stmt, loops[-1][1])
    elif isinstance(stmt, ast.Continue):
        if loops:
            cfg._edge(stmt, loops[-1][0])
    elif isinstance(stmt, ast.Try):
        after = _wire(cfg, stmt.finalbody, follow, loops) \
            if stmt.finalbody else follow
        else_entry = _wire(cfg, stmt.orelse, after, loops) \
            if stmt.orelse else after
        handler_entries = [
            _wire(cfg, h.body, after, loops) for h in stmt.handlers]
        body_entry = _wire(cfg, stmt.body, else_entry, loops)
        cfg._edge(stmt, body_entry)
        for he in handler_entries:
            cfg._edge(stmt, he)
            # Any statement of the try body may raise into the handler
            # — including a donating call that dies mid-statement.
            for sub in stmt.body:
                cfg._edge(sub, he)
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        cfg._edge(stmt, _wire(cfg, stmt.body, follow, loops))
    elif isinstance(stmt, ast.Match):
        for case in stmt.cases:
            cfg._edge(stmt, _wire(cfg, case.body, follow, loops))
        cfg._edge(stmt, follow)            # no-case-matched path
    else:
        # Simple statements and nested def/class (whose bodies run when
        # called, not here) fall through.
        cfg._edge(stmt, follow)
    return stmt


def stmt_exprs(stmt: ast.stmt) -> List[ast.AST]:
    """The statement's OWN expressions (headers only — nested statements
    of compound bodies are separate CFG nodes)."""
    if isinstance(stmt, ast.Assign):
        return [stmt.value]
    if isinstance(stmt, ast.AnnAssign):
        return [stmt.value] if stmt.value is not None else []
    if isinstance(stmt, ast.AugAssign):
        return [stmt.target, stmt.value]
    if isinstance(stmt, (ast.Expr, ast.Return)):
        return [stmt.value] if stmt.value is not None else []
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in stmt.items]
    if isinstance(stmt, ast.Assert):
        return [stmt.test] + ([stmt.msg] if stmt.msg is not None else [])
    if isinstance(stmt, ast.Raise):
        return [e for e in (stmt.exc, stmt.cause) if e is not None]
    if isinstance(stmt, ast.Match):
        return [stmt.subject]
    if isinstance(stmt, ast.Delete):
        return list(stmt.targets)
    return []




# ------------------------------------------------------ provenance analysis


@dataclass
class Materialization:
    """One device→host sync point."""

    node: ast.AST
    stmt: ast.stmt
    kind: str            # ".item", ".cpu", "int", "if", "synchronize", ...
    in_comprehension: bool = False


class FlowAnalysis:
    """Forward provenance fixpoint over one function's CFG.

    `seed` maps parameter names to initial masks (every ``torch.Tensor``
    formal to DEVICE by default); `device_callables` is the set of dotted
    names known to return device values when called (the file's
    ``nn.Module`` attributes)."""

    def __init__(self, ctx: FileContext, fn: ast.AST,
                 seed: Optional[Dict[str, int]] = None,
                 device_callables: Optional[Iterable[str]] = None):
        self.ctx = ctx
        self.fn = fn
        self.cfg = build_cfg(fn)
        self.device_callables = set(device_callables or ())
        self.expr_tags: Dict[int, int] = {}
        #: id(node) -> Materialization (dict: fixpoint re-visits
        #: overwrite instead of duplicating)
        self._events: Dict[int, Materialization] = {}
        self.env_in: Dict[int, Dict[str, int]] = {}
        self._cur_stmt: Optional[ast.stmt] = None
        self._comp_depth = 0
        self._run(tensor_params(fn) if seed is None else dict(seed))

    # -- results ---------------------------------------------------------

    @property
    def materializations(self) -> List[Materialization]:
        return sorted(self._events.values(),
                      key=lambda m: (m.node.lineno, m.node.col_offset))

    def mask(self, expr: ast.AST) -> int:
        return self.expr_tags.get(id(expr), STATIC)

    # -- fixpoint --------------------------------------------------------

    def _run(self, seed: Dict[str, int]) -> None:
        entry = self.cfg.entry
        if entry is None:
            return
        self.env_in[id(entry)] = dict(seed)
        work: List[ast.stmt] = [entry]
        visits: Dict[int, int] = {}
        cap = max(len(self.cfg.stmts) * 8, 64)
        while work:
            stmt = work.pop()
            visits[id(stmt)] = visits.get(id(stmt), 0) + 1
            if visits[id(stmt)] > cap:
                continue                   # termination backstop
            env = dict(self.env_in.get(id(stmt), {}))
            self._transfer(stmt, env)
            for succ in self.cfg.successors(stmt):
                cur = self.env_in.get(id(succ))
                if cur is None:
                    self.env_in[id(succ)] = dict(env)
                    work.append(succ)
                    continue
                changed = False
                for k, v in env.items():
                    j = join(cur.get(k, STATIC), v)
                    if cur.get(k, STATIC) != j:
                        cur[k] = j
                        changed = True
                if changed:
                    work.append(succ)

    def _event(self, node: ast.AST, kind: str) -> None:
        self._events[id(node)] = Materialization(
            node=node, stmt=self._cur_stmt, kind=kind,
            in_comprehension=self._comp_depth > 0)

    # -- transfer --------------------------------------------------------

    def _transfer(self, stmt: ast.stmt, env: Dict[str, int]) -> None:
        self._cur_stmt = stmt
        if isinstance(stmt, ast.Assign):
            mask = self._tag(stmt.value, env)
            for tgt in stmt.targets:
                self._bind(tgt, mask, env, stmt.value)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt.target, self._tag(stmt.value, env), env,
                           stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            mask = join(self._tag(stmt.value, env),
                        self._lookup(stmt.target, env))
            self._bind(stmt.target, mask, env)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            # Elements of a device/host iterable carry its provenance.
            self._bind(stmt.target, self._tag(stmt.iter, env), env)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                mask = self._tag(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, mask, env)
        elif isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                d = dotted(tgt)
                env.pop(d, None)
        elif isinstance(stmt, (ast.If, ast.While)):
            # Python asks the test for bool(): a sync when it is a tensor.
            if is_device(self._tag(stmt.test, env)):
                self._event(stmt.test,
                            "if" if isinstance(stmt, ast.If) else "while")
        elif isinstance(stmt, ast.Assert):
            if is_device(self._tag(stmt.test, env)):
                self._event(stmt.test, "assert")
            if stmt.msg is not None:
                self._tag(stmt.msg, env)
        else:
            for expr in stmt_exprs(stmt):
                self._tag(expr, env)

    def _lookup(self, node: ast.AST, env: Dict[str, int]) -> int:
        d = dotted(node)
        return env.get(d, STATIC) if d else STATIC

    def _bind(self, target: ast.AST, mask: int, env: Dict[str, int],
              value: Optional[ast.AST] = None) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = mask
        elif isinstance(target, ast.Attribute):
            d = dotted(target)
            if d:
                env[d] = mask
        elif isinstance(target, (ast.Tuple, ast.List)):
            elts = getattr(value, "elts", None) \
                if isinstance(value, (ast.Tuple, ast.List)) else None
            if elts is not None and len(elts) == len(target.elts):
                for t, v in zip(target.elts, elts):
                    self._bind(t, self.expr_tags.get(id(v), mask), env, v)
            else:
                for t in target.elts:
                    self._bind(t, mask, env)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, mask, env)
        elif isinstance(target, ast.Subscript):
            d = dotted(target.value)
            if d:                          # write INTO a container: join
                env[d] = join(env.get(d, STATIC), mask & ~BOOL)

    # -- expression tagging ---------------------------------------------

    def _tag(self, e: ast.AST, env: Dict[str, int]) -> int:
        mask = self._tag_inner(e, env)
        self.expr_tags[id(e)] = mask
        return mask

    def _tag_inner(self, e: ast.AST, env: Dict[str, int]) -> int:
        if isinstance(e, ast.Constant):
            return STATIC
        if isinstance(e, ast.Name):
            return env.get(e.id, STATIC)
        if isinstance(e, ast.Attribute):
            d = dotted(e)
            if d and d in env:
                return env[d]
            base = self._tag(e.value, env)
            if e.attr in _SHAPE_ATTRS:
                # Tensor metadata lives on the host: reading it never
                # waits for the card.
                return STATIC | (SHAPE if tag_of(base) != STATIC
                                 else base & SHAPE)
            return base                    # x.T, x.mT, x.data, x.grad, ...
        if isinstance(e, ast.Call):
            return self._tag_call(e, env)
        if isinstance(e, ast.BinOp):
            left = self._tag(e.left, env)
            right = self._tag(e.right, env)
            mask = join(left, right)
            if isinstance(e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)) and \
                    (left | right) & BOOL:
                return mask                # mask algebra stays a mask
            return mask & ~BOOL
        if isinstance(e, ast.UnaryOp):
            mask = self._tag(e.operand, env)
            if isinstance(e.op, ast.Not):
                if is_device(mask):
                    self._event(e, "not")
                    return HOST
                return mask & ~BOOL
            return mask                    # ~mask stays a mask
        if isinstance(e, ast.BoolOp):
            mask = STATIC
            for v in e.values:
                m = self._tag(v, env)
                if is_device(m):
                    self._event(v, "and/or")
                mask = join(mask, m)
            return mask & ~BOOL
        if isinstance(e, ast.Compare):
            mask = self._tag(e.left, env)
            for c in e.comparators:
                mask = join(mask, self._tag(c, env))
            if all(isinstance(op, (ast.In, ast.NotIn, ast.Is, ast.IsNot))
                   for op in e.ops):
                # Key membership and identity are decided by Python on the
                # host, never by a tensor.
                return STATIC | (mask & SHAPE)
            if is_device(mask):
                return mask | BOOL         # an elementwise device mask
            return mask & ~BOOL
        if isinstance(e, ast.Subscript):
            base = self._tag(e.value, env)
            idx = self._tag(e.slice, env)
            if isinstance(getattr(e, "ctx", None), ast.Load) and \
                    is_device(idx) and idx & BOOL:
                self._event(e, "boolean-mask index")
            return join(base, idx & ~BOOL) if is_device(base) \
                else base                  # shape[0] keeps the SHAPE bit
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            mask = STATIC
            for v in e.elts:
                mask = join(mask, self._tag(v, env))
            return mask
        if isinstance(e, ast.Dict):
            mask = STATIC
            for v in e.values:
                if v is not None:
                    mask = join(mask, self._tag(v, env))
            for k in e.keys:
                if k is not None:
                    self._tag(k, env)
            return mask
        if isinstance(e, ast.IfExp):
            if is_device(self._tag(e.test, env)):
                self._event(e.test, "ifexp")
            return join(self._tag(e.body, env), self._tag(e.orelse, env))
        if isinstance(e, ast.Starred):
            return self._tag(e.value, env)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            return self._tag_comprehension(e, env)
        if isinstance(e, ast.Lambda):
            return STATIC                  # a closure object, not a value
        if isinstance(e, (ast.JoinedStr, ast.FormattedValue)):
            for sub in ast.iter_child_nodes(e):
                if isinstance(sub, ast.expr):
                    self._tag(sub, env)
            return STATIC
        if isinstance(e, ast.NamedExpr):
            mask = self._tag(e.value, env)
            self._bind(e.target, mask, env)
            return mask
        if isinstance(e, ast.Await):
            return self._tag(e.value, env)
        if isinstance(e, ast.Slice):
            mask = STATIC
            for sub in (e.lower, e.upper, e.step):
                if sub is not None:
                    mask = join(mask, self._tag(sub, env))
            return mask & ~BOOL
        return STATIC

    def _tag_comprehension(self, e: ast.AST, env: Dict[str, int]) -> int:
        # A comprehension IS a loop: bind its targets from the iterables
        # in a scratch env; materializers inside run once per element.
        scratch = dict(env)
        self._comp_depth += 1
        try:
            for gen in e.generators:
                mask = self._tag(gen.iter, scratch)
                self._bind(gen.target, mask, scratch)
                for cond in gen.ifs:
                    if is_device(self._tag(cond, scratch)):
                        self._event(cond, "if")
            if isinstance(e, ast.DictComp):
                self._tag(e.key, scratch)
                return self._tag(e.value, scratch)
            return self._tag(e.elt, scratch)
        finally:
            self._comp_depth -= 1

    def _tag_call(self, call: ast.Call, env: Dict[str, int]) -> int:
        func = call.func
        fname = dotted(func)
        seg = last_segment(fname) if fname else (
            func.attr if isinstance(func, ast.Attribute) else "")
        recv = func.value if isinstance(func, ast.Attribute) else None

        # -- explicit syncs that hold no value ---------------------------
        if seg == "synchronize":
            if recv is not None:
                self._tag(recv, env)
            self._event(call, "synchronize")
            return STATIC

        # -- host materializers: the sync points ------------------------
        inner: Optional[ast.AST] = None
        kind: Optional[str] = None
        if fname in _MAT_NP and call.args:
            inner, kind = call.args[0], seg
        elif isinstance(func, ast.Name) and func.id in _MAT_BUILTINS \
                and len(call.args) == 1:
            inner, kind = call.args[0], func.id
        elif isinstance(func, ast.Name) and func.id == "range":
            mask = STATIC
            for a in call.args:
                m = self._tag(a, env)
                if is_device(m):
                    self._event(call, "range")
                mask = join(mask, m)
            return STATIC
        elif recv is not None and func.attr in _MAT_METHODS and \
                not call.args:
            inner, kind = recv, "." + func.attr
        elif recv is not None and (func.attr == "cpu" or (
                func.attr == "to" and _is_cpu_literal(_to_target(call)))):
            # Only tensors have .cpu(): unless the value is already a
            # host copy, this is the device-to-host copy.
            mask = self._tag(recv, env)
            for a in call.args:
                self._tag(a, env)
            if tag_of(mask) != HOST and not mask & SHAPE:
                self._event(call, "." + func.attr)
            return HOST
        if inner is not None:
            mask = self._tag(inner, env)
            for extra in call.args[1:]:
                self._tag(extra, env)
            if is_device(mask):
                self._event(call, kind)
                return HOST | (mask & SHAPE)
            return mask & ~BOOL            # int(static)/int(host): no sync

        # -- evaluate arguments (always, for events inside them) --------
        arg_mask = STATIC
        for a in call.args:
            arg_mask = join(arg_mask, self._tag(a, env))
        for kw in call.keywords:
            arg_mask = join(arg_mask, self._tag(kw.value, env))
        recv_mask = self._tag(recv, env) if recv is not None else STATIC
        if isinstance(func, ast.Call):     # torch.func.grad(f)(x) and kin
            recv_mask = join(recv_mask, self._tag(func, env))

        # len(tensor) is shape metadata.
        if isinstance(func, ast.Name) and func.id == "len" \
                and len(call.args) == 1:
            m = self.expr_tags.get(id(call.args[0]), STATIC)
            return STATIC | (SHAPE if tag_of(m) != STATIC else m & SHAPE)

        # -- torch namespace ---------------------------------------------
        if fname and fname.startswith(("torch.", "F.", "nn.functional.")):
            if fname == "torch.from_numpy":
                return HOST
            if fname in _TORCH_HOST_CALLS or (
                    fname.startswith(_TORCH_HOST_PREFIXES)
                    and not fname.startswith("torch.nn.functional.")):
                return STATIC
            if seg in _FACTORIES and fname.count(".") == 1:
                dev = _kwarg(call, "device")
                if dev is None or _is_cpu_literal(dev):
                    return HOST            # torch's default device
                return DEVICE
            if seg in _SHAPE_SYNC_OPS or (seg == "where"
                                          and len(call.args) == 1):
                if is_device(arg_mask):
                    self._event(call, seg)
                return DEVICE
            if tag_of(arg_mask) == HOST or seg.endswith("_like"):
                # An op on host copies runs on the host; `*_like` follows
                # its input.
                return arg_mask & ~BOOL
            return DEVICE | (BOOL if seg in _BOOL_OPS else 0)
        if fname and fname in self.device_callables:
            return DEVICE                  # an nn.Module the file builds
        if fname and fname in env and is_device(env[fname]):
            return DEVICE

        # -- tensor methods ----------------------------------------------
        if recv is not None:
            attr = func.attr
            if attr == "cuda":
                return DEVICE
            if attr == "to":
                target = _to_target(call)
                return recv_mask if target is None else DEVICE
            if attr in _SHAPE_METHODS:
                return STATIC | (SHAPE if tag_of(recv_mask) != STATIC
                                 else recv_mask & SHAPE)
            if is_device(recv_mask):
                if attr in _SHAPE_SYNC_OPS:
                    self._event(call, "." + attr)
                    return DEVICE
                if attr in _BOOL_OPS:
                    return DEVICE | BOOL
        return join(arg_mask, recv_mask) & ~BOOL


# ----------------------------------------------------- read/write queries


def reads_name(stmt: ast.stmt, name: str) -> Optional[ast.AST]:
    """The first Load of dotted `name` among the statement's own
    expressions (assign targets and nested bodies excluded)."""
    for expr in stmt_exprs(stmt):
        for node in ast.walk(expr):
            if isinstance(node, (ast.Name, ast.Attribute)) and \
                    isinstance(getattr(node, "ctx", None), ast.Load) and \
                    dotted(node) == name:
                return node
    return None


def writes_name(stmt: ast.stmt, name: str) -> bool:
    """Whether the statement rebinds dotted `name` (plain or tuple
    target, with-as, for-target, aug-assign, del)."""

    def target_hits(tgt: ast.AST) -> bool:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            return any(target_hits(t) for t in tgt.elts)
        if isinstance(tgt, ast.Starred):
            return target_hits(tgt.value)
        return dotted(tgt) == name

    if isinstance(stmt, ast.Assign):
        return any(target_hits(t) for t in stmt.targets)
    if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        return target_hits(stmt.target)
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return target_hits(stmt.target)
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return any(item.optional_vars is not None
                   and target_hits(item.optional_vars)
                   for item in stmt.items)
    if isinstance(stmt, ast.Delete):
        return any(dotted(t) == name for t in stmt.targets)
    return False


def first_read_after(cfg: CFG, start: ast.stmt,
                     name: str) -> Optional[Tuple[ast.stmt, ast.AST]]:
    """BFS the CFG from `start`'s successors: the first statement on any
    path that READS dotted `name` before anything rebinds it.  Returns
    (statement, offending node) or None.  A statement that both reads
    and writes (``x = f(x)``) counts as a read."""
    from collections import deque

    seen = set()
    queue = deque(cfg.successors(start))
    while queue:
        stmt = queue.popleft()
        if id(stmt) in seen:
            continue
        seen.add(id(stmt))
        node = reads_name(stmt, name)
        if node is not None:
            return stmt, node
        if writes_name(stmt, name):
            continue                       # rebound: this path is safe
        queue.extend(cfg.successors(stmt))
    return None


# ------------------------------------------------------------- aliasing
#
# RL022's vocabulary: which expressions are views of a buffer (they share
# its storage), and which statements update a buffer in place.

#: tensor methods whose result shares the receiver's storage.
VIEW_METHODS = {"view", "view_as", "reshape", "flatten", "narrow",
                "select", "transpose", "permute", "unsqueeze", "squeeze",
                "expand", "expand_as", "unflatten", "detach", "t", "T",
                "mT", "data", "as_strided", "diagonal", "movedim",
                "unfold", "real", "imag"}
#: `*_` methods that do not write the tensor's data.
_NOT_DATA_WRITES = {"requires_grad_", "share_memory_", "retain_grad_",
                    "pin_memory_", "record_stream_"}


def view_root(expr: ast.AST) -> Optional[str]:
    """The dotted buffer `expr` is a view of — `buf[...]`, `buf.view(...)`,
    `buf.reshape(...)[:, 0]`, ... — or None when `expr` is no view (a
    plain name is the buffer itself, not a view of it)."""
    cur = expr
    steps = 0
    while True:
        if isinstance(cur, ast.Subscript):
            cur = cur.value
        elif isinstance(cur, ast.Call) and \
                isinstance(cur.func, ast.Attribute) and \
                cur.func.attr in VIEW_METHODS:
            cur = cur.func.value
        elif isinstance(cur, ast.Attribute) and cur.attr in VIEW_METHODS:
            cur = cur.value
        else:
            break
        steps += 1
    if steps == 0:
        return None
    return dotted(cur)


def is_inplace_method(name: str) -> bool:
    return (name.endswith("_") and not name.startswith("_")
            and name not in _NOT_DATA_WRITES)


_OPTIMIZER = re.compile(r"^_?(opt|optim|optimizer)$|_(opt|optim)$|optimizer$",
                        re.I)


def _is_optimizer(name: Optional[str]) -> bool:
    return bool(_OPTIMIZER.search(last_segment(name)))


def inplace_writes(call: ast.Call) -> List[Tuple[str, ast.AST, str]]:
    """(dotted buffer, node, how) for each buffer this call writes in
    place: `buf.add_(...)` and the other `*_` methods, `out=buf`, and
    `optimizer.step()` (the buffer "<parameters>": every parameter)."""
    out: List[Tuple[str, ast.AST, str]] = []
    func = call.func
    if isinstance(func, ast.Attribute):
        if is_inplace_method(func.attr):
            # `buf[rows].add_(x)`, `buf.view(-1).copy_(x)` write buf.
            d = dotted(func.value) or view_root(func.value)
            if d:
                out.append((d, call, func.attr))
        elif func.attr == "step" and not call.args and \
                _is_optimizer(dotted(func.value)):
            out.append(("<parameters>", call, "optimizer.step()"))
    dest = _kwarg(call, "out")
    if dest is not None:
        elts = dest.elts if isinstance(dest, (ast.Tuple, ast.List)) \
            else [dest]
        out.extend((d, call, "out=") for d in map(dotted, elts) if d)
    return out


def is_parameter_like(name: str) -> bool:
    """Buffers an optimizer step writes: `.weight` / `.bias` attributes
    (loop targets over `.parameters()` are added by the rule)."""
    return last_segment(name) in ("weight", "bias")


# -------------------------------------------------------- CUDA and fork
#
# RL024's vocabulary: what initialises CUDA in this process, and what
# forks it.

#: torch.cuda calls that read the driver without initialising CUDA.
CUDA_QUERIES = {"is_available", "device_count", "is_initialized"}


def _cuda_literal(node: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call) and dotted(node.func) == "torch.device" \
            and node.args:
        return _cuda_literal(node.args[0])
    return False


def cuda_init(call: ast.Call) -> Optional[str]:
    """What this call does to initialise CUDA, or None."""
    fname = dotted(call.func) or ""
    if fname.startswith("torch.cuda.") and fname.count(".") == 2 \
            and last_segment(fname) not in CUDA_QUERIES:
        return fname + "()"
    if isinstance(call.func, ast.Attribute):
        if call.func.attr == "cuda":
            return ".cuda()"
        if call.func.attr == "to" and _cuda_literal(_to_target(call)):
            return ".to(cuda)"
    if _cuda_literal(_kwarg(call, "device")):
        return f"{last_segment(fname) or 'a call'}(device=cuda)"
    return None


_MP_MODULES = {"multiprocessing", "mp", "torch.multiprocessing"}
_PROCESS_CTORS = {"Process", "Pool"}


def _start_method(call: ast.Call) -> Optional[str]:
    """'fork', 'spawn', ... for `get_context("...")`; the default
    (fork, on Linux with this Python) for `get_context()`."""
    if last_segment(dotted(call.func)) != "get_context":
        return None
    if call.args and isinstance(call.args[0], ast.Constant):
        return str(call.args[0].value)
    method = _kwarg(call, "method")
    if isinstance(method, ast.Constant):
        return str(method.value)
    return "fork"


def fork_contexts(fn: ast.AST) -> Dict[str, str]:
    """Names bound to `multiprocessing.get_context(...)` in `fn`'s body,
    with their start method."""
    out: Dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            method = _start_method(node.value)
            if method is not None:
                for t in node.targets:
                    d = dotted(t)
                    if d:
                        out[d] = method
    return out


def forks(call: ast.Call, contexts: Dict[str, str]) -> Optional[str]:
    """How this call forks the process, or None: `os.fork()`, a
    `Process`/`Pool` of the default context (fork on Linux) or of a
    "fork" context, a `ProcessPoolExecutor` without a spawn context."""
    fname = dotted(call.func) or ""
    seg = _callee(call)
    if fname in ("os.fork", "os.forkpty"):
        return fname + "()"
    if seg in _PROCESS_CTORS and isinstance(call.func, ast.Attribute):
        recv = call.func.value
        if isinstance(recv, ast.Call):
            method = _start_method(recv)
        else:
            rname = dotted(recv) or ""
            method = contexts.get(rname) or (
                "fork" if rname in _MP_MODULES else None)
        if method == "fork":
            return f"a fork-context {seg}"
    if seg == "ProcessPoolExecutor":
        ctx = _kwarg(call, "mp_context")
        method = "fork" if ctx is None else (
            _start_method(ctx) if isinstance(ctx, ast.Call)
            else contexts.get(dotted(ctx) or ""))
        if method == "fork":
            return "a fork-context ProcessPoolExecutor"
    return None


def calls_in_stmt(stmt: ast.stmt) -> Iterable[ast.Call]:
    """Calls among the statement's own expressions (nested bodies and
    lambdas excluded: they run elsewhere)."""
    stack: List[ast.AST] = list(stmt_exprs(stmt))
    if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        stack.extend(getattr(stmt, "targets", None) or [stmt.target])
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            yield node
        if isinstance(node, (ast.Lambda,) + _FUNC_NODES):
            continue
        stack.extend(ast.iter_child_nodes(node))


def reachable(cfg: CFG, start: ast.stmt) -> Iterable[ast.stmt]:
    """Every statement on some CFG path after `start`."""
    seen: Set[int] = set()
    work = list(cfg.successors(start))
    while work:
        stmt = work.pop()
        if id(stmt) in seen:
            continue
        seen.add(id(stmt))
        yield stmt
        work.extend(cfg.successors(stmt))


# ----------------------------------------------------------- torch extract
#
# The per-file contribution RL023 and RL024 join across the package:
# declared mesh axes vs the logical-axis rule tables, the logical axes at
# sharding call sites and PartitionSpec literals (RL023); the module's
# name, its import-time imports and CUDA initialisations, the forge's
# preimport list and the init-before-fork paths (RL024).  Cached with
# the summary (the cache fingerprint hashes this module, so editing the
# extractor invalidates stale entries automatically).

# ShardSpec's multi-axis kwargs each declare one mesh axis of the same
# name when sized > 1 (shardgroup/spec.py mesh_axes drops size-1 axes).
_SHARDSPEC_AXIS_KWARGS = ("tp", "pp", "sp")
#: calls whose string arguments (after the mesh) are logical axes.
_LOGICAL_CALLS = {"named_sharding": 1, "with_logical_constraint": 2}
#: calls that take a {name: logical axes} dict as their third argument.
_LOGICAL_DICT_CALLS = {"shard_params"}
_RULES_KWARG_CALLS = {"named_sharding", "with_logical_constraint",
                      "shard_params", "logical_axis_rules",
                      "mesh_shardings_for"}
_PREIMPORT_KNOB = "worker_forge_preimports"


def _axes_from_node(node: ast.AST) -> List[str]:
    """Literal axis names in a tuple/list/str."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [e.value for e in node.elts
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str)]
    return []


def _dict_keys(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Dict):
        return [k.value for k in node.keys
                if isinstance(k, ast.Constant) and isinstance(k.value, str)]
    return []


def _meshspec_axes(ctx: FileContext, call: ast.Call) -> List[str]:
    """Axes a `MeshSpec(...)` declares: its dict literal's keys and
    `dcn_axes=`; for a name, the keys of the dict literals bound to it in
    the same function and the keys stored into it (`axes["sp"] = sp`)."""
    scope = ctx.enclosing_function(call) or ctx.tree

    def keys(node: Optional[ast.AST]) -> List[str]:
        if isinstance(node, ast.Dict):
            out = _dict_keys(node)
            for k, v in zip(node.keys, node.values):
                if k is None:                  # {**axes, "pp": n}
                    out.extend(keys(v))
            return out
        if isinstance(node, ast.IfExp):
            return keys(node.body) + keys(node.orelse)
        if isinstance(node, ast.Name):
            out = []
            for sub in ast.walk(scope):
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if isinstance(t, ast.Name) and t.id == node.id \
                                and isinstance(sub.value, ast.Dict):
                            out.extend(_dict_keys(sub.value))
                        elif isinstance(t, ast.Subscript) and \
                                dotted(t.value) == node.id and \
                                isinstance(t.slice, ast.Constant) and \
                                isinstance(t.slice.value, str):
                            out.append(t.slice.value)
            return out
        return []

    axes = keys(call.args[0] if call.args else _kwarg(call, "axes"))
    dcn = _kwarg(call, "dcn_axes")
    if dcn is not None:
        axes.extend(_axes_from_node(dcn))
    return axes


def _rule_pairs(node: ast.AST) -> Optional[List[Tuple[str, List[str], int]]]:
    """(logical, mesh axes, line) of a logical-axis rule table — a
    tuple/list of ("logical", "axis" | ("axis", ...) | None) pairs bound
    to a `*rules*` name, or a {"logical": target} dict passed as `rules=`
    — else None."""
    pairs: List[Tuple[str, List[str], int]] = []
    if isinstance(node, ast.Dict):
        for k, v in zip(node.keys, node.values):
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                return None
            if not (isinstance(v, ast.Constant) and v.value is None) and \
                    not _axes_from_node(v):
                return None
            pairs.append((k.value, _axes_from_node(v), k.lineno))
        return pairs or None
    if not isinstance(node, (ast.Tuple, ast.List)) or not node.elts:
        return None
    for e in node.elts:
        if not (isinstance(e, (ast.Tuple, ast.List)) and len(e.elts) == 2):
            return None
        k, v = e.elts
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return None
        if not (isinstance(v, ast.Constant) and v.value is None) and \
                not _axes_from_node(v):
            return None
        pairs.append((k.value, _axes_from_node(v), e.lineno))
    return pairs


def _spec_aliases(ctx: FileContext) -> set:
    """Local names bound to PartitionSpec (`as P` being the idiom)."""
    names = {"PartitionSpec"}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name == "PartitionSpec" and alias.asname:
                    names.add(alias.asname)
        elif isinstance(node, ast.Assign) and \
                last_segment(dotted(node.value)) == "PartitionSpec":
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    names.add(tgt.id)
    return names


def _rule_table_specs(ctx: FileContext, spec_names: set) -> Dict[int, str]:
    """Map id(PartitionSpec call) -> regex pattern for every spec that
    sits in a `match_partition_rules` table: a tuple/list whose entries
    are ("pattern", PartitionSpec(...)) pairs. RL023 cites the owning
    rule pattern in its findings."""
    owners: Dict[int, str] = {}
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.Tuple, ast.List)):
            continue
        for entry in node.elts:
            if not (isinstance(entry, ast.Tuple) and len(entry.elts) == 2):
                continue
            pattern, spec = entry.elts
            if isinstance(pattern, ast.Constant) \
                    and isinstance(pattern.value, str) \
                    and isinstance(spec, ast.Call) \
                    and last_segment(dotted(spec.func)) in spec_names:
                owners[id(spec)] = pattern.value
    return owners


def _sharding_extract(ctx: FileContext, out: dict) -> None:
    spec_names = _spec_aliases(ctx)
    rule_owners = _rule_table_specs(ctx, spec_names)
    for node in ast.walk(ctx.tree):
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if isinstance(node, ast.AnnAssign)
            and node.value is not None else [])
        if any("rules" in (dotted(t) or "").lower() for t in targets) \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            pairs = _rule_pairs(node.value)
            if pairs:
                out["axis_rules"].extend(
                    {"logical": k, "axes": v, "line": ln}
                    for k, v, ln in pairs)
        if not isinstance(node, ast.Call):
            continue
        seg = last_segment(dotted(node.func))
        if seg == "MeshSpec":
            axes = _meshspec_axes(ctx, node)
            if axes:
                out["mesh_axes"].append({"axes": axes, "line": node.lineno})
        elif seg == "ShardSpec":
            # Multi-axis gang spec: a literal 1 is dropped (size-1 axes
            # never reach the mesh); a non-literal size MAY be > 1.
            axes = [kw.arg for kw in node.keywords
                    if kw.arg in _SHARDSPEC_AXIS_KWARGS and not (
                        isinstance(kw.value, ast.Constant)
                        and kw.value.value == 1)]
            if axes:
                out["mesh_axes"].append({"axes": axes, "line": node.lineno})
        elif seg in ("init_device_mesh", "DeviceMesh"):
            names = _kwarg(node, "mesh_dim_names")
            axes = _axes_from_node(names) if names is not None else []
            if axes:
                out["mesh_axes"].append({"axes": axes, "line": node.lineno})
        elif seg in spec_names and isinstance(node.func, (ast.Name,
                                                          ast.Attribute)):
            dims: List[object] = []
            for a in node.args:
                if isinstance(a, ast.Constant) and a.value is None:
                    dims.append(None)
                elif isinstance(a, ast.Constant) and \
                        isinstance(a.value, str):
                    dims.append(a.value)
                elif isinstance(a, (ast.Tuple, ast.List)):
                    sub = _axes_from_node(a)
                    dims.append(sub if len(sub) == len(a.elts) else "?")
                else:
                    dims.append("?")
            if not node.args:
                continue                   # PartitionSpec(): replicated
            spec = {"dims": dims, "line": node.lineno}
            rule = rule_owners.get(id(node))
            if rule is not None:
                spec["rule"] = rule
            out["specs"].append(spec)
        if seg in _RULES_KWARG_CALLS:
            rules = _kwarg(node, "rules") or _kwarg(node, "overrides")
            if rules is None and seg == "logical_axis_rules" and node.args:
                rules = node.args[0]
            pairs = _rule_pairs(rules) if rules is not None else None
            if pairs:
                out["axis_rules"].extend(
                    {"logical": k, "axes": v, "line": ln}
                    for k, v, ln in pairs)
        if seg in _LOGICAL_CALLS:
            names = [a.value for a in node.args[_LOGICAL_CALLS[seg]:]
                     if isinstance(a, ast.Constant)
                     and isinstance(a.value, str)]
            if names:
                out["logical_uses"].append(
                    {"names": names, "line": node.lineno, "call": seg})
        elif seg in _LOGICAL_DICT_CALLS and len(node.args) > 2 and \
                isinstance(node.args[2], ast.Dict):
            names = []
            for v in node.args[2].values:
                names.extend(_axes_from_node(v))
            if names:
                out["logical_uses"].append(
                    {"names": names, "line": node.lineno, "call": seg})


def module_name(path: str) -> str:
    """Dotted module name from the file's place under its packages."""
    path = os.path.abspath(path)
    d, base = os.path.split(path)
    parts = [] if base == "__init__.py" else [base[:-3]]
    while os.path.isfile(os.path.join(d, "__init__.py")):
        d, pkg = os.path.split(d)
        parts.insert(0, pkg)
    return ".".join(parts)


def _import_time_stmts(body: Sequence[ast.stmt]) -> Iterable[ast.stmt]:
    """Statements that run when the module is imported: module level,
    inside module-level if/try/with, and class bodies — not function
    bodies, and not `if TYPE_CHECKING:` blocks."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, _FUNC_NODES):
            continue
        if isinstance(stmt, ast.If) and "TYPE_CHECKING" in ast.unparse(
                stmt.test):
            yield from _import_time_stmts(stmt.orelse)
            continue
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if sub:
                yield from _import_time_stmts(sub)
        for handler in getattr(stmt, "handlers", ()) or ():
            yield from _import_time_stmts(handler.body)


def _imports(mod: str, is_pkg: bool, stmt: ast.stmt) -> List[str]:
    if isinstance(stmt, ast.Import):
        return [a.name for a in stmt.names]
    if isinstance(stmt, ast.ImportFrom):
        base = stmt.module or ""
        if stmt.level:
            parts = mod.split(".")
            keep = len(parts) - stmt.level + (1 if is_pkg else 0)
            pkg = ".".join(parts[:max(keep, 0)])
            base = f"{pkg}.{base}" if base and pkg else (base or pkg)
        return [base] + [f"{base}.{a.name}" for a in stmt.names
                         if a.name != "*"]
    return []


def _fork_extract(ctx: FileContext, out: dict) -> None:
    mod = module_name(ctx.path)
    is_pkg = os.path.basename(ctx.path) == "__init__.py"
    out["module"] = mod
    for stmt in _import_time_stmts(ctx.tree.body):
        for name in _imports(mod, is_pkg, stmt):
            if name and name not in out["imports"]:
                out["imports"].append(name)
        if isinstance(stmt, (ast.Import, ast.ImportFrom) + _FUNC_NODES +
                      (ast.ClassDef,)):
            continue
        for call in calls_in_stmt(stmt):
            what = cuda_init(call)
            if what:
                out["cuda_at_import"].append(
                    {"line": call.lineno, "what": what})
    if _PREIMPORT_KNOB in ctx.source:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and \
                    last_segment(dotted(node.func)) == "_flag" and \
                    len(node.args) >= 3 and \
                    isinstance(node.args[0], ast.Constant) and \
                    node.args[0].value == _PREIMPORT_KNOB and \
                    isinstance(node.args[2], ast.Constant) and \
                    isinstance(node.args[2].value, str):
                out["preimports"].extend(
                    m.strip() for m in node.args[2].value.split(",")
                    if m.strip())
    # Init-before-fork on a CFG path of one function (or the module body).
    scopes = [ctx.tree] + [n for n in ast.walk(ctx.tree)
                           if isinstance(n, _FUNC_NODES)]
    for fn in scopes:
        if not any(isinstance(c, ast.Call) and _callee(c) in _FORK_NAMES
                   for c in ast.walk(fn)):
            continue
        contexts = fork_contexts(fn)
        cfg = build_cfg(fn)
        for stmt in cfg.stmts:
            inits = [w for w in (cuda_init(c) for c in calls_in_stmt(stmt))
                     if w]
            if not inits:
                continue
            for later in reachable(cfg, stmt):
                hows = [h for h in (forks(c, contexts)
                                    for c in calls_in_stmt(later)) if h]
                if hows:
                    out["fork_after_init"].append({
                        "line": later.lineno, "init_line": stmt.lineno,
                        "init": inits[0], "fork": hows[0],
                        "function": getattr(fn, "name", "<module>")})
                    break


_FORK_NAMES = {"fork", "forkpty", "Process", "Pool", "ProcessPoolExecutor"}


def _callee(call: ast.Call) -> str:
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    return func.id if isinstance(func, ast.Name) else ""


def empty_extract() -> dict:
    return {"mesh_axes": [], "axis_rules": [], "logical_uses": [],
            "specs": [], "module": "", "imports": [], "cuda_at_import": [],
            "preimports": [], "fork_after_init": []}


def torch_extract(ctx: FileContext) -> dict:
    """JSON-serializable sharding and fork-safety extract for the project
    graph."""
    out = empty_extract()
    if re.search(r"MeshSpec|ShardSpec|PartitionSpec|DeviceMesh|"
                 r"init_device_mesh|rules|RULES|shard|logical", ctx.source):
        _sharding_extract(ctx, out)
    _fork_extract(ctx, out)
    return out
