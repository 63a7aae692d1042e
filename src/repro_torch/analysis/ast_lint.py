"""Tick-scope linter: AST rules over the code a tick runs.

The port of ``repro.analysis.ast_lint``.  A serving tick on the card is
a sequence of asynchronous launches: one ``.item()``, ``int()`` or
``torch.nonzero`` on a device value stalls the host on the device every
tick, and one tensor built from host data (``torch.tensor(...)``) copies
host memory to the card every tick.  Either also makes the tick
impossible to capture as a CUDA graph, which is the lever for the
host-bound serving tick.  This pass finds those hazards statically.

How tick scope is computed
--------------------------
1. **Roots.** A function is a tick root if it is (a) a closure that a
   ``build_*`` / ``make_*`` builder returns (the repo-wide idiom for
   "returns a tick"), (b) a public op of a kernel package
   (``kernels/<k>/ops.py``) or a launch wrapper ``*_cuda`` in
   ``kernels/<k>/kernel.py``, (c) handed to ``torch.compile``,
   ``torch.cuda.make_graphed_callables`` or ``torch.vmap`` (or
   decorated with them), or called inside a ``with torch.cuda.graph``
   block, or (d) the ``forward`` of a ``torch.autograd.Function``.
2. **Reachability.** Roots are closed over a project-wide call graph
   (names resolved through ``from repro_torch.x import f`` / ``import
   repro_torch.x as y`` aliases, relative imports included).  A project
   function that tick code passes as a value (``map_state(to_shards,
   state)``) is reachable too, with its parameters seeded: the callee
   hands it tick values.  Unlike the reference lint, a function nested
   in a builder that the builder neither returns nor hands to tick code
   is build-time code (``build_tick``'s label upload runs once per
   build), not tick scope: this pass flags host-built tensors, which a
   builder rightly makes.
3. **Taint.** Inside a *root*, positional parameters are tick values
   (tensors on the device) unless their name marks them static
   (keyword-only parameters and ``STATIC_PARAMS`` names like ``plan`` /
   ``rel`` / ``backend`` / ``device`` are never tick values).  For
   *reachable* functions, parameter taint flows in from call sites, and
   a project function's result is a tick value only where one of its
   ``return`` expressions is (per position for tuple returns), so the
   host integers a launch wrapper computes from metadata stay host
   values.  Taint dies at torch's host metadata (``.shape``, ``.dtype``,
   ``.device``, ``.ndim``, ``.is_cuda``, ``.dim()``, ``.size()``,
   ``.numel()``, ``.stride()``, ``.is_contiguous()``, ``.data_ptr()``,
   ``.element_size()``, ``torch.is_tensor``, ``len()``) and at the
   structural NamedTuple field ``STATIC_ATTRS`` (``shared``); it
   propagates through assignments, tuple unpacking, arithmetic, list
   appends and comprehensions; ``zip()`` and ``enumerate()`` unpacking
   are tracked per position.  A tensor factory (``torch.zeros``,
   ``torch.full``, ...) called in tick scope gives a tick value.

Rules
-----
TRC101 error    Python ``int()``/``float()``/``bool()`` on a tick value (a
                blocking device-to-host copy).
TRC102 error    Host compute on tick values: an ``np.*`` call on a tick
                value; and a tensor built from host data in tick scope
                (``torch.tensor`` / ``torch.as_tensor`` /
                ``torch.from_numpy`` of a non-tick value): a host-to-
                device copy per tick.  ``torch.full`` / ``zeros`` /
                ``arange`` fill on the device and are fine.
TRC103 error    Host sync: ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                ``.numpy()`` / ``.to("cpu")`` of a tick value,
                ``torch.cuda.synchronize()``, and ``torch.nonzero`` /
                ``.nonzero()`` / ``torch.argwhere`` / one-argument
                ``torch.where`` of a tick value (a result of data-
                dependent size; ``core.join.first_true`` is the static-
                size form), and the ``torch.distributed`` collectives of
                host objects (``all_gather_object``, ``barrier``, ...).
                The tensor collectives (``all_gather_into_tensor``,
                ``all_reduce``) are device operations, as the
                reference's ``lax.all_gather`` / ``lax.psum`` are.
TRC104 error    Python control flow (``if`` / ``while`` / ternary /
                ``assert``) on a tick value (``x is None`` checks are
                exempt — identity, not value).
TRC105 warning  A builder's inner tick closes over a non-structural
                builder parameter: the value is frozen into the closure
                and into any graph captured from it.
TRC106 warning  A tick copies a whole state leaf — ``torch.cat`` with a
                whole incoming tensor as an element, or ``.clone()`` of
                one — instead of updating it in place (the counterpart
                of the reference's jit without ``donate_argnums``: the
                table is copied every tick).
TRC107 error    ``repro_torch.obs`` span/metric emission (``.span`` /
                ``.record`` / ``.event`` / ``.observe`` / ``.inc`` /
                ``.next_tick``) in tick scope: instrumentation stays on
                the host side of the serve loop, outside anything a
                graph captures.  Only modules that import
                ``repro_torch.obs`` are checked (the attribute names
                alone are too generic); the ``n_obs_sites`` census
                counts every emission site tree-wide either way.

Suppression: ``# analysis: ignore[TRC103]`` (or bare ``ignore``) on the
flagged line; severities and the baseline workflow are described in
``repro_torch.analysis.findings``.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import KW_ONLY, dataclass, field

from repro_torch.analysis.findings import ERROR, WARNING, Finding

# Parameter names that are structural / static by convention everywhere
# in this repo: never treated as tick values, allowed as builder
# closures.  Keep sorted; additions need a matching idiom in src.
STATIC_PARAMS = frozenset({
    "self", "cls", "ctx",
    # plan / spec structure
    "plan", "plans", "template_plan", "spec", "specs", "q", "query",
    # backend / mode switches
    "backend", "interpret", "jit", "donate", "extract_matches",
    # static shapes & capacities
    "capacity", "max_new", "max_out", "n_slots", "n_shards", "n_nodes",
    "n_bags", "size", "prefix_depth",
    # kernel specialization constants
    "rel", "trel", "has_window", "tile_a", "tile_b", "tile_n", "tile_e",
    "batched", "acc_dtype", "axis_name", "axis_size", "in_batched",
    # the capacity shards' collectives (engine.ShardAxis / GroupAxis) and
    # the torch.distributed process group they run over: what the
    # reference's ``axis_name`` names
    "shards", "group",
    # model / training configs (hashable static pytrees)
    "cfg", "ocfg", "config", "mesh", "microbatches",
    # the models' sharding (a MeshAxes over a process-group mesh): what
    # the reference's ``axes`` names, fixed for a built step
    "axes",
    # where a tick runs: one device (or mesh of devices) per built tick
    "device", "devices", "dtype", "shared",
})
# Attributes that are structural by convention (``_View.shared``: one
# table for every slot, decided when the tick is built; a model's
# ``axes``: its sharding, fixed when the cell is built).
STATIC_ATTRS = frozenset({"shared", "axes"})

_BUILDER_RE = re.compile(r"^(build|make)_")
_IGNORE_RE = re.compile(r"#\s*analysis:\s*ignore(?:\[([A-Za-z0-9_,\s]+)\])?")
# torch's host metadata of a tensor: reading it never touches the device
_KILL_ATTRS = frozenset({"shape", "dtype", "ndim", "size", "nbytes",
                         "device", "is_cuda", "dim", "numel", "stride",
                         "is_contiguous", "data_ptr", "element_size",
                         "get_device", "is_floating_point"}) | STATIC_ATTRS
_KILL_CALLS = frozenset({"len", "range", "isinstance", "type", "repr",
                         "str", "enumerate", "id", "callable", "hasattr"})
_KILL_DOTTED = frozenset({"torch.is_tensor", "torch.device"})
_CAST_CALLS = frozenset({"int", "float", "bool"})
_SYNC_ATTRS = frozenset({"tolist", "item", "cpu", "numpy"})
_NONZERO = frozenset({"torch.nonzero", "torch.argwhere"})
# torch.distributed collectives of host objects: they pickle on the host,
# or wait there
_HOST_COLLECTIVES = frozenset(f"torch.distributed.{n}" for n in (
    "all_gather_object", "broadcast_object_list", "gather_object",
    "scatter_object_list", "barrier", "monitored_barrier"))
_HOST_BUILDERS = frozenset({"torch.tensor", "torch.as_tensor",
                            "torch.from_numpy"})
_FACTORIES = frozenset(f"torch.{n}" for n in (
    "empty", "zeros", "ones", "full", "arange", "empty_like", "zeros_like",
    "ones_like", "full_like", "rand", "randn", "randint", "linspace",
    "eye", "empty_strided")) | _HOST_BUILDERS
# callables that take a function and run it as a (captured) tick
_GRAPH_WRAPPERS = frozenset({"torch.compile", "torch.cuda.make_graphed_callables",
                             "torch.vmap", "torch.func.vmap"})
_GRAPH_CONTEXTS = frozenset({"torch.cuda.graph"})
_AUTOGRAD_FUNCTION = frozenset({"torch.autograd.Function"})
# repro_torch.obs emission attributes (TRC107 + the n_obs_sites census).
# ``.set`` is deliberately excluded: too generic an attribute name to
# attribute to the obs layer from syntax alone.
_OBS_EMIT_ATTRS = frozenset({"span", "record", "event", "next_tick",
                             "observe", "inc", "set_total"})
_OBS_MODULE = "repro_torch.obs"


@dataclass
class FuncInfo:
    """One analyzed function definition."""

    module: str                 # dotted module ("repro_torch.core.engine")
    path: str                   # repo-relative file path
    qualname: str               # dotted within module ("build_tick.<tick>")
    node: ast.AST               # FunctionDef / AsyncFunctionDef
    parent: "FuncInfo | None"
    in_class: bool
    pos_params: tuple[str, ...]      # positional (incl. pos-or-kw + vararg)
    kwonly_params: tuple[str, ...]
    traced_root: bool = False
    seeded: bool = False        # positional params seeded as tick values
    _: KW_ONLY
    root_kind: str = ""         # "tick" | "kernel" | "graph" | "autograd"
    traced: bool = False        # in tick scope
    tainted_params: set[str] = field(default_factory=set)
    # parameters some call site gives host data (a constant, a Python
    # int): a tensor built from one copies host memory to the card
    host_params: set[str] = field(default_factory=set)
    # does a return expression carry a tick value?  a tuple of flags
    # where every return is a tuple literal of one length; None until
    # the function is reached
    returns: bool | tuple | None = None


@dataclass
class ModuleInfo:
    module: str
    path: str
    tree: ast.Module
    lines: list[str]
    # alias -> ("module", dotted) | ("from", (module, name))
    imports: dict[str, tuple] = field(default_factory=dict)
    functions: dict[str, FuncInfo] = field(default_factory=dict)  # qualname
    top_level: dict[str, FuncInfo] = field(default_factory=dict)  # name
    _: KW_ONLY
    classes: dict[str, ast.ClassDef] = field(default_factory=dict)


# --------------------------------------------------------------------- #
# Collection
# --------------------------------------------------------------------- #
def _module_name(parent: str, path: str) -> str:
    """Dotted module for ``path`` relative to the dir containing the
    package root (src/repro_torch/core/engine.py ->
    repro_torch.core.engine)."""
    rel = os.path.relpath(path, parent).replace(os.sep, "/")
    parts = rel[:-3].split("/")            # strip .py
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _collect_imports(tree: ast.Module, package: str) -> dict[str, tuple]:
    """Aliases of every import in ``tree``; ``package`` is the dotted
    package that relative imports start from."""
    out: dict[str, tuple] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    "module", a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                base = package.split(".")
                base = base[:len(base) - (node.level - 1)]
                mod = ".".join(base + ([mod] if mod else []))
            if not mod:
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = ("from", (mod, a.name))
    return out


def _params(node) -> tuple[tuple[str, ...], tuple[str, ...]]:
    a = node.args
    pos = [p.arg for p in a.posonlyargs + a.args]
    if a.vararg:
        pos.append(a.vararg.arg)
    kw = [p.arg for p in a.kwonlyargs]
    return tuple(pos), tuple(kw)


def _collect_functions(mi: ModuleInfo) -> None:
    def visit(node, parent: FuncInfo | None, in_class: bool, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                if qual in mi.functions:     # a def in another branch
                    qual = f"{qual}@{child.lineno}"
                pos, kw = _params(child)
                fi = FuncInfo(module=mi.module, path=mi.path, qualname=qual,
                              node=child, parent=parent, in_class=in_class,
                              pos_params=pos, kwonly_params=kw)
                mi.functions[qual] = fi
                if parent is None and not in_class:
                    mi.top_level[child.name] = fi
                visit(child, fi, False, qual + ".")
            elif isinstance(child, ast.ClassDef):
                mi.classes[prefix + child.name] = child
                visit(child, parent, True, prefix + child.name + ".")
            else:
                visit(child, parent, in_class, prefix)

    visit(mi.tree, None, False, "")


def _dotted(mi: ModuleInfo, node) -> str | None:
    """The dotted name an attribute chain stands for, its root alias
    resolved through the module's imports (``torch.cuda.graph``,
    ``numpy.sum``); None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    ent = mi.imports.get(node.id)
    if ent is None:
        head = node.id
    elif ent[0] == "module":
        head = ent[1]
    else:
        head = f"{ent[1][0]}.{ent[1][1]}"
    return ".".join([head] + parts[::-1])


def _local_assign_value(fn_node, name: str) -> ast.expr | None:
    """Last simple ``name = <expr>`` assignment inside ``fn_node``."""
    found = None
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    found = node.value
    return found


def _own_returned_names(fn_node) -> set[str]:
    """Names that ``return`` expressions of ``fn_node`` itself hand back
    as values (``return tick``, ``return tick, state``; not the callee
    of a call, as in ``return EdgeBatch(a(src), ...)``)."""
    out: set[str] = set()
    for value in _own_returns(fn_node):
        called = {id(n.func) for n in ast.walk(value)
                  if isinstance(n, ast.Call)}
        out |= {n.id for n in ast.walk(value)
                if isinstance(n, ast.Name) and id(n) not in called}
    return out


def _own_nodes(fn_node):
    """Every node of ``fn_node``'s own body: nested ``def``s are left
    out (each is analyzed on its own), lambdas are kept."""
    stack = [fn_node]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(c for c in ast.iter_child_nodes(node)
                     if not isinstance(c, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)))


def _own_returns(fn_node) -> list[ast.expr]:
    """The ``return`` expressions of ``fn_node`` itself."""
    out = []
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Return) and node.value is not None:
            out.append(node.value)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _is_kernel_root(mi: ModuleInfo, fi: FuncInfo) -> bool:
    """A kernel package's public op or launch wrapper."""
    parts = mi.module.split(".")
    if len(parts) < 3 or parts[-3] != "kernels" or fi.parent is not None \
            or fi.in_class:
        return False
    name = fi.node.name
    if parts[-1] == "ops":
        return not name.startswith("_")
    return parts[-1] == "kernel" and name.endswith("_cuda")


def _mark(fi: FuncInfo, kind: str) -> None:
    fi.traced_root = fi.seeded = True
    fi.root_kind = fi.root_kind or kind


def _resolve_local(mi: ModuleInfo, scope: FuncInfo | None,
                   name: str) -> FuncInfo | None:
    """A function named ``name`` visible from ``scope``: a nested
    sibling, then a module top-level function."""
    while scope is not None:
        cand = mi.functions.get(f"{scope.qualname}.{name}")
        if cand is not None:
            return cand
        scope = scope.parent
    return mi.top_level.get(name)


def _enclosing(mi: ModuleInfo, target) -> FuncInfo | None:
    best = None
    for fi in mi.functions.values():
        for sub in ast.walk(fi.node):
            if sub is target:
                if best is None or _span(fi.node) < _span(best.node):
                    best = fi
                break
    return best


def _span(fn_node) -> int:
    return (fn_node.end_lineno or fn_node.lineno) - fn_node.lineno


def _mark_roots(mi: ModuleInfo) -> None:
    for fi in mi.functions.values():
        for dec in fi.node.decorator_list:
            d = _dotted(mi, dec.func if isinstance(dec, ast.Call) else dec)
            if d in _GRAPH_WRAPPERS:
                _mark(fi, "graph")
        # a closure a build_* / make_* builder returns is a tick
        if (fi.parent is not None
                and _BUILDER_RE.match(fi.parent.qualname.split(".")[-1])
                and fi.node.name in _own_returned_names(fi.parent.node)):
            _mark(fi, "tick")
        if _is_kernel_root(mi, fi):
            _mark(fi, "kernel")

    # forward of a torch.autograd.Function
    for cname, cls in mi.classes.items():
        if any(_dotted(mi, b) in _AUTOGRAD_FUNCTION for b in cls.bases):
            fi = mi.functions.get(f"{cname}.forward")
            if fi is not None:
                _mark(fi, "autograd")

    for node in ast.walk(mi.tree):
        # functions handed to torch.compile / make_graphed_callables /
        # torch.vmap
        if isinstance(node, ast.Call) and _dotted(
                mi, node.func) in _GRAPH_WRAPPERS and node.args:
            scope = _enclosing(mi, node)
            for arg in ast.walk(node.args[0]):
                if isinstance(arg, ast.Name):
                    fi = _resolve_local(mi, scope, arg.id)
                    if fi is None and scope is not None:
                        val = _local_assign_value(scope.node, arg.id)
                        if isinstance(val, ast.Name):
                            fi = _resolve_local(mi, scope, val.id)
                    if fi is not None:
                        _mark(fi, "graph")
        # what a ``with torch.cuda.graph(...)`` block calls is captured
        if isinstance(node, ast.With) and any(
                isinstance(it.context_expr, ast.Call)
                and _dotted(mi, it.context_expr.func) in _GRAPH_CONTEXTS
                for it in node.items):
            scope = _enclosing(mi, node)
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and isinstance(
                            sub.func, ast.Name):
                        fi = _resolve_local(mi, scope, sub.func.id)
                        if fi is not None:
                            _mark(fi, "graph")


# --------------------------------------------------------------------- #
# Taint
# --------------------------------------------------------------------- #
class _Taint:
    """Intra-procedural taint over local names of one function; call
    results of project functions follow their ``returns`` taint."""

    def __init__(self, linter: "Linter", mi: ModuleInfo, fi: FuncInfo):
        self.linter = linter
        self.mi = mi
        self.fi = fi
        self.names: set[str] = set(fi.tainted_params)
        # tick values that may also hold host data (mixed call sites)
        self.host: set[str] = set(fi.host_params)
        if fi.parent is not None:      # a closure sees its parent's names
            outer = linter.outer_taint(mi, fi.parent)
            own = set(fi.pos_params) | set(fi.kwonly_params)
            self.names |= outer.names - own
            self.host |= outer.host - own

    def call(self, node: ast.Call):
        """Taint of a call's result: bool, or a tuple per position."""
        f = node.func
        if isinstance(f, ast.Name) and f.id in _KILL_CALLS:
            return False
        if isinstance(f, ast.Attribute) and f.attr in _KILL_ATTRS:
            return False
        d = _dotted(self.mi, f)
        if d in _KILL_DOTTED:
            return False
        if d in _FACTORIES:
            return True                  # a device tensor made in the tick
        callee = self.linter._resolve_call(self.mi, self.fi, node)
        if callee is not None:           # None: not reached yet
            return False if callee.returns is None else callee.returns
        args = list(node.args) + [k.value for k in node.keywords]
        return any(self.expr(a) for a in args) or self.expr(f)

    def expr(self, node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in _KILL_ATTRS:
                return False
            return self.expr(node.value)
        if isinstance(node, ast.Subscript):
            v = node.value
            if isinstance(v, ast.Call) and isinstance(node.slice,
                                                      ast.Constant):
                r = self.call(v)
                if isinstance(r, tuple) and isinstance(node.slice.value, int) \
                        and -len(r) <= node.slice.value < len(r):
                    return r[node.slice.value]
            return self.expr(v)
        if isinstance(node, ast.Call):
            r = self.call(node)
            return any(r) if isinstance(r, tuple) else bool(r)
        if isinstance(node, ast.BinOp):
            return self.expr(node.left) or self.expr(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.expr(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.expr(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False             # identity, not value
            return self.expr(node.left) or any(
                self.expr(c) for c in node.comparators)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.expr(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.expr(node.body) or self.expr(node.orelse)
        if isinstance(node, ast.Starred):
            return self.expr(node.value)
        if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
            return self.expr(node.elt) or self._filters(node)
        if isinstance(node, ast.DictComp):
            return (self.expr(node.key) or self.expr(node.value)
                    or self._filters(node))
        if isinstance(node, ast.NamedExpr):
            return self.expr(node.value)
        return False

    def is_host(self, node) -> bool:
        """May ``node`` be host data (anything but a tick value, or a
        value some path gives host data)?  ``None`` is no data."""
        if isinstance(node, ast.Constant) and node.value is None:
            return False
        return not self.expr(node) or any(
            isinstance(n, ast.Name) and n.id in self.host
            for n in ast.walk(node))

    def _filters(self, node) -> bool:
        return any(self.expr(c) for g in node.generators for c in g.ifs)

    def positions(self, value, n: int, each: bool = False):
        """Per-position taint of ``value`` unpacked into ``n`` targets
        (``each``: of every item ``value`` iterates over), or None where
        it is not known per position."""
        if isinstance(value, ast.Call):
            f = value.func
            if each and isinstance(f, ast.Name) and f.id == "zip" \
                    and len(value.args) == n:
                return [self.expr(a) for a in value.args]
            if each and isinstance(f, ast.Name) and f.id == "enumerate" \
                    and n == 2 and value.args:
                return [False, self.expr(value.args[0])]
            r = self.call(value)
            if not each and isinstance(r, tuple) and len(r) == n:
                return list(r)
            return None
        if not isinstance(value, (ast.Tuple, ast.List)) or any(
                isinstance(e, ast.Starred) for e in value.elts):
            return None
        if not each:
            return [self.expr(e) for e in value.elts] \
                if len(value.elts) == n else None
        rows = [self.positions(e, n) for e in value.elts]
        if not rows or any(r is None for r in rows):
            return None
        return [any(r[i] for r in rows) for i in range(n)]

    def _bind_target(self, target, value_tainted: bool,
                     value: ast.expr | None = None,
                     each: bool = False) -> None:
        if isinstance(target, ast.Name):
            if value_tainted:
                self.names.add(target.id)
            return
        if isinstance(target, ast.Starred):
            self._bind_target(target.value, value_tainted)
            return
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            base = target
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if value_tainted and isinstance(base, ast.Name):
                self.names.add(base.id)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            pos = None if value is None else self.positions(
                value, len(target.elts), each)
            if pos is not None:
                for t, p in zip(target.elts, pos):
                    self._bind_target(t, p)
                return
            for t in target.elts:
                self._bind_target(t, value_tainted)

    def run(self) -> None:
        """Passes over the body to a fixpoint (loop-carried taint)."""
        for _ in range(4):
            before = len(self.names)
            for node in self.linter.nodes(self.fi):
                if isinstance(node, ast.Assign):
                    t = self.expr(node.value)
                    for tgt in node.targets:
                        self._bind_target(tgt, t, node.value)
                        if t and self.is_host(node.value):
                            self.host |= {n.id for n in ast.walk(tgt)
                                          if isinstance(n, ast.Name)}
                elif isinstance(node, ast.AugAssign):
                    if self.expr(node.value) or self.expr(node.target):
                        self._bind_target(node.target, True)
                elif isinstance(node, ast.AnnAssign) and node.value:
                    self._bind_target(node.target, self.expr(node.value),
                                      node.value)
                elif isinstance(node, (ast.For, ast.comprehension)):
                    it = node.iter
                    self._bind_target(node.target, self.expr(it), it,
                                      each=True)
                elif isinstance(node, ast.NamedExpr):
                    self._bind_target(node.target, self.expr(node.value))
                elif isinstance(node, ast.withitem) and node.optional_vars:
                    self._bind_target(node.optional_vars,
                                      self.expr(node.context_expr))
                elif isinstance(node, ast.Call) and any(
                        isinstance(a, ast.Lambda) for a in node.args):
                    # a lambda handed to a call with tick values (a
                    # leaf-wise map over a state) is run on them
                    if any(self.expr(a) for a in node.args
                           if not isinstance(a, ast.Lambda)):
                        for lam in node.args:
                            if isinstance(lam, ast.Lambda):
                                self._bind_lambda(lam.args)
                elif (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("append", "extend", "insert")
                        and isinstance(node.func.value, ast.Name)
                        and any(self.expr(a) for a in node.args)):
                    self.names.add(node.func.value.id)
            if len(self.names) == before:
                break

    def _bind_lambda(self, args: ast.arguments) -> None:
        params = args.posonlyargs + args.args
        defaults = [None] * (len(params) - len(args.defaults)) \
            + list(args.defaults)
        for p, d in zip(params, defaults):
            if d is None or self.expr(d):
                self.names.add(p.arg)

    def returns(self) -> bool | tuple:
        rets = self.linter.rets(self.fi)
        if rets and all(isinstance(r, ast.Tuple) for r in rets) \
                and len({len(r.elts) for r in rets}) == 1 \
                and not any(isinstance(e, ast.Starred)
                            for r in rets for e in r.elts):
            return tuple(any(self.expr(r.elts[i]) for r in rets)
                         for i in range(len(rets[0].elts)))
        return any(self.expr(r) for r in rets)


def _seed_root_taint(fi: FuncInfo) -> set[str]:
    return {p for p in fi.pos_params if p not in STATIC_PARAMS}


def _merge(a, b):
    """Join of two ``returns`` taints (None: nothing known yet)."""
    if a is None or b is None:
        return b if a is None else a
    if isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b):
        return tuple(x or y for x, y in zip(a, b))
    if isinstance(a, tuple):
        a = any(a)
    if isinstance(b, tuple):
        b = any(b)
    return a or b


# --------------------------------------------------------------------- #
# Linter driver
# --------------------------------------------------------------------- #
class Linter:
    def __init__(self, root: str):
        self.root = root
        self.repo_root = os.path.dirname(os.path.dirname(
            os.path.abspath(root)))
        self.modules: dict[str, ModuleInfo] = {}
        self.findings: list[Finding] = []
        self.stats: dict = {}
        self._nodes: dict[int, tuple] = {}       # id(fi) -> own nodes
        self._rets: dict[int, list] = {}         # id(fi) -> own returns
        self._outer: dict[int, _Taint] = {}      # id(fi) -> taint, per pass

    def nodes(self, fi: FuncInfo) -> tuple:
        """``_own_nodes`` of ``fi``, computed once."""
        out = self._nodes.get(id(fi))
        if out is None:
            out = self._nodes[id(fi)] = tuple(_own_nodes(fi.node))
        return out

    def rets(self, fi: FuncInfo) -> list:
        out = self._rets.get(id(fi))
        if out is None:
            out = self._rets[id(fi)] = _own_returns(fi.node)
        return out

    def outer_taint(self, mi: ModuleInfo, fi: FuncInfo) -> "_Taint":
        """``fi``'s taint as its closures see it (cached within one
        pass over the tree; each pass starts afresh)."""
        t = self._outer.get(id(fi))
        if t is None:
            t = self._outer[id(fi)] = _Taint(self, mi, fi)
            t.run()
        return t

    # ---------------- collection ---------------- #
    def load(self) -> None:
        for dirpath, _dirnames, filenames in sorted(os.walk(self.root)):
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                with open(path) as fh:
                    src = fh.read()
                mod = _module_name(os.path.dirname(os.path.abspath(
                    self.root)), path)
                package = mod if fn == "__init__.py" else \
                    mod.rpartition(".")[0]
                rel = os.path.relpath(path, self.repo_root)
                mi = ModuleInfo(module=mod, path=rel,
                                tree=ast.parse(src, filename=path),
                                lines=src.splitlines())
                mi.imports = _collect_imports(mi.tree, package)
                _collect_functions(mi)
                self.modules[mod] = mi

    def _from_module(self, mod: str, name: str) -> FuncInfo | None:
        smi = self.modules.get(mod)
        if smi is None:
            return None
        if name in smi.top_level:
            return smi.top_level[name]
        ent = smi.imports.get(name)          # re-exported by a package
        if ent and ent[0] == "from" and ent[1][0] != mod:
            return self._from_module(*ent[1])
        return None

    def _resolve_name(self, mi: ModuleInfo, fi: FuncInfo | None,
                      name: str) -> FuncInfo | None:
        hit = _resolve_local(mi, fi, name)
        if hit is not None:
            return hit
        ent = mi.imports.get(name)
        if ent and ent[0] == "from":
            return self._from_module(*ent[1])
        return None

    def _resolve_call(self, mi: ModuleInfo, fi: FuncInfo,
                      node: ast.Call) -> FuncInfo | None:
        """Resolve a call target to a project FuncInfo (best effort)."""
        f = node.func
        if isinstance(f, ast.Name):
            return self._resolve_name(mi, fi, f.id)
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            ent = mi.imports.get(f.value.id)
            if ent and ent[0] == "module":
                return self._from_module(ent[1], f.attr)
            if ent and ent[0] == "from":
                return self._from_module(f"{ent[1][0]}.{ent[1][1]}", f.attr)
        return None

    def _references(self, mi: ModuleInfo, fi: FuncInfo):
        """Project functions that ``fi`` passes as values (not calls):
        a higher-order callee runs them on tick values."""
        called = {id(n.func) for n in self.nodes(fi)
                  if isinstance(n, ast.Call)}
        for n in self.nodes(fi):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and id(n) not in called:
                hit = self._resolve_name(mi, fi, n.id)
                if hit is not None and hit is not fi:
                    yield hit

    def _propagate(self) -> None:
        """Close tick scope + parameter and return taint over the call
        graph."""
        infos = [fi for mi in self.modules.values()
                 for fi in mi.functions.values()]
        for fi in infos:
            if fi.traced_root:
                fi.traced = True
                if fi.seeded:
                    fi.tainted_params = _seed_root_taint(fi)
        for _ in range(40):                      # small fixpoint
            changed = False
            self._outer.clear()
            for mi in self.modules.values():
                for fi in mi.functions.values():
                    taint = _Taint(self, mi, fi)
                    taint.run()
                    ret = _merge(fi.returns, taint.returns())
                    if ret != fi.returns:
                        fi.returns = ret
                        changed = True
                    if not fi.traced:
                        continue
                    for ref in self._references(mi, fi):
                        seed = _seed_root_taint(ref)
                        if not ref.traced or not seed <= ref.tainted_params:
                            ref.traced = True
                            ref.tainted_params |= seed
                            changed = True
                    for node in self.nodes(fi):
                        if not isinstance(node, ast.Call):
                            continue
                        callee = self._resolve_call(mi, fi, node)
                        if callee is None or callee is fi:
                            continue
                        if not callee.traced:
                            callee.traced = True
                            changed = True
                        for i, a in enumerate(node.args):
                            if isinstance(a, ast.Starred):
                                if taint.expr(a):
                                    new = set(callee.pos_params[i:]) \
                                        - STATIC_PARAMS
                                    if not new <= callee.tainted_params:
                                        callee.tainted_params |= new
                                        changed = True
                                break
                            if i >= len(callee.pos_params):
                                break
                            p = callee.pos_params[i]
                            if (p not in STATIC_PARAMS
                                    and p not in callee.tainted_params
                                    and taint.expr(a)):
                                callee.tainted_params.add(p)
                                changed = True
                        for kw in node.keywords:
                            if (kw.arg and kw.arg in callee.pos_params
                                    and kw.arg not in STATIC_PARAMS
                                    and kw.arg not in callee.tainted_params
                                    and taint.expr(kw.value)):
                                callee.tainted_params.add(kw.arg)
                                changed = True
            if not changed:
                break
        self._propagate_host()

    def _propagate_host(self) -> None:
        """Close ``host_params`` over the call graph, once tick scope
        and taint are final ("not a tick value" is only known then)."""
        for _ in range(40):
            changed = False
            self._outer.clear()
            for mi in self.modules.values():
                for fi in mi.functions.values():
                    if not fi.traced:
                        continue
                    taint = _Taint(self, mi, fi)
                    taint.run()
                    for node in self.nodes(fi):
                        if not isinstance(node, ast.Call):
                            continue
                        callee = self._resolve_call(mi, fi, node)
                        if callee is None or callee is fi:
                            continue
                        pairs = []
                        for i, a in enumerate(node.args):
                            if isinstance(a, ast.Starred) \
                                    or i >= len(callee.pos_params):
                                break
                            pairs.append((callee.pos_params[i], a))
                        pairs += [(k.arg, k.value) for k in node.keywords
                                  if k.arg in callee.pos_params]
                        for p, a in pairs:
                            if (p not in STATIC_PARAMS
                                    and p in callee.tainted_params
                                    and p not in callee.host_params
                                    and taint.is_host(a)):
                                callee.host_params.add(p)
                                changed = True
            if not changed:
                break

    # ---------------- reporting ---------------- #
    def _ignored(self, mi: ModuleInfo, line: int, rule: str) -> bool:
        if not (1 <= line <= len(mi.lines)):
            return False
        m = _IGNORE_RE.search(mi.lines[line - 1])
        if not m:
            return False
        rules = m.group(1)
        if rules is None:
            return True
        return rule in {r.strip() for r in rules.split(",")}

    def _emit(self, mi: ModuleInfo, fi: FuncInfo, node, rule: str,
              severity: str, message: str) -> None:
        line = getattr(node, "lineno", fi.node.lineno)
        if self._ignored(mi, line, rule):
            return
        self.findings.append(Finding(
            pass_name="lint", rule=rule, severity=severity, path=mi.path,
            line=line, symbol=f"{mi.module}.{fi.qualname}", message=message))

    # ---------------- rules ---------------- #
    def _is_none_check(self, node) -> bool:
        """Tick-safe tests: identity (``x is None``) and string-key
        membership in a params dict (``"w3" in p`` checks keys, which
        are structure, not tensor values)."""
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return True
            return (all(isinstance(op, (ast.In, ast.NotIn))
                        for op in node.ops)
                    and isinstance(node.left, ast.Constant)
                    and isinstance(node.left.value, str))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            return self._is_none_check(node.operand)
        if isinstance(node, ast.BoolOp):
            return all(self._is_none_check(v) for v in node.values)
        return False

    @staticmethod
    def _is_cpu(mi: ModuleInfo, node) -> bool:
        if isinstance(node, ast.Constant):
            return node.value == "cpu"
        return (isinstance(node, ast.Call)
                and _dotted(mi, node.func) == "torch.device"
                and bool(node.args) and Linter._is_cpu(mi, node.args[0]))

    def _check_call(self, mi: ModuleInfo, fi: FuncInfo, taint: _Taint,
                    node: ast.Call) -> None:
        f = node.func
        d = _dotted(mi, f)
        args = list(node.args) + [k.value for k in node.keywords]
        any_tainted = any(taint.expr(a) for a in args)
        if isinstance(f, ast.Name) and f.id in _CAST_CALLS and any_tainted:
            self._emit(mi, fi, node, "TRC101", ERROR,
                       f"Python {f.id}() on a tick value (a blocking "
                       f"device-to-host copy)")
        elif d is not None and d.startswith("numpy.") and any_tainted:
            self._emit(mi, fi, node, "TRC102", ERROR,
                       f"np.{f.attr}() on a tick value (host compute "
                       f"inside the tick; use torch on the device)")
        elif d in _HOST_BUILDERS:
            data = node.args[0] if node.args else next(
                (k.value for k in node.keywords if k.arg == "data"), None)
            if data is not None and taint.is_host(data):
                self._emit(mi, fi, node, "TRC102", ERROR,
                           f"{d}() of host data inside the tick (a host-"
                           f"to-device copy per tick; fill on the device "
                           f"with torch.full / zeros / arange)")
        elif d == "torch.cuda.synchronize":
            self._emit(mi, fi, node, "TRC103", ERROR,
                       "torch.cuda.synchronize() inside the tick (the "
                       "host waits for the device)")
        elif d in _HOST_COLLECTIVES:
            self._emit(mi, fi, node, "TRC103", ERROR,
                       f"{d}() inside the tick (a collective of host "
                       f"objects: the host waits; gather tensors with "
                       f"all_gather_into_tensor)")
        elif d in _NONZERO and any_tainted:
            self._emit(mi, fi, node, "TRC103", ERROR,
                       f"{d}() of a tick value (a data-dependent size "
                       f"syncs with the host; use core.join.first_true)")
        elif d == "torch.where" and len(args) == 1 and any_tainted:
            self._emit(mi, fi, node, "TRC103", ERROR,
                       "one-argument torch.where of a tick value (a "
                       "data-dependent size syncs with the host)")
        elif isinstance(f, ast.Attribute) and taint.expr(f.value):
            if f.attr in _SYNC_ATTRS:
                self._emit(mi, fi, node, "TRC103", ERROR,
                           f".{f.attr}() on a tick value (device->host "
                           f"sync inside the tick)")
            elif f.attr == "nonzero":
                self._emit(mi, fi, node, "TRC103", ERROR,
                           ".nonzero() of a tick value (a data-dependent "
                           "size syncs with the host; use "
                           "core.join.first_true)")
            elif f.attr == "to" and any(self._is_cpu(mi, a) for a in args):
                self._emit(mi, fi, node, "TRC103", ERROR,
                           ".to('cpu') of a tick value (device->host "
                           "copy inside the tick)")

    def _check_traced_fn(self, mi: ModuleInfo, fi: FuncInfo) -> None:
        taint = _Taint(self, mi, fi)
        taint.run()
        for node in _own_nodes(fi.node):
            if isinstance(node, ast.Call):
                self._check_call(mi, fi, taint, node)
            elif isinstance(node, (ast.If, ast.While)):
                test = node.test
                if taint.expr(test) and not self._is_none_check(test):
                    kw = "while" if isinstance(node, ast.While) else "if"
                    self._emit(mi, fi, node, "TRC104", ERROR,
                               f"Python `{kw}` on a tick value (a host "
                               f"read of a device value; use torch.where)")
            elif isinstance(node, ast.IfExp):
                if taint.expr(node.test) and not self._is_none_check(
                        node.test):
                    self._emit(mi, fi, node, "TRC104", ERROR,
                               "ternary on a tick value (use torch.where)")
            elif isinstance(node, ast.Assert):
                if taint.expr(node.test) and not self._is_none_check(
                        node.test):
                    self._emit(mi, fi, node, "TRC104", ERROR,
                               "assert on a tick value (a host read of a "
                               "device value every tick)")
        self._check_whole_copies(mi, fi, taint)

    @staticmethod
    def _whole_leaf(fi: FuncInfo, taint: _Taint, node) -> bool:
        """A whole incoming tensor: a tick-value parameter, or a field
        of one (``state.t_now``), not a slice or a computed value."""
        base = node
        while isinstance(base, ast.Attribute):
            base = base.value
        return (isinstance(base, ast.Name)
                and base.id in fi.pos_params + fi.kwonly_params
                and taint.expr(node))

    def _check_whole_copies(self, mi: ModuleInfo, fi: FuncInfo,
                            taint: _Taint) -> None:
        """TRC106: a whole state leaf copied inside the tick."""
        for node in _own_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(mi, node.func)
            whole = None
            if d in ("torch.cat", "torch.concat") and node.args:
                seqs, elts = [node.args[0]], []
                while seqs:
                    s = seqs.pop()
                    if isinstance(s, ast.BinOp):
                        seqs += [s.left, s.right]
                    elif isinstance(s, (ast.List, ast.Tuple)):
                        elts += s.elts
                whole = next((e for e in elts
                              if self._whole_leaf(fi, taint, e)), None)
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "clone"
                    and self._whole_leaf(fi, taint, node.func.value)):
                whole = node.func.value
            if whole is not None:
                self._emit(
                    mi, fi, node, "TRC106", WARNING,
                    f"the tick copies the whole tensor "
                    f"'{ast.unparse(whole)}' ({d or '.clone'}) instead of "
                    f"updating it in place: a full table copy every "
                    f"tick — update in place or justify in the baseline")

    def _check_builder_closures(self, mi: ModuleInfo, fi: FuncInfo) -> None:
        """TRC105: inner tick fns closing over dynamic builder params."""
        if not _BUILDER_RE.match(fi.qualname.split(".")[-1]):
            return
        builder_params = [p for p in fi.pos_params + fi.kwonly_params
                          if p not in STATIC_PARAMS]
        if not builder_params:
            return
        inner = [f for f in mi.functions.values()
                 if f.parent is fi and f.traced]
        for child in inner:
            bound = set(child.pos_params) | set(child.kwonly_params)
            for sub in ast.walk(child.node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and sub is not child.node:
                    bound |= {a.arg for a in sub.args.args}
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            bound.add(t.id)
            for sub in ast.walk(child.node):
                if (isinstance(sub, ast.Name)
                        and isinstance(sub.ctx, ast.Load)
                        and sub.id in builder_params
                        and sub.id not in bound):
                    self._emit(
                        mi, child, sub, "TRC105", WARNING,
                        f"tick closure captures builder parameter "
                        f"'{sub.id}' as a constant — it is frozen into "
                        f"the built tick and any graph captured from it; "
                        f"make it a runtime input (cf. the per-slot "
                        f"window tensor)")
                    break                         # one finding per capture

    @staticmethod
    def _imports_obs(mi: ModuleInfo) -> bool:
        for ent in mi.imports.values():
            name = ent[1] if ent[0] == "module" else f"{ent[1][0]}." \
                f"{ent[1][1]}"
            if name == _OBS_MODULE or name.startswith(_OBS_MODULE + "."):
                return True
        return False

    def _check_obs_sites(self, mi: ModuleInfo) -> int:
        """TRC107 + census: ``repro_torch.obs`` span/metric emission
        sites.

        Only modules importing ``repro_torch.obs`` are scanned (the
        emission attribute names are too generic to attribute
        otherwise).  Returns the module's site count; sites inside tick
        scope are errors."""
        if not self._imports_obs(mi):
            return 0
        n_sites = 0
        for fi in mi.functions.values():
            for node in _own_nodes(fi.node):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in _OBS_EMIT_ATTRS):
                    continue
                n_sites += 1
                if fi.traced:
                    self._emit(
                        mi, fi, node, "TRC107", ERROR,
                        f"obs emission .{node.func.attr}() in tick scope "
                        f"— a host call inside the tick runs once at "
                        f"capture time under a CUDA graph; hoist "
                        f"instrumentation out of the tick")
        return n_sites

    # ---------------- entry ---------------- #
    def run(self) -> list[Finding]:
        self.load()
        for mi in self.modules.values():
            _mark_roots(mi)
        self._propagate()
        n_obs_sites = 0
        for mi in self.modules.values():
            for fi in mi.functions.values():
                if fi.traced:
                    self._check_traced_fn(mi, fi)
                self._check_builder_closures(mi, fi)
            n_obs_sites += self._check_obs_sites(mi)
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        funcs = [fi for mi in self.modules.values()
                 for fi in mi.functions.values()]

        def roots(kind):
            return sum(1 for fi in funcs if fi.root_kind == kind)

        self.stats = {
            "n_files": len(self.modules),
            "n_functions": len(funcs),
            "n_traced_functions": sum(1 for fi in funcs if fi.traced),
            # closures builders return: the ticks (slot, multi, node,
            # mesh and sharded ticks all come from build_* builders)
            "n_tick_roots": roots("tick"),
            # kernel packages' public ops and *_cuda launch wrappers
            "n_kernel_roots": roots("kernel"),
            # handed to CUDA-graph capture / torch.compile / vmap, or an
            # autograd Function's forward
            "n_graph_roots": roots("graph") + roots("autograd"),
            # repro_torch.obs span/metric emission sites in obs-importing
            # modules — all proven host-side (any one in tick scope is a
            # TRC107 error above)
            "n_obs_sites": n_obs_sites,
        }
        return self.findings


def lint_tree(root: str) -> tuple[list[Finding], dict]:
    """Lint every module under ``root`` (a package dir like
    src/repro_torch)."""
    linter = Linter(root)
    findings = linter.run()
    return findings, linter.stats
