"""Kernel contract checker: static proofs over every CUDA launch.

The port of ``repro.analysis.kernel_check``, for the Hopper kernels.
Each CUDA source (``kernels/<k>/csrc/*.cu``) has a plain ``extern "C"``
launch function that reads a launch plan computed in Python
(``kernels/<k>/kernel.py: plan``) as an int64 array in the order of the
source's ``P_*`` / ``E_*`` enum.  This pass proves, for every launch
function and over the *reachable shape lattice* — the reference's
pow-2 capacities (the serving stack quantizes every table axis with
``runtime.straggler.quantize_pow2``, floor 8), slot-stack depths and
``max_new`` values, plus the larger shapes the port's paths run on the
card (65,536 and 262,144-row tables, a gathered 32,768-row delta, GIN at
the ogbn-products shape, Wide&Deep's serving batches):

KC101  grid and cover: every grid extent lies in [1, limit] (x up to
       2^31 - 1; y and z up to 65,535) and the blocks cover every row
       and column exactly: ``nrt·at >= ca``, ``nt·tb >= cb``,
       ``n_cc·dc >= d``, ``blocks·groups·k_bags >= n_bags``, a lane
       group for every node and window, a digit for every key bit; a plan that
       refuses a shape the port's paths run is a finding too;
KC102  Hopper's granules: ``tb`` a multiple of ``WIN`` (512) and of a
       warp, ``at`` of 16; block threads a multiple of 32 and at most
       1,024; ``vec`` divides the row bytes and the base alignment;
       ``lr`` a power of two within the lane group; the run length the
       source's ``SR_RUN``;
KC103  on-chip and workspace bounds: dynamic plus static shared memory
       within ``SMEM_LIMIT`` at every point (the proof behind the
       run-time ``assert`` in ``compat_join.kernel.plan``; a fired
       assert is a finding), every extent the source indexes with an
       ``int`` below 2^31, the workspace regions disjoint and inside
       ``ws_bytes``; and the ABI: ``PLAN_FIELDS`` equals the source's
       enum in order, ``SHAPES`` its ``CJ_SHAPES``, each Python constant
       commented as a copy of a ``#define`` (or of an enum family) its
       value;
KC104  the pair cursor: the emit clamp ``min(run[r] + counts[i],
       max_new)`` and the unsigned ``n_dropped`` are present in the
       source, the plan and the source both refuse ``CA·CB - max_new >=
       2^31``, and at the interval extremes of the cursor every write
       lands below ``max_new`` and no ``int`` sum overflows;
KC105  kernel-vs-plain agreement: the output tree (structure, shapes,
       dtypes) each launch wrapper allocates against its plain
       version's, both evaluated on ``torch.device("meta")`` (zero
       work, no card); on a card, one real call of each CUDA route
       against its plain version at the lattice's small points.

KC100 (warning) flags any launch function in a kernels package (an
``extern "C"`` function of a ``.cu`` source, or a name a ``_bind``
declares) that has no contract here — new kernels must register one.

A ``ValueError`` from a ``plan`` is a refusal the kernel documents, not
a finding; ``check_device_limits`` holds the limits the proofs assume
(shared memory a block may opt into, the SM count the grids are sized
for) against a card's.
"""

from __future__ import annotations

import ast
import itertools
import os
import re

import numpy as np

from repro_torch.analysis.findings import ERROR, WARNING, Finding

# Launch functions with a contract below.  KC100 fires for any other
# launch function.
MODELED_LAUNCHES = frozenset({
    "compat_join_pairs_launch", "compat_mask_launch", "segment_sum_launch",
    "embedding_bag_launch",
})
SOURCES = {"compat_join": "compat_join.cu",
           "segment_reduce": "segment_reduce.cu",
           "embedding_bag": "embedding_bag.cu"}

# The reference's lattice (repro.analysis.kernel_check).  Capacities are
# pow-2 (quantize_pow2, lo=8); slot-stack depths come from
# plan_signature grouping in core.multi.
CAPS_FULL = tuple(2 ** k for k in range(3, 13))          # 8 .. 4096
CAPS_FAST = (8, 64, 256, 4096)
SLOTS = (1, 2, 4, 8)
MAX_NEW = (64, 256, 1024, 4096)
WIDTHS = (1, 2, 3, 4)                                    # nv / ne columns
FLAG_SETS = (
    (False,) * 6,
    (True,) * 6,
    (True, True, True, False, False, False),
    (False, False, False, True, True, True),
)
NON_POW2 = (100, 37)               # the padding path's point

# The shapes the port's paths run on the card (chip_smoke.py's phases).
PATH_MAX_NEW = 8192
PATH_BATCH = 4096                  # stream edges a tick
PATH_LEVEL_CAP = 65_536            # a slot's level / L0 table
PATH_CAPACITY = 262_144            # one engine's table over all shards
PATH_SLOTS = (1, 4, 8)             # node ticks, mesh blocks, slot groups
GIN_E, GIN_N = 61_225_725, 2_449_029
# the other GNN paths' message widths: GAT's two layers at the products
# widths (8 heads x 8 hidden, 8 heads x 47 classes) and PNA's 75 hidden,
# bf16, on the products graph and on a minibatch_lg subgraph (1,024
# seeds, fanout 15-10); NequIP's l = 0/1/2 sums (32 channels x 1/3/9),
# float32, over 128 molecules of 30 atoms and 64 edges
GNN_WIDTHS = (64, 376, 75)
MINIBATCH_E, MINIBATCH_N = 168_960, 169_984
NEQUIP_E, NEQUIP_N, NEQUIP_WIDTHS = 128 * 64, 128 * 30, (32, 96, 288)
SEG_WIDE_N = 4_000_000             # the uniform case over 4 M nodes
WD_BATCHES = (512, 262_144)        # serve_p99, serve_bulk
WD_TABLES = ((4_000_000, 1), (1_000_000, 32))
WD_IDS_PER_BAG = 16

INT_MAX = 2 ** 31 - 1
GRID_X_MAX, GRID_YZ_MAX = 2 ** 31 - 1, 65_535
BLOCK_THREADS_MAX = 1024


def _finding(rule, severity, symbol, message, path="", line=0):
    return Finding(pass_name="kernel", rule=rule, severity=severity,
                   path=path, line=line, symbol=symbol, message=message)


def _kernels_root(kernels_root: str | None) -> str:
    if kernels_root is None:
        kernels_root = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "kernels")
    return kernels_root


def _repo_rel(kernels_root: str, path: str) -> str:
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(kernels_root))))
    return os.path.relpath(path, repo_root)


def _source_path(kernels_root: str, kernel: str) -> str:
    return os.path.join(kernels_root, kernel, "csrc", SOURCES[kernel])


def _read(path: str) -> str | None:
    try:
        with open(path) as fh:
            return fh.read()
    except FileNotFoundError:
        return None


def _kernel_module(kernel: str):
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{kernel}.kernel")


def _plan_fn(K):
    """The module's ``plan`` without its cache (the lattice would evict a
    running process's entries), looked up at call time."""
    return getattr(K.plan, "__wrapped__", K.plan)


# --------------------------------------------------------------------- #
# Source parsing
# --------------------------------------------------------------------- #
_DEFINE_RE = re.compile(r"^#define\s+([A-Z_][A-Z0-9_]*)\s+(.+?)\s*(//.*)?$",
                        re.M)
_EXTERN_RE = re.compile(r'extern\s+"C"\s+[\w\s\*]+?\b(\w+)\s*\(')


def parse_defines(src: str) -> dict[str, int]:
    """Integer ``#define``s of a source (literals and arithmetic over
    earlier ones); function-like macros are skipped."""
    out: dict[str, int] = {}
    for name, body, _ in _DEFINE_RE.findall(src):
        body = re.sub(r"\b(0x[0-9a-fA-F]+|\d+)[uUlL]+\b", r"\1", body)
        if not re.fullmatch(r"[\w\s\(\)\+\-\*/%<>]+", body):
            continue
        expr = re.sub(r"\b([A-Z_][A-Z0-9_]*)\b",
                      lambda m: str(out.get(m.group(1), m.group(1))), body)
        expr = expr.replace("/", "//")
        try:
            out[name] = int(eval(expr, {"__builtins__": {}}))  # noqa: S307
        except Exception:
            continue
    return out


def parse_enum(src: str, prefix: str) -> list[str] | None:
    """The members of the enum whose members start with ``prefix`` and
    end with ``<prefix>COUNT``, in order, lower-cased and without the
    prefix (the plan's field names); None if there is none."""
    for body in re.findall(r"enum\s*\{([^}]*)\}", src):
        names = [n.strip().split("=")[0].strip()
                 for n in body.split(",") if n.strip()]
        if names and names[-1] == f"{prefix}COUNT" \
                and all(n.startswith(prefix) for n in names):
            return [n[len(prefix):].lower() for n in names[:-1]]
    return None


def parse_enum_values(src: str) -> dict[str, int]:
    """Enum members with explicit values (``KIND_PAIRS = 0``)."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"\b([A-Z][A-Z0-9_]*)\s*=\s*(\d+)\s*[,}]", src)}


def parse_shapes(src: str) -> tuple | None:
    """The ``CJ_SHAPES(X)`` list of (NVA, NVB, NEA, NEB)."""
    m = re.search(r"#define\s+CJ_SHAPES\(X\)((?:[^\n]*\\\n)*[^\n]*)", src)
    if not m:
        return None
    return tuple(tuple(int(v) for v in t.split(","))
                 for t in re.findall(r"X\(([\d,\s]+)\)", m.group(1)))


def _line_of(src: str, needle: str) -> int:
    i = src.find(needle)
    return 0 if i < 0 else src.count("\n", 0, i) + 1


def discover_launch_sites(kernels_root: str) -> list[tuple[str, str, int]]:
    """Every launch function of the kernels packages as (repo-relative
    path, name, line): the ``extern "C"`` functions of ``csrc/*.cu`` and
    the names a ``kernel.py``'s ``_bind`` declares."""
    sites, seen = [], set()
    for dirpath, _d, files in sorted(os.walk(kernels_root)):
        for fn in sorted(files):
            path = os.path.join(dirpath, fn)
            if fn.endswith(".cu"):
                src = _read(path)
                for m in _EXTERN_RE.finditer(src):
                    name = m.group(1)
                    if name not in seen:
                        seen.add(name)
                        sites.append((_repo_rel(kernels_root, path), name,
                                      src.count("\n", 0, m.start()) + 1))
            elif fn == "kernel.py":
                tree = ast.parse(_read(path), filename=path)
                for node in ast.walk(tree):
                    if not (isinstance(node, ast.FunctionDef)
                            and node.name == "_bind"):
                        continue
                    for sub in ast.walk(node):
                        if (isinstance(sub, ast.Attribute)
                                and sub.attr == "argtypes"
                                and isinstance(sub.value, ast.Attribute)
                                and sub.value.attr not in seen):
                            seen.add(sub.value.attr)
                            sites.append((_repo_rel(kernels_root, path),
                                          sub.value.attr, sub.lineno))
    return sites


def _count_globals(kernels_root: str) -> int:
    n = 0
    for dirpath, _d, files in sorted(os.walk(kernels_root)):
        for fn in files:
            if fn.endswith(".cu"):
                n += len(re.findall(r"\b__global__\b",
                                    _read(os.path.join(dirpath, fn))))
    return n


# --------------------------------------------------------------------- #
# KC103 (ABI): enums, defines and instantiations against the Python side
# --------------------------------------------------------------------- #
_COPY_RE = re.compile(r"\s*(?:the source's\s+)?([A-Z][A-Z0-9]*_(?:\*|[A-Z0-9_]*))")


def _constant_copies(K) -> list[tuple[list[str], object, str, int]]:
    """Top-level assignments of ``K``'s source whose comment names a
    ``#define`` (``MAX_NV = 16  # CJ_MAX_NV in the source``) or an enum
    family (``PAIRS, MASK = 0, 1  # the source's KIND_* enum``):
    (targets, value, token, line)."""
    src = _read(K.__file__)
    lines = src.splitlines()
    out = []
    for node in ast.parse(src).body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        m = _COPY_RE.match(lines[node.lineno - 1].partition("#")[2])
        if not m:
            continue
        t = node.targets[0]
        names = [t.id] if isinstance(t, ast.Name) else [
            e.id for e in getattr(t, "elts", []) if isinstance(e, ast.Name)]
        out.append((names, [getattr(K, n) for n in names], m.group(1),
                    node.lineno))
    return out


def check_source_contracts(kernels_root: str | None = None
                           ) -> list[Finding]:
    """KC103's ABI half: each plan's field order against its source's
    enum, the compat-join instantiations against ``CJ_SHAPES``, and the
    Python copies of ``#define``s and enum values against the source."""
    kernels_root = _kernels_root(kernels_root)
    findings: list[Finding] = []
    for kernel, prefix in (("compat_join", "P_"), ("segment_reduce", "P_"),
                           ("embedding_bag", "E_")):
        path = _source_path(kernels_root, kernel)
        src = _read(path)
        if src is None:
            continue
        rel = _repo_rel(kernels_root, path)
        K = _kernel_module(kernel)
        enum = parse_enum(src, prefix)
        if enum != list(K.PLAN_FIELDS):
            findings.append(_finding(
                "KC103", ERROR, f"{kernel}.PLAN_FIELDS",
                f"PLAN_FIELDS {list(K.PLAN_FIELDS)} != the source's "
                f"{prefix}* enum {enum}: the launch would read its plan "
                f"at the wrong offsets", rel, _line_of(src, "enum {")))
        defines = parse_defines(src)
        values = parse_enum_values(src)
        for names, vals, token, line in _constant_copies(K):
            if token.endswith("_*"):
                fam = token[:-1]
                want = [values.get(fam + n) for n in names]
            else:
                want = [defines.get(token)]
                vals = vals[:1]
            if want != list(vals):
                findings.append(_finding(
                    "KC103", ERROR, f"{kernel}.{','.join(names)}",
                    f"{','.join(names)} = {list(vals)} in kernel.py, but "
                    f"the source's {token} is {want}",
                    rel, _line_of(src, token.rstrip("*"))))
        if kernel == "compat_join":
            shapes = parse_shapes(src)
            if shapes != tuple(K.SHAPES):
                findings.append(_finding(
                    "KC103", ERROR, "compat_join.SHAPES",
                    f"SHAPES {K.SHAPES} != the source's CJ_SHAPES "
                    f"{shapes}: plans would name the wrong instantiation",
                    rel, _line_of(src, "#define CJ_SHAPES")))
        limits = {int(v) for v in re.findall(
            r"[sS][mM][eE][mM]\]?\s*>\s*(\d+)", src)}
        if hasattr(K, "SMEM_LIMIT") and limits and limits != {K.SMEM_LIMIT}:
            findings.append(_finding(
                "KC103", ERROR, f"{kernel}.SMEM_LIMIT",
                f"the source refuses plans past {sorted(limits)} bytes of "
                f"shared memory, kernel.py's SMEM_LIMIT is "
                f"{K.SMEM_LIMIT}", rel))
        for name, v in defines.items():
            if name.endswith("THREADS") and (v % 32 or not
                                             0 < v <= BLOCK_THREADS_MAX):
                findings.append(_finding(
                    "KC102", ERROR, f"{kernel}.{name}",
                    f"{name} = {v}: a block must be whole warps and at "
                    f"most {BLOCK_THREADS_MAX} threads", rel,
                    _line_of(src, f"#define {name}")))
    return findings


# --------------------------------------------------------------------- #
# KC101 / KC102 / KC103 over the lattice
# --------------------------------------------------------------------- #
class _Sink:
    """Findings of one lattice sweep, at most ``cap`` per (rule,
    symbol prefix) so a broken contract reads as a few lines."""

    def __init__(self, cap: int = 3):
        self.cap = cap
        self.findings: list[Finding] = []
        self._n: dict[tuple, int] = {}

    def add(self, rule, kernel, sym, msg, path=""):
        key = (rule, kernel)
        self._n[key] = self._n.get(key, 0) + 1
        if self._n[key] <= self.cap:
            self.findings.append(_finding(rule, ERROR, sym, msg, path))


def _grid_ok(sink, kernel, sym, extents, path):
    for axis, (g, lim) in zip("xyz", extents):
        if not 1 <= g <= lim:
            sink.add("KC101", kernel, sym,
                     f"grid.{axis} = {g} outside [1, {lim}]", path)


def _compat_static(K, defines, kind, r):
    """Static shared memory of the block (the source's ``red`` and, for
    the mask, its ``frame``)."""
    warps = defines.get("CJ_WARPS", 8)
    static = 4 * warps
    if kind == K.MASK:
        static += 4 * warps * r * (defines.get("CJ_WIN", 512) // 32 + 1)
    return static


def _compat_point(sink, K, defines, path, kind, n_slots, ca, cb, dims,
                  stacked, window, max_new, required=False):
    """Plan one compat launch and prove it; returns the plan or None."""
    nva, nvb, nea, neb = dims
    what = "pairs" if kind == K.PAIRS else "mask"
    sym = (f"compat_{what}(S={n_slots},ca={ca},cb={cb},dims={dims}"
           + (f",max_new={max_new}" if kind == K.PAIRS else "") + ")")
    try:
        p = _plan_fn(K)(kind, n_slots, ca, cb, nva, nvb, nea, neb, stacked,
                        window, max_new if kind == K.PAIRS else 0)
    except ValueError as exc:
        if required:
            sink.add("KC101", "compat_join", sym,
                     f"plan refuses a shape the port's paths run: {exc}",
                     path)
        return None
    except AssertionError:
        sink.add("KC103", "compat_join", sym,
                 f"plan's run-time assert `smem <= SMEM_LIMIT` fired "
                 f"(SMEM_LIMIT {K.SMEM_LIMIT})", path)
        return None
    except Exception as exc:                 # noqa: BLE001 (a crash)
        sink.add("KC101", "compat_join", sym, f"plan failed: {exc!r}", path)
        return None
    # KC101: grids within the launch limits, blocks covering exactly
    _grid_ok(sink, "compat_join", sym,
             [(p.nrt, GRID_X_MAX), (p.nt, GRID_YZ_MAX),
              (n_slots, GRID_YZ_MAX)], path)
    if p.nrt * p.at < ca or (p.nrt - 1) * p.at >= ca:
        sink.add("KC101", "compat_join", sym,
                 f"{p.nrt} A tiles of {p.at} rows do not cover {ca} rows "
                 f"exactly", path)
    if p.nt * p.tb < cb or (p.nt - 1) * p.tb >= cb:
        sink.add("KC101", "compat_join", sym,
                 f"{p.nt} B tiles of {p.tb} columns do not cover {cb} "
                 f"exactly", path)
    n_shapes = len(K.SHAPES)
    if not (0 <= p.shape <= n_shapes) or (
            p.shape < n_shapes and K.SHAPES[p.shape] != dims) or (
            p.shape == n_shapes and dims in K.SHAPES):
        sink.add("KC101", "compat_join", sym,
                 f"instantiation {p.shape} does not fit dims {dims}", path)
    # KC102: Hopper granules
    win = defines.get("CJ_WIN", K.WIN)
    if p.tb % win or p.tb % 32 or p.at % 16 or p.at < 16:
        sink.add("KC102", "compat_join", sym,
                 f"tiles (at={p.at}, tb={p.tb}): tb must be a multiple of "
                 f"WIN {win} and of a warp, at a multiple of 16", path)
    if p.r != (defines.get("CJ_R", K.ROWS_PER_WARP)
               if p.shape < n_shapes else 1):
        sink.add("KC102", "compat_join", sym,
                 f"{p.r} A rows a warp for instantiation {p.shape}", path)
    # KC103: shared memory and int-indexed extents
    smem = K.smem_bytes(kind, nva, nvb, nea, neb, p.tb, p.at)
    static = _compat_static(K, defines, kind, p.r)
    if p.smem != smem or smem + static > K.SMEM_LIMIT:
        sink.add("KC103", "compat_join", sym,
                 f"shared memory {p.smem} (+{static} static) B against "
                 f"smem_bytes {smem} and SMEM_LIMIT {K.SMEM_LIMIT}", path)
    extents = {"A tile start rt*at": (p.nrt - 1) * p.at + p.at - 1,
               "B tile start bt*tb": (p.nt - 1) * p.tb + p.tb - 1,
               "a block's pair count at*tb": p.at * p.tb}
    if kind == K.PAIRS:
        extents["pair cursor max_new"] = max_new
        want = 2 * n_slots * ca * p.nt + n_slots * p.nrt * p.nt
        if p.scratch != want:
            sink.add("KC103", "compat_join", sym,
                     f"scratch {p.scratch} int32, the source takes "
                     f"{want}", path)
    for name, v in extents.items():
        if v > INT_MAX:
            sink.add("KC103", "compat_join", sym,
                     f"{name} reaches {v}, past the source's int", path)
    per_slot = (ca * nva, ca * nea, ca, cb * nvb, cb * neb, cb)
    strides = (p.sa_bind, p.sa_ets, p.sa_valid, p.sb_bind, p.sb_ets,
               p.sb_valid)
    if strides != tuple(n if s else 0 for n, s in zip(per_slot, stacked)):
        sink.add("KC103", "compat_join", sym,
                 f"slot strides {strides} for stacked flags {stacked}",
                 path)
    return p


def _path_joins():
    """(what, S, ca, cb, stacked) of every pair join the port's paths
    run on the card: the serving tick's level join (A against the
    stream batch) and L0 joins (a delta against a table) over a slot
    group, a mesh block and a prefix node, and capacity sharding's joins
    over n shards (the L0 deltas gathered into a shared operand)."""
    level = (True, True, True, False, False, True)
    both = (True,) * 6
    out = []
    for s in PATH_SLOTS:
        out += [("level", s, PATH_LEVEL_CAP, PATH_BATCH, level),
                ("l0_j1", s, PATH_MAX_NEW, PATH_LEVEL_CAP, both),
                ("l0_j2", s, PATH_LEVEL_CAP, PATH_MAX_NEW, both)]
    for n in (1, 2, 4):
        c = PATH_CAPACITY // n
        out += [("capacity_level", n, c, PATH_BATCH, level),
                ("capacity_l0_j1", n, n * PATH_MAX_NEW, c,
                 (False, False, False, True, True, True)),
                ("capacity_l0_j2", n, c, n * PATH_MAX_NEW,
                 (True, True, True, False, False, False))]
    return out


def _dims_lattice(K, fast: bool):
    """The compat plan shapes: every instantiation and runtime dims from
    the reference's WIDTHS (and the spec maxima)."""
    dims = list(K.SHAPES)
    ws = WIDTHS[::3] if fast else WIDTHS
    dims += [(w, w, w, w) for w in ws if (w, w, w, w) not in K.SHAPES]
    if not fast:
        dims.append((K.MAX_NV, K.MAX_NV, K.MAX_NE, K.MAX_NE))
    return dims


def _check_compat(sink, kernels_root, fast):
    path = _source_path(kernels_root, "compat_join")
    src = _read(path)
    if src is None:
        return
    rel = _repo_rel(kernels_root, path)
    K = _kernel_module("compat_join")
    defines = parse_defines(src)
    caps = CAPS_FAST if fast else CAPS_FULL
    dims_l = _dims_lattice(K, fast)
    points = list(itertools.product(caps, caps)) + [NON_POW2]
    for (ca, cb), dims in itertools.product(points, dims_l):
        for n_slots, flags in itertools.product(
                SLOTS[:2] if fast else SLOTS,
                FLAG_SETS[:2] if fast else FLAG_SETS):
            for window in (False, True):
                _compat_point(sink, K, defines, rel, K.MASK, n_slots, ca,
                              cb, dims, flags, window, 0)
                for max_new in (MAX_NEW[:1] if fast else MAX_NEW):
                    _compat_point(sink, K, defines, rel, K.PAIRS, n_slots,
                                  ca, cb, dims, flags, window, max_new)
    # the port's paths: each reached join must plan (and prove)
    for what, n_slots, ca, cb, stacked in _path_joins():
        for dims in K.SHAPES + ((1, 1, 1, 1),):
            _compat_point(sink, K, defines, rel, K.PAIRS, n_slots, ca, cb,
                          dims, stacked, True, PATH_MAX_NEW, required=True)
            if not what.startswith("capacity"):    # the mask's shapes
                _compat_point(sink, K, defines, rel, K.MASK, n_slots, ca,
                              cb, dims, stacked, True, 0, required=True)


def _seg_point(sink, K, defines, path, e, n, d, elem, align,
               required=False):
    sym = f"segment_sum(E={e},N={n},D={d},elem={elem},align={align})"
    try:
        p = _plan_fn(K)(e, n, d, elem, align)
    except ValueError as exc:
        if required:
            sink.add("KC101", "segment_reduce", sym,
                     f"plan refuses a shape the port's paths run: "
                     f"{exc!r}", path)
        return None
    except Exception as exc:                 # noqa: BLE001 (a crash)
        sink.add("KC101", "segment_reduce", sym, f"plan failed: {exc!r}", path)
        return None
    ve = p.vec // elem
    per = K.THREADS // p.lr if p.lr else 0
    _grid_ok(sink, "segment_reduce", sym,
             [(p.grid_nodes, GRID_X_MAX), (p.n_cc, GRID_YZ_MAX),
              (p.grid_starts, GRID_X_MAX), (p.grid_pieces, GRID_X_MAX)],
             path)
    if e:
        _grid_ok(sink, "segment_reduce", sym,
                 [(p.nb, GRID_X_MAX), (p.grid_runs, GRID_X_MAX)], path)
    if p.n_cc * p.dc < d:
        sink.add("KC101", "segment_reduce", sym,
                 f"{p.n_cc} chunks of {p.dc} columns do not cover D={d}",
                 path)
    # every node a lane group, every window of RUN sorted positions one,
    # every edge a sort block's tile, every key (up to n) a digit a pass
    if p.grid_nodes * K.THREADS < n or p.grid_runs * per < p.windows \
            or p.windows * p.run < e or p.nb * p.sub * K.TILE < e \
            or p.pieces * p.piece < e or p.grid_pieces * per < p.pieces \
            or not 1 <= p.piece <= p.run \
            or p.passes * K.BITS < n.bit_length():
        sink.add("KC101", "segment_reduce", sym,
                 f"grids do not cover the work: nodes {p.grid_nodes} x "
                 f"{per} for {n}, windows {p.windows} of {p.run} and "
                 f"pieces {p.pieces} for E={e}, sort blocks {p.nb} x "
                 f"{p.sub} tiles, {p.passes} "
                 f"passes of {K.BITS} bits for keys up to {n}", path)
    run = defines.get("SR_RUN", K.RUN)
    if (p.vec < elem or (d * elem) % p.vec or align % p.vec
            or p.dc % ve or p.lr & (p.lr - 1) or not 1 <= p.lr <= 32
            or p.lr * ve < p.dc or p.run != run
            or K.THREADS % p.lr or not 1 <= p.sub <= K.SUB_MAX):
        sink.add("KC102", "segment_reduce", sym,
                 f"granules vec={p.vec} dc={p.dc} lr={p.lr} run={p.run} "
                 f"sub={p.sub}: vec must divide the row ({d * elem} B) and "
                 f"the alignment ({align}), lr be a power of two <= 32 "
                 f"covering dc, run the source's SR_RUN {run}", path)
    # the sorted positions, each run's end and the scratch rows are ints
    for name, v in (("sorted positions", e + p.run), ("node starts", n + 1),
                    ("scratch rows", 2 * p.windows),
                    ("sort block tiles", p.nb * p.sub)):
        if v > INT_MAX:
            sink.add("KC103", "segment_reduce", sym,
                     f"{name} reach {v}, past the source's int", path)
    sizes = K.workspace_sizes(e, n, d, p.passes, p.nb, p.windows)
    spans = sorted((getattr(p, k), getattr(p, k) + v, k)
                   for k, v in sizes.items())
    for (lo, hi, k), (lo2, _, k2) in zip(spans, spans[1:]):
        if hi > lo2:
            sink.add("KC103", "segment_reduce", sym,
                     f"workspace {k} [{lo}, {hi}) overlaps {k2} at {lo2}",
                     path)
    if spans[-1][1] > p.ws_bytes or any(lo % 16 for lo, _, _ in spans) \
            or sizes["ws_scratch"] < 4 * 2 * p.windows * d \
            or sizes["ws_hist"] < 4 * K.BINS * (p.nb + 1):
        sink.add("KC103", "segment_reduce", sym,
                 f"workspace regions past ws_bytes {p.ws_bytes}, not "
                 f"16-byte aligned, or short of the scratch rows / digit "
                 f"counts", path)
    return p


def _check_segment_sum(sink, kernels_root, fast):
    path = _source_path(kernels_root, "segment_reduce")
    src = _read(path)
    if src is None:
        return
    rel = _repo_rel(kernels_root, path)
    K = _kernel_module("segment_reduce")
    defines = parse_defines(src)
    es = (0, 512, 65_536) if fast else (0, 1, 512, 4096, 65_536, 1 << 20)
    ns = (1, 256, 1000) if fast else (1, 128, 256, 1000, 4096, 1 << 20)
    ds = (1, 8, 100) if fast else (1, 2, 8, 64, 100, 128, 129, 1024, 65_536)
    for e, n, d, elem in itertools.product(es, ns, ds, (4, 2)):
        for align in ((0,) if fast else (0, 4, 8) if elem == 4
                      else (0, 2, 4, 6, 8)):
            _seg_point(sink, K, defines, rel, e, n, d, elem, align)
    for d, elem in itertools.product((100, 64, 1), (2, 4)):
        _seg_point(sink, K, defines, rel, GIN_E, GIN_N, d, elem, 0,
                   required=True)
    _seg_point(sink, K, defines, rel, GIN_E, SEG_WIDE_N, 64, 2, 0,
               required=True)
    for (e, n), d in itertools.product(((GIN_E, GIN_N),
                                        (MINIBATCH_E, MINIBATCH_N)),
                                       GNN_WIDTHS):
        _seg_point(sink, K, defines, rel, e, n, d, 2, 0, required=True)
    for d in NEQUIP_WIDTHS:
        _seg_point(sink, K, defines, rel, NEQUIP_E, NEQUIP_N, d, 4, 0,
                   required=True)


def _bag_point(sink, K, defines, path, t, n_bags, v, d, elem, align,
               required=False):
    sym = (f"embedding_bag(T={t},B={n_bags},V={v},D={d},elem={elem},"
           f"align={align})")
    try:
        p = _plan_fn(K)(t, n_bags, v, d, elem, align)
    except ValueError as exc:
        if required:
            sink.add("KC101", "embedding_bag", sym,
                     f"plan refuses a shape the port's paths run: "
                     f"{exc!r}", path)
        return None
    except Exception as exc:                 # noqa: BLE001 (a crash)
        sink.add("KC101", "embedding_bag", sym, f"plan failed: {exc!r}", path)
        return None
    threads = defines.get("EB_THREADS", K.THREADS)
    max_k = defines.get("EB_MAX_K", K.MAX_K)
    groups = threads // p.gw if p.gw else 0
    _grid_ok(sink, "embedding_bag", sym, [(p.blocks, GRID_X_MAX)], path)
    if p.blocks * groups * p.k_bags < n_bags:
        sink.add("KC101", "embedding_bag", sym,
                 f"{p.blocks} blocks x {groups} groups x {p.k_bags} bags "
                 f"do not cover {n_bags} bags", path)
    ve = p.vec // elem if p.vec >= elem else 0
    if (p.gw not in (8, 16, 32) or p.lr & (p.lr - 1)
            or not 1 <= p.lr <= p.gw or p.vec < elem or (d * elem) % p.vec
            or align % p.vec or not 1 <= p.k_bags <= max_k
            or (d > 1 and p.lr * ve < min(d, 32 * ve))):
        sink.add("KC102", "embedding_bag", sym,
                 f"granules gw={p.gw} lr={p.lr} vec={p.vec} k={p.k_bags}: "
                 f"lr a power of two <= gw, vec dividing the row "
                 f"({d * elem} B) and the alignment ({align}), k <= "
                 f"EB_MAX_K {max_k}", path)
    max_bags = defines.get("EB_MAX_BAGS", threads // 8 * max_k)
    if groups * p.k_bags > max_bags:
        sink.add("KC103", "embedding_bag", sym,
                 f"a block's {groups * p.k_bags} bags overrun the static "
                 f"s_start[EB_MAX_BAGS + 1] ({max_bags})", path)
    for name, x in (("ids", t), ("bags", n_bags + 1), ("D", d)):
        if x > INT_MAX:
            sink.add("KC103", "embedding_bag", sym,
                     f"{name} reach {x}, past the source's int", path)
    return p


def _check_embedding_bag(sink, kernels_root, fast):
    path = _source_path(kernels_root, "embedding_bag")
    src = _read(path)
    if src is None:
        return
    rel = _repo_rel(kernels_root, path)
    K = _kernel_module("embedding_bag")
    defines = parse_defines(src)
    ts = (0, 16, 4096) if fast else (0, 1, 16, 4096, 1 << 20)
    bs = (1, 512) if fast else (1, 4, 512, 100_000, 1 << 20)
    ds = (1, 32) if fast else (1, 2, 8, 32, 64, 100, 1024)
    for t, nb, d, elem in itertools.product(ts, bs, ds, (4, 2)):
        for align in ((0,) if fast else (0, 4, 8) if elem == 4
                      else (0, 2, 4, 8)):
            _bag_point(sink, K, defines, rel, t, nb, 4096, d, elem, align)
    for batch, (v, d), elem in itertools.product(WD_BATCHES, WD_TABLES,
                                                 (4, 2)):
        _bag_point(sink, K, defines, rel, WD_IDS_PER_BAG * batch, batch, v,
                   d, elem, 0, required=True)


def check_tiles_and_bounds(fast: bool = False, *,
                           kernels_root: str | None = None
                           ) -> list[Finding]:
    """KC101/KC102/KC103 over the lattice for the three launch plans."""
    kernels_root = _kernels_root(kernels_root)
    sink = _Sink()
    _check_compat(sink, kernels_root, fast)
    _check_segment_sum(sink, kernels_root, fast)
    _check_embedding_bag(sink, kernels_root, fast)
    return sink.findings


# --------------------------------------------------------------------- #
# KC104: the pair cursor
# --------------------------------------------------------------------- #
_CLAMP_RE = r"min\(\s*run\[r\]\s*\+\s*counts\[i\]\s*,\s*max_new\s*\)"
_DROPPED_RE = (r"n_dropped\[s\]\s*=\s*utot\s*>\s*\(uint32_t\)max_new\s*\?"
               r"\s*\(int32_t\)\(utot\s*-\s*\(uint32_t\)max_new\)\s*:\s*0")
_BOUND_RE = r"ca\s*\*\s*cb\s*-\s*P\[P_MAX_NEW\]\s*>=\s*\(1LL\s*<<\s*31\)"
_CURSOR_RE = r"P\[P_MAX_NEW\]\s*>\s*\(1LL\s*<<\s*31\)\s*-\s*tb"


def _cursor_extremes(ca, cb, tb, max_new):
    """The emit loop's writes at the cursor's extremes: a cell (A row,
    B tile) with exclusive offset ``base`` (its run; the emit visits
    only cells with ``(uint32)base < max_new``) and ``n`` matches writes
    at ``run + k`` for ``k`` below ``min(run + n, max_new) - run``.
    Returns the violations as (base, n, what)."""
    bad = []
    total = ca * cb
    for base in {0, max(0, max_new - 1), max_new, max_new + 1, total}:
        if not base < max_new or base > total:
            continue                       # the emit never visits it
        for n in {0, 1, min(tb, total - base)}:
            s = base + n                   # int in the source
            if s > INT_MAX:
                bad.append((base, n, f"run + count = {s} overflows int"))
                continue
            end = min(s, max_new)
            if end > base and end - 1 >= max_new:
                bad.append((base, n, f"write at {end - 1} >= max_new"))
    if total - max_new >= 2 ** 31 or total >= 2 ** 32:
        bad.append((total, 0, "the total does not read back exactly as "
                              "uint32 with n_dropped an int32"))
    return bad


def check_smem_cursor(fast: bool = False, *,
                      kernels_root: str | None = None) -> list[Finding]:
    """Prove the pair kernels' emit never writes at or beyond
    ``max_new`` and that their counters do not overflow, for every
    cursor value the grid can produce."""
    kernels_root = _kernels_root(kernels_root)
    path = _source_path(kernels_root, "compat_join")
    src = _read(path)
    if src is None:
        return []
    rel = _repo_rel(kernels_root, path)
    K = _kernel_module("compat_join")
    findings: list[Finding] = []
    for pattern, what, sym in (
            (_CLAMP_RE, "the emit clamp `min(run[r] + counts[i], max_new)`",
             "compat_join.cj_emit"),
            (_DROPPED_RE, "the unsigned n_dropped `utot > (uint32_t)max_new "
                          "? (int32_t)(utot - (uint32_t)max_new) : 0`",
             "compat_join.cj_scan"),
            (_BOUND_RE, "the launch's check `ca * cb - P[P_MAX_NEW] >= "
                        "(1LL << 31)`", "compat_join.make_args"),
            (_CURSOR_RE, "the launch's check `P[P_MAX_NEW] > (1LL << 31) "
                         "- tb`", "compat_join.make_args")):
        if not re.search(pattern, src):
            findings.append(_finding(
                "KC104", ERROR, sym,
                f"{what} not found in the source — the pair cursor bound "
                f"proof no longer applies", rel))
    if findings:
        return findings
    plan = _plan_fn(K)
    shared = (True,) * 6

    def refuses(ca, cb, max_new):
        try:
            plan(K.PAIRS, 1, ca, cb, 2, 2, 1, 1, shared, False, max_new)
        except ValueError:
            return True
        return False

    # the plan's bound at its edge (CA·CB - max_new = 2^31 refused,
    # 2^31 - 1 taken), at the factorings the port's paths use
    for ca, cb, max_new, refused in (
            (32_768, 65_536, 0, True), (32_768, 65_536, 1, False),
            (65_536, 32_768, PATH_MAX_NEW, False),
            (8_192, 262_145, PATH_MAX_NEW, True),
            (8_192, 262_145, PATH_MAX_NEW + 1, False)):
        if refuses(ca, cb, max_new) != refused:
            findings.append(_finding(
                "KC104", ERROR,
                f"compat_join_pairs(ca={ca},cb={cb},max_new={max_new})",
                f"plan {'takes' if refused else 'refuses'} a join whose "
                f"pair total less max_new is {ca * cb - max_new} "
                f"(the int32 n_dropped's bound is 2^31 - 1)", rel))
    caps = CAPS_FAST if fast else CAPS_FULL
    points = [(ca, cb, m) for ca, cb in itertools.product(caps, caps)
              for m in MAX_NEW]
    points += [(ca, cb, PATH_MAX_NEW) for _w, _s, ca, cb, _f in _path_joins()]
    # the plan's own extremes: the largest max_new it may take, against
    # a table whose pair total reaches past 2^31
    points += [(ca, cb, m) for ca, cb in ((65_536, 49_152), (INT_MAX, 1))
               for m in (INT_MAX, INT_MAX - 1024, 2 ** 30)]
    for ca, cb, max_new in points:
        try:
            p = plan(K.PAIRS, 1, ca, cb, 2, 2, 1, 1, shared, True, max_new)
        except ValueError:
            continue
        for base, n, what in _cursor_extremes(ca, cb, p.tb, max_new)[:1]:
            findings.append(_finding(
                "KC104", ERROR,
                f"compat_join_pairs(ca={ca},cb={cb},max_new={max_new})",
                f"cursor base={base} count={n}: {what}", rel))
    return findings


# --------------------------------------------------------------------- #
# KC105: each wrapper's outputs against its plain version
# --------------------------------------------------------------------- #
def _tree_sig(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_sig(x) for x in tree)
    return (tuple(tree.shape), str(tree.dtype))


def _compat_args(torch, rng, n_slots, ca, cb, device):
    """Join operands: A slot-stacked, B shared, window per slot."""
    def t(shape, hi):
        return torch.as_tensor(rng.integers(0, hi, shape, dtype=np.int32),
                               device=device)

    a = (t((n_slots, ca, 2), 6), t((n_slots, ca, 2), 40),
         torch.as_tensor(rng.random((n_slots, ca)) < 0.8, device=device))
    b = (t((cb, 1), 6), t((cb, 1), 40),
         torch.as_tensor(rng.random(cb) < 0.8, device=device))
    w = torch.as_tensor(rng.integers(5, 30, n_slots, dtype=np.int32),
                        device=device)
    return a, b, w


def check_kernel_ref_agreement(fast: bool = False, *, device="meta",
                               seed: int = 0) -> list[Finding]:
    """KC105.  On ``device="meta"``: the output tree each launch wrapper
    allocates (``kernel.*_outputs``, the allocation the ``*_cuda``
    wrappers make) against its plain version's, both on meta tensors.
    On a CUDA device: one real call of each ``*_cuda`` wrapper against
    its plain version on the same seeded inputs — equal trees, and
    equal values (integer-valued sums add exactly)."""
    import torch

    from repro_torch.kernels.compat_join import kernel as cj_k
    from repro_torch.kernels.compat_join import ref as cj_ref
    from repro_torch.kernels.embedding_bag import kernel as eb_k
    from repro_torch.kernels.embedding_bag import ref as eb_ref
    from repro_torch.kernels.segment_reduce import kernel as sr_k
    from repro_torch.kernels.segment_reduce import ref as sr_ref

    dev = torch.device(device)
    real = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    findings: list[Finding] = []

    def compare(sym, got_fn, want_fn):
        try:
            got = got_fn()
        except Exception as exc:                       # a failed route
            findings.append(_finding(
                "KC105", ERROR, sym,
                f"the kernel route failed: {exc!r}"))
            return
        want = want_fn()
        if _tree_sig(got) != _tree_sig(want):
            findings.append(_finding(
                "KC105", ERROR, sym,
                f"kernel/plain signature mismatch: {_tree_sig(got)} != "
                f"{_tree_sig(want)}"))
        elif real and not all(
                torch.equal(g, w) for g, w in zip(
                    got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,))):
            findings.append(_finding(
                "KC105", ERROR, sym, "kernel/plain values differ"))

    rel = np.zeros((2, 1), bool)
    rel[0, 0] = True
    trel = np.zeros((2, 1), np.int8)
    trel[-1, 0] = -1
    points = [(8, 8), (64, 128), NON_POW2]
    if not fast:
        points += [(256, 256), (1024, 512)]
    max_new = 256
    for n_slots in (SLOTS[:2] if fast else SLOTS):
        for ca, cb in points:
            a, b, w = _compat_args(torch, rng, n_slots, ca, cb, dev)
            sym = f"compat_join_pairs(S={n_slots},ca={ca},cb={cb})"
            compare(sym,
                    (lambda: cj_k.compat_join_pairs_cuda(
                        *a, *b, rel, trel, max_new, w, n_slots)) if real
                    else (lambda: cj_k.pairs_outputs(
                        n_slots, max_new, dev)[2]),
                    lambda: cj_ref.compat_join_pairs(
                        *a, *b, rel, trel, max_new, w))
            sym = f"compat_mask(S={n_slots},ca={ca},cb={cb})"
            compare(sym,
                    (lambda: cj_k.compat_mask_cuda(
                        *a, *b, rel, trel, w, n_slots)) if real
                    else (lambda: cj_k.mask_output(n_slots, ca, cb, dev)),
                    lambda: cj_ref.compat_mask(*a, *b, rel, trel, w))

    e, n, d = (512, 256, 8) if fast else (2048, 1024, 64)
    for dtype in (torch.float32, torch.bfloat16):
        dst = torch.as_tensor(rng.integers(-1, n + 1, e, dtype=np.int32),
                              device=dev)
        msg = torch.as_tensor(rng.integers(-3, 4, (e, d)),
                              device=dev).to(dtype)
        compare(f"segment_sum(E={e},N={n},D={d},{dtype})",
                (lambda: sr_k.segment_sum_cuda(dst, msg, n)) if real
                else (lambda: sr_k.sum_output(msg, n)),
                lambda: sr_ref.segment_sum(dst, msg, n))

    t, v, nb, d = (16, 32, 4, 8) if fast else (128, 1024, 32, 64)
    for dtype in (torch.float32, torch.bfloat16):
        ids = torch.as_tensor(rng.integers(-1, v, t, dtype=np.int32),
                              device=dev)
        bags = torch.as_tensor(np.sort(rng.integers(0, nb, t)).astype(
            np.int32), device=dev)
        table = torch.as_tensor(rng.integers(-3, 4, (v, d)),
                                device=dev).to(dtype)
        compare(f"embedding_bag(T={t},V={v},B={nb},D={d},{dtype})",
                (lambda: eb_k.embedding_bag_cuda(ids, bags, table, nb))
                if real else (lambda: eb_k.bag_output(table, nb)),
                lambda: eb_ref.embedding_bag(ids, bags, table, nb))
    return findings


# --------------------------------------------------------------------- #
# The card's limits
# --------------------------------------------------------------------- #
def device_limits(device=0) -> dict:
    """The limits the proofs assume, read from a CUDA device: the shared
    memory a block may opt into and the SM count."""
    import torch
    props = torch.cuda.get_device_properties(device)
    return {"name": props.name,
            "smem_per_block_optin": int(props.shared_memory_per_block_optin),
            "sm_count": int(props.multi_processor_count)}


def check_device_limits(limits: dict) -> list[Finding]:
    """The kernels' constants against a card's limits: a block's shared
    memory (``SMEM_LIMIT``) and the grids sized by the SM count
    (``SORT_WAVE``, ``GRID_EDGES``, ``WAVE_BLOCKS``)."""
    cj = _kernel_module("compat_join")
    sr = _kernel_module("segment_reduce")
    eb = _kernel_module("embedding_bag")
    smem, sms = limits["smem_per_block_optin"], limits["sm_count"]
    findings = []
    for name, have in (("compat_join.SMEM_LIMIT", cj.SMEM_LIMIT),):
        if have != smem:
            findings.append(_finding(
                "KC103", ERROR, name,
                f"{name} = {have}, the card opts a block into {smem} "
                f"bytes"))
    for name, have, want in (
            ("segment_reduce.SORT_WAVE", sr.SORT_WAVE, 4 * sms),
            ("segment_reduce.GRID_EDGES", sr.GRID_EDGES, 16 * sms),
            ("embedding_bag.WAVE_BLOCKS", eb.WAVE_BLOCKS, 16 * sms)):
        if have != want:
            findings.append(_finding(
                "KC101", ERROR, name,
                f"{name} = {have}, sized for another card: {want} on "
                f"this one's {sms} SMs"))
    return findings


# --------------------------------------------------------------------- #
# Entry point
# --------------------------------------------------------------------- #
def check_kernels(kernels_root: str | None = None, fast: bool = False
                  ) -> tuple[list[Finding], dict]:
    kernels_root = _kernels_root(kernels_root)
    findings: list[Finding] = []
    sites = discover_launch_sites(kernels_root)
    for path, func, line in sites:
        if func not in MODELED_LAUNCHES:
            findings.append(Finding(
                pass_name="kernel", rule="KC100", severity=WARNING,
                path=path, line=line, symbol=func,
                message="launch function without a contract in "
                        "repro_torch.analysis.kernel_check — register it "
                        "in MODELED_LAUNCHES with its plan's proofs"))
    findings += check_source_contracts(kernels_root)
    findings += check_tiles_and_bounds(fast=fast, kernels_root=kernels_root)
    findings += check_smem_cursor(fast=fast, kernels_root=kernels_root)
    if any(n in MODELED_LAUNCHES for _p, n, _l in sites):
        findings += check_kernel_ref_agreement(fast=fast)
    stats = {"n_launch_sites": len(sites),
             "n_global_kernels": _count_globals(kernels_root)}
    return findings, stats
