"""AST lint pass: host-sync rules over the whole ``repro_torch`` package
(port of ``repro.analysis.astlint``).

The linter parses every module under ``src/repro_torch``, builds a
best-effort static call graph, and computes two reachability sets:

  * **model set** — functions reachable from :data:`MODEL_SEEDS`: the
    model entry points the engine calls once a step and the kernel entry
    points under them. This is the port's counterpart of the JAX lint's
    "traced" set (there is no ``jit`` here), and the code a CUDA graph of
    the decode step would capture: a host sync there stalls the step and
    breaks capture.
  * **step-loop** — host-side functions on the serving hot path,
    reachable from :data:`STEP_SEEDS` (``Engine.step`` and friends) but
    not in the model set.

Rules (waive with ``# analysis: ok(<rule>)`` on the offending line or
the enclosing ``def`` line):

  host-sync        host-sync calls (``.item()``, ``.tolist()``,
                   ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
                   ``int()`` / ``float()`` / ``bool()`` of a tensor
                   expression (best effort: an argument that calls a
                   ``torch`` function or a tensor reduction method),
                   ``torch.cuda.synchronize``, ``np.asarray`` /
                   ``np.array``, ``.nonzero()`` / ``torch.nonzero``)
                   inside a MODEL-SET function.                 [error]
  step-sync        the same calls inside the engine step loop, outside
                   the one read funnel ``Engine._device_read``: batch
                   them through it.                             [warn]
  sync-site        the same calls anywhere else: host-side OK,
                   reported for classification only.            [info]
  host-rng         Python ``random`` / ``np.random`` / ``time`` /
                   ``datetime`` inside a model-set function (the port
                   draws from explicit ``torch.Generator`` objects).
                                                                [error]
  mutable-default  mutable default argument values (list/dict/set
                   literals error; shared call results warn — waive
                   when the object is immutable).         [error|warn]
  allocator-free   raw ``allocator.free(...)`` of refcounted pages
                   outside ``kv_cache.py`` — route through
                   ``PageTable.release`` / ``decref``.          [error]

The JAX lint's ``jit-static-args`` rule has no counterpart: nothing in
the port is compiled against its arguments, so a str/bool literal
argument cannot force a recompile.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding

#: The model set's seeds, dotted qualnames: the entry points the engine
#: calls through bound methods behind attributes (which static
#: resolution cannot follow) and the kernels' public entry points.
MODEL_SEEDS: Tuple[str, ...] = (
    "repro_torch.models.model.Model.forward",
    "repro_torch.models.model.Model.prefill",
    "repro_torch.models.model.Model.decode",
    "repro_torch.models.model.Model.prefill_paged",
    "repro_torch.models.model.Model.decode_paged",
    "repro_torch.models.model.Model.verify_paged",
    "repro_torch.kernels.ops.vq_assign",
    "repro_torch.kernels.ops.lut_matmul",
    "repro_torch.kernels.ops.vq_amm",
    "repro_torch.kernels.flash_decode.flash_decode_paged",
    # the collectives a tensor-parallel rank calls inside the layer code
    "repro_torch.parallel.collectives.TP.all_reduce",
    "repro_torch.parallel.collectives.TP.all_gather",
    "repro_torch.parallel.collectives.TP.local",
    "repro_torch.parallel.collectives.TP.shard",
)

#: Host-side hot-loop seeds: the continuous engine's step machinery and
#: the per-round drafter hooks. Everything reachable from here runs once
#: per serving step; scattered device reads here are latency.
STEP_SEEDS: Tuple[str, ...] = (
    "repro_torch.serve.engine.Engine.step",
    "repro_torch.serve.engine.Engine.run_until_idle",
    "repro_torch.serve.engine.BatchToCompletionEngine._run_batch",
    "repro_torch.serve.speculative.ModelDrafter.propose",
    "repro_torch.serve.speculative.NgramDrafter.propose",
    "repro_torch.serve.router.ReplicaRouter.step",
    # a tensor-parallel engine's model calls: the engine's funnel and the
    # rank runner that fans them out
    "repro_torch.serve.engine.Engine._run",
    "repro_torch.parallel.collectives.RankRunner.run",
)

#: The step loop's one device -> host funnel: its reads are the counted
#: ones (``Engine.device_reads``), so they are not step-sync findings.
READ_FUNNEL: Tuple[str, ...] = (
    "repro_torch.serve.engine.Engine._device_read",
)

#: Repo-relative path prefixes whose functions are declared sync-free:
#: instrumentation that records host scalars and by construction never
#: touches a device value (as ``SYNC_FREE_PATHS`` of the JAX lint).
SYNC_FREE_PATHS = ("src/repro_torch/obs",)

_WAIVER_RE = re.compile(r"#\s*analysis:\s*ok\(([^)]*)\)")

# calls whose function-valued arguments run in the caller's context
_COMBINATORS = {
    "functools.partial", "partial", "checkpoint",
    "torch.utils.checkpoint.checkpoint",
}

# tensor methods whose result, passed to int() / float() / bool(), is a
# device value (best effort)
_TENSOR_METHODS = {"item", "sum", "any", "all", "max", "min", "argmax",
                   "argmin", "mean", "norm", "prod", "count_nonzero",
                   "amax", "amin", "abs"}
_HOST_MODULES = ("numpy", "math", "builtins", "statistics")


@dataclasses.dataclass
class FunctionInfo:
    """One function in the static call graph."""
    qualname: str            # dotted: repro_torch.serve.engine.Engine.step
    module: str
    path: str                # repo-relative
    node: ast.AST            # FunctionDef / Lambda
    lineno: int
    cls: Optional[str]       # enclosing class simple name, if any
    calls: List[tuple] = dataclasses.field(default_factory=list)


class _ModuleIndex:
    """Per-module symbol tables built in one AST pass."""

    def __init__(self, module: str, path: str, tree: ast.Module,
                 source: str, is_package: bool = False):
        self.module = module
        self.path = path
        self.tree = tree
        self.is_package = is_package
        self.imports: Dict[str, str] = {}       # alias -> module dotted
        self.from_imports: Dict[str, str] = {}  # name -> module.name
        self.functions: Dict[str, FunctionInfo] = {}   # qualname -> info
        self.classes: Set[str] = set()          # class qualnames
        # (class simple name, attr) -> the call that built self.<attr>
        self.attr_ctors: Dict[Tuple[str, str], tuple] = {}
        self.waivers: Dict[int, Set[str]] = {}  # line -> waived rules
        for i, ln in enumerate(source.splitlines(), start=1):
            m = _WAIVER_RE.search(ln)
            if m:
                self.waivers[i] = {r.strip() for r in m.group(1).split(",")
                                   if r.strip()}
        self._collect()

    @staticmethod
    def dotted(node: ast.AST) -> Optional[str]:
        """'a.b.c' for nested Name/Attribute chains, else None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return None

    def module_of(self, head: str) -> str:
        """The module an expression's leading name stands for (itself
        when it names no import)."""
        return self.imports.get(head, self.from_imports.get(head, head))

    def _collect(self) -> None:
        for node in self.tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._add_import(node)
        self._walk_scope(self.tree.body, prefix=self.module, cls=None)

    def _add_import(self, node) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    self.imports[a.asname] = a.name
                else:
                    head = a.name.split(".")[0]
                    self.imports[head] = head
            return
        mod = node.module or ""
        if node.level:               # relative: resolve against this module
            parts = self.module.split(".")
            keep = len(parts) - node.level + (1 if self.is_package else 0)
            mod = ".".join(parts[:keep] + ([mod] if mod else []))
        for a in node.names:
            self.from_imports[a.asname or a.name] = f"{mod}.{a.name}"

    def _walk_scope(self, body, prefix: str, cls: Optional[str]) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                self.classes.add(f"{prefix}.{node.name}")
                self._walk_scope(node.body, f"{prefix}.{node.name}",
                                 cls=node.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(node, prefix, cls)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                self._add_import(node)

    def _add_function(self, node, prefix: str, cls: Optional[str]) -> None:
        qn = f"{prefix}.{node.name}"
        info = FunctionInfo(qualname=qn, module=self.module, path=self.path,
                            node=node, lineno=node.lineno, cls=cls)
        self.functions[qn] = info
        for stmt in _body_statements(node):
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                self._scan_calls(stmt, info)
                if cls is not None:
                    self._note_attr_ctor(stmt, cls)
        # nested defs get their own entries (reachable via call edges)
        for sub in _body_statements(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(sub, qn, cls)
            elif isinstance(sub, ast.ClassDef):
                self._walk_scope(sub.body, f"{qn}.{sub.name}", sub.name)

    def _note_attr_ctor(self, stmt: ast.AST, cls: str) -> None:
        """``self.<attr> = Ctor(...)``: remember the constructor, so that
        ``self.<attr>.<method>(...)`` resolves to ``Ctor.<method>``."""
        if not (isinstance(stmt, ast.Assign)
                and isinstance(stmt.value, ast.Call)):
            return
        f = stmt.value.func
        if isinstance(f, ast.Name):
            ctor = ("name", f.id)
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            ctor = ("mod", f.value.id, f.attr)
        else:
            return
        for tgt in stmt.targets:
            if isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
                self.attr_ctors.setdefault((cls, tgt.attr), ctor)

    def _scan_calls(self, root: ast.AST, info: FunctionInfo) -> None:
        """Record call edges inside one statement/expression subtree
        (without descending into nested def/class bodies)."""
        for node in _walk_no_defs(root):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name):
                info.calls.append(("name", f.id))
            elif isinstance(f, ast.Attribute):
                v = f.value
                if isinstance(v, ast.Name) and v.id in ("self", "cls"):
                    info.calls.append(("self", f.attr))
                elif isinstance(v, ast.Name):
                    info.calls.append(("mod", v.id, f.attr))
                elif isinstance(v, ast.Attribute) and \
                        isinstance(v.value, ast.Name) and \
                        v.value.id == "self":
                    info.calls.append(("attr", v.attr, f.attr))
            if self.dotted(f) in _COMBINATORS:  # fn-valued args are edges
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        info.calls.append(("name", arg.id))
                    elif isinstance(arg, ast.Attribute) and \
                            isinstance(arg.value, ast.Name) and \
                            arg.value.id in ("self", "cls"):
                        info.calls.append(("self", arg.attr))


def _body_statements(node):
    if isinstance(node, ast.Lambda):
        return []
    return node.body


def _walk_no_defs(root: ast.AST):
    """ast.walk that does not descend into nested function/class bodies
    (lambdas ARE descended: they run in the caller's context)."""
    stack = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            stack.append(child)


# ---------------------------------------------------------------------------
# package loading + call-graph resolution
# ---------------------------------------------------------------------------

class PackageGraph:
    """All modules of a package + resolved reachability sets."""

    def __init__(self, indexes: Sequence[_ModuleIndex]):
        self.modules = {ix.module: ix for ix in indexes}
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Set[str] = set()
        for ix in indexes:
            self.functions.update(ix.functions)
            self.classes |= ix.classes
        # method name -> qualnames, per class simple name (self-call edges)
        self._methods: Dict[Tuple[str, str], List[str]] = {}
        for qn, fn in self.functions.items():
            if fn.cls is not None:
                self._methods.setdefault(
                    (fn.cls, qn.rsplit(".", 1)[-1]), []).append(qn)
        self.model_set = self._reach(self._seed_qualnames(MODEL_SEEDS))
        self.step_loop = self._reach(self._seed_qualnames(STEP_SEEDS)) \
            - self.model_set

    def _seed_qualnames(self, seeds) -> Set[str]:
        return {s for s in seeds if s in self.functions}

    def _resolve(self, fn: FunctionInfo, call: tuple) -> List[str]:
        ix = self.modules[fn.module]
        kind = call[0]
        if kind == "name":
            name = call[1]
            # nested def in the same enclosing function first
            nested = f"{fn.qualname}.{name}"
            if nested in self.functions:
                return [nested]
            local = f"{fn.module}.{name}"
            if local in self.functions:
                return [local]
            tgt = ix.from_imports.get(name)
            if tgt and tgt in self.functions:
                return [tgt]
            return []
        if kind == "self":
            return self._methods.get((fn.cls, call[1]), []) \
                if fn.cls else []
        if kind == "mod":
            mod = ix.imports.get(call[1]) or ix.from_imports.get(call[1])
            if mod:
                tgt = f"{mod}.{call[2]}"
                return [tgt] if tgt in self.functions else []
        if kind == "attr" and fn.cls is not None:
            ctor = ix.attr_ctors.get((fn.cls, call[1]))
            cls = self._resolve_class(ix, ctor) if ctor else None
            if cls is not None and f"{cls}.{call[2]}" in self.functions:
                return [f"{cls}.{call[2]}"]
        return []

    def _resolve_class(self, ix: "_ModuleIndex", ctor: tuple
                       ) -> Optional[str]:
        if ctor[0] == "name":
            for qn in (f"{ix.module}.{ctor[1]}",
                       ix.from_imports.get(ctor[1], "")):
                if qn in self.classes:
                    return qn
            return None
        mod = ix.imports.get(ctor[1]) or ix.from_imports.get(ctor[1])
        qn = f"{mod}.{ctor[2]}" if mod else ""
        return qn if qn in self.classes else None

    def _reach(self, roots: Set[str]) -> Set[str]:
        seen = set(roots)
        frontier = list(roots)
        while frontier:
            fn = self.functions.get(frontier.pop())
            if fn is None:
                continue
            for call in fn.calls:
                for tgt in self._resolve(fn, call):
                    if tgt not in seen:
                        seen.add(tgt)
                        frontier.append(tgt)
        return seen


def load_package(root: str, package: str = "repro_torch") -> PackageGraph:
    """Parse every ``*.py`` under ``root``.

    ``root`` may be the package dir itself (``src/repro_torch``) or its
    parent source root (``src``): both yield ``repro_torch.*`` module
    names."""
    root = os.path.abspath(root)
    if os.path.isdir(os.path.join(root, package)):  # src -> src/repro_torch
        root = os.path.join(root, package)
    indexes = []
    repo = os.path.dirname(os.path.dirname(root))   # src/pkg -> repo
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root)
            parts = [package] + rel[:-3].split(os.sep)
            is_package = parts[-1] == "__init__"
            if is_package:
                parts = parts[:-1]
            with open(path, encoding="utf-8") as f:
                source = f.read()
            indexes.append(_ModuleIndex(
                ".".join(parts),
                os.path.relpath(path, repo).replace(os.sep, "/"),
                ast.parse(source, filename=path), source, is_package))
    return PackageGraph(indexes)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def _is_tensor_expr(ix: _ModuleIndex, node: ast.AST) -> bool:
    """Best effort: does ``node`` compute a tensor? True when it calls a
    ``torch`` function or a tensor reduction method on something that is
    not a host module (``np.max(...)`` is host)."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        d = ix.dotted(sub.func)
        if d is not None and \
                ix.module_of(d.split(".")[0]).split(".")[0] == "torch":
            return True
        f = sub.func
        if isinstance(f, ast.Attribute) and f.attr in _TENSOR_METHODS:
            recv = ix.dotted(f.value)
            if recv is None or \
                    ix.module_of(recv.split(".")[0]) not in _HOST_MODULES:
                return True
    return False


def _sync_kind(ix: _ModuleIndex, node: ast.Call) -> Optional[str]:
    """Classify one call as a host-sync form, or None."""
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in ("item", "tolist", "cpu", "numpy", "nonzero") and \
                not node.args and not node.keywords:
            return f.attr
        if f.attr == "to" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                node.args[0].value == "cpu":
            return "to_cpu"
        d = ix.dotted(f)
        if d is None:
            return None
        mod = ix.module_of(d.split(".")[0])
        if mod == "torch" and d.endswith("cuda.synchronize"):
            return "cuda.synchronize"
        if mod == "torch" and f.attr == "nonzero":
            return "nonzero"
        if f.attr in ("asarray", "array") and mod == "numpy":
            return "np.asarray"
        return None
    if isinstance(f, ast.Name):
        if f.id in ("int", "float", "bool") and len(node.args) == 1 and \
                _is_tensor_expr(ix, node.args[0]):
            return f"{f.id}()"
        if f.id == "synchronize" and \
                ix.from_imports.get("synchronize", "").startswith("torch"):
            return "cuda.synchronize"
    return None


def _rng_kind(ix: _ModuleIndex, node: ast.Call) -> Optional[str]:
    d = ix.dotted(node.func)
    if d is None:
        return None
    parts = d.split(".")
    mod = ix.module_of(parts[0])
    if mod == "random" or mod.startswith("random."):
        return d
    if mod == "numpy" and len(parts) >= 3 and parts[1] == "random":
        return d
    if mod == "time" and parts[-1] in ("time", "perf_counter", "monotonic",
                                       "sleep"):
        return d
    if mod.startswith("datetime") and parts[-1] in ("now", "utcnow",
                                                    "today"):
        return d
    return None


def _waived(ix: _ModuleIndex, rule: str, line: int, def_line: int) -> bool:
    return any(rule in ix.waivers.get(ln, set()) for ln in (line, def_line))


def _calls_in_body(fn: FunctionInfo) -> List[ast.Call]:
    nodes = []
    for stmt in _body_statements(fn.node):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        nodes.extend(n for n in _walk_no_defs(stmt)
                     if isinstance(n, ast.Call))
    return sorted(nodes, key=lambda n: (n.lineno, n.col_offset))


def _function_findings(graph: PackageGraph) -> List[Finding]:
    out: List[Finding] = []
    for qn, fn in sorted(graph.functions.items()):
        ix = graph.modules[fn.module]
        in_model = qn in graph.model_set
        in_step = qn in graph.step_loop and qn not in READ_FUNNEL \
            and not fn.path.startswith(SYNC_FREE_PATHS)
        symbol = qn[len(fn.module) + 1:] if qn.startswith(fn.module) else qn
        counters: Dict[str, int] = {}
        for node in _calls_in_body(fn):
            kind = _sync_kind(ix, node)
            if kind is not None:
                i = counters.setdefault(f"sync:{kind}", 0)
                counters[f"sync:{kind}"] += 1
                if in_model:
                    rule, sev = "host-sync", "error"
                    msg = (f"{kind} in model-set {symbol}: a host sync "
                           f"inside a model entry point")
                    sugg = ("keep device values on the device inside the "
                            "model; read them after the entry point "
                            "returns, through Engine._device_read")
                elif in_step:
                    rule, sev = "step-sync", "warn"
                    msg = (f"{kind} in engine step loop ({symbol}): "
                           f"scattered per-step device read")
                    sugg = ("batch per-step reads into the one "
                            "Engine._device_read(...) of the step")
                else:
                    rule, sev = "sync-site", "info"
                    msg = f"{kind} in {symbol}: host-side OK"
                    sugg = ""
                if not _waived(ix, rule, node.lineno, fn.lineno):
                    out.append(Finding(rule, fn.path, node.lineno, symbol,
                                       f"{kind}#{i}", msg, sev, sugg))
            rng = _rng_kind(ix, node) if in_model else None
            if rng is not None:
                i = counters.setdefault(f"rng:{rng}", 0)
                counters[f"rng:{rng}"] += 1
                if not _waived(ix, "host-rng", node.lineno, fn.lineno):
                    out.append(Finding(
                        "host-rng", fn.path, node.lineno, symbol,
                        f"{rng}#{i}",
                        f"host {rng} in model-set {symbol}: a host "
                        f"random draw or clock read inside a model entry "
                        f"point", "error",
                        "draw from an explicit torch.Generator / pass "
                        "times in as arguments"))
        out.extend(_mutable_default_findings(ix, fn, symbol))
        out.extend(_allocator_findings(ix, fn, symbol))
    return out


def _mutable_default_findings(ix, fn, symbol) -> List[Finding]:
    node = fn.node
    if isinstance(node, ast.Lambda) or not hasattr(node, "args"):
        return []
    out = []
    defaults = list(node.args.defaults) + \
        [d for d in node.args.kw_defaults if d is not None]
    for i, d in enumerate(defaults):
        if isinstance(d, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
            sev, msg = "error", "mutable default argument (shared across " \
                "calls)"
        elif isinstance(d, ast.Call):
            callee = ix.dotted(d.func) or "<call>"
            if callee in ("tuple", "frozenset"):
                continue
            sev = "warn"
            msg = (f"call default `{callee}(...)` evaluated once at def "
                   f"time and shared across calls")
        else:
            continue
        if _waived(ix, "mutable-default", d.lineno, fn.lineno):
            continue
        out.append(Finding(
            "mutable-default", fn.path, d.lineno, symbol, f"default#{i}",
            f"{msg} in {symbol}", sev,
            "default to None and construct in the body (or waive if the "
            "shared object is immutable)"))
    return out


def _allocator_findings(ix, fn, symbol) -> List[Finding]:
    if os.path.basename(fn.path) == "kv_cache.py":
        return []          # the allocator's own module manages refcounts
    out = []
    counters: Dict[str, int] = {}
    for node in _calls_in_body(fn):
        if not isinstance(node.func, ast.Attribute) or \
                node.func.attr not in ("free", "restore"):
            continue
        recv = ix.dotted(node.func.value) or ""
        leaf = recv.split(".")[-1] if recv else ""
        if leaf not in ("allocator", "alloc"):
            continue
        key = f"{leaf}.{node.func.attr}"
        i = counters.setdefault(key, 0)
        counters[key] += 1
        if _waived(ix, "allocator-free", node.lineno, fn.lineno):
            continue
        out.append(Finding(
            "allocator-free", fn.path, node.lineno, symbol, f"{key}#{i}",
            f"raw {key}(...) in {symbol}: pages may be refcounted / "
            f"prefix-shared — bypassing the page-table release path "
            f"corrupts shared pages", "error",
            "release through PageTable.release/trim (or decref and let "
            "the owner decide free-list vs prefix LRU)"))
    return out


def run_ast_lint(src_root: str) -> Tuple[List[Finding], PackageGraph]:
    """Lint the package rooted at ``src_root`` (``.../src/repro_torch``
    or ``.../src``).

    Returns (findings, graph). Gating findings are error/warn; ``info``
    findings classify the remaining host-side-OK sync sites."""
    graph = load_package(src_root)
    return _function_findings(graph), graph
