"""Repo-specific AST lint over ``src/repro_torch`` (counterpart of
``repro.analysis.lint``): the reference's four rules, under the same ids,
with their torch meaning.

* **RT001**: no direct ``time.time()`` / ``time.sleep()`` /
  ``time.monotonic()`` / ``time.perf_counter()`` call under ``serve/``.
  The runtime's determinism (deadline tests, breaker cooldowns, fault
  schedules) rests on every clock read going through an injectable
  ``clock=`` / ``sleep=`` parameter.  A reference as a default
  (``clock=time.perf_counter``) is the injection pattern and stays legal.
* **TR001**: no host sync and no Python branch on a positional parameter
  inside ``*_batch`` functions and ``kernels/``.  Positional parameters
  without a default are device tensors by the serving ABI.  Host syncs:
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, and
  ``float/int/bool(param)`` (in JAX these raise on a tracer; in torch
  they sync silently).  Reads of ``shape``, ``ndim``, ``dtype``,
  ``device`` and ``is_cuda``, and the calls ``size()``, ``dim()`` and
  ``numel()``, are static.  Static knobs ride keyword-only or defaulted
  parameters, which the rule ignores.
* **FJ001**: fault sites only through the ``repro_torch.serve.faults``
  hooks (``faults.fire`` / ``faults.poison``), only in
  ``serve/retrieval.py`` and ``serve/sharded.py``, and never in a function
  whose name contains ``reference`` (the degradation ladder's last rung
  stays fault-free).  ``FaultInjectedError`` is raised only in
  ``serve/faults.py``.
* **JX001**: no CUDA work at import time.  At module scope, no call of a
  ``torch.cuda`` function other than ``is_available`` and
  ``device_count``, of ``.cuda()``, of anything with ``device="cuda"``, or
  of the kernel build (``kernels/_build``'s ``build()`` or ``library()``).
  The tests import every module on machines without a card.

Violations may be suppressed by ``allowlist.json`` next to this module, a
JSON map of rule id to ``path`` or ``path:qualname`` entries; keep it
narrow (the README gives each entry's reason).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import pathlib

_ALLOWLIST_FILE = pathlib.Path(__file__).with_name("allowlist.json")

_TIME_CALLS = {"time", "sleep", "monotonic", "perf_counter"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
_STATIC_CALLS = {"size", "dim", "numel"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_CAST_BUILTINS = {"float", "int", "bool"}
_FAULT_HOOKS = {"fire", "poison"}
_CUDA_IMPORT_SAFE = {"is_available", "device_count"}
_BUILD_CALLS = {"build", "library"}


@dataclasses.dataclass(frozen=True)
class LintViolation:
    rule: str
    path: str                # posix path relative to the linted root
    line: int
    qualname: str            # enclosing function ("<module>" at top level)
    message: str
    fixit: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"


FIXITS = {
    "RT001": (
        "take the clock as an injectable parameter (clock=time.perf_counter / "
        "sleep=time.sleep defaults, as ServeRuntime does) and call that"
    ),
    "TR001": (
        "keep the branch on the device (torch.where on the tensor), or move the "
        "static knob to a keyword-only parameter; read sizes through .shape"
    ),
    "FJ001": (
        "instrument the site with faults.fire()/faults.poison() from "
        "repro_torch.serve.faults inside the batched serving path only; the "
        "reference path must stay the fault-free degradation target"
    ),
    "JX001": (
        "do the CUDA work lazily: move the call into the function that needs "
        "it, so importing the module needs no card"
    ),
}


def _load_allowlist(path: pathlib.Path = _ALLOWLIST_FILE) -> dict:
    if not path.exists():
        return {}
    return json.loads(path.read_text())


def _is_torch_cuda(node: ast.AST) -> bool:
    """True for the expression ``torch.cuda``."""
    return isinstance(node, ast.Attribute) and node.attr == "cuda" and \
        isinstance(node.value, ast.Name) and node.value.id == "torch"


def _cuda_device_kw(call: ast.Call) -> bool:
    """True when a call passes ``device="cuda..."`` or
    ``device=torch.device("cuda...")``."""
    for kw in call.keywords:
        if kw.arg != "device":
            continue
        v = kw.value
        if isinstance(v, ast.Call) and v.args:
            v = v.args[0]
        if isinstance(v, ast.Constant) and isinstance(v.value, str) and \
                v.value.startswith("cuda"):
            return True
    return False


class _FileLinter(ast.NodeVisitor):
    """One pass over one file; rules share the qualname/scope bookkeeping."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        self.out: list[LintViolation] = []
        self._scope: list[str] = []
        self._build_names: set[str] = set()
        self.in_serve = "serve/" in path
        self.in_kernels = "kernels/" in path
        self.is_faults_mod = path.endswith("serve/faults.py")

    # -- bookkeeping ---------------------------------------------------------

    @property
    def qualname(self) -> str:
        return ".".join(self._scope) if self._scope else "<module>"

    def flag(self, rule: str, node: ast.AST, message: str) -> None:
        self.out.append(LintViolation(
            rule=rule, path=self.path, line=node.lineno,
            qualname=self.qualname, message=message, fixit=FIXITS[rule],
        ))

    # -- CUDA work at import time (JX001) ------------------------------------

    def _scan_module_cuda(self) -> None:
        for node in self.tree.body:
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.split(".")[-1] == "_build":
                self._build_names |= {a.asname or a.name for a in node.names
                                      if a.name in _BUILD_CALLS}
        for stmt in self.tree.body:
            self._check_module_calls(stmt)

    def _cuda_work(self, call: ast.Call) -> str | None:
        f = call.func
        if isinstance(f, ast.Attribute):
            if _is_torch_cuda(f.value) and f.attr not in _CUDA_IMPORT_SAFE:
                return f"torch.cuda.{f.attr}()"
            if f.attr == "cuda":
                return ".cuda()"
            if f.attr in _BUILD_CALLS and isinstance(f.value, ast.Name) and \
                    f.value.id == "_build":
                return f"_build.{f.attr}()"
        if isinstance(f, ast.Name) and f.id in self._build_names:
            return f"the kernel build {f.id}()"
        if _cuda_device_kw(call):
            return 'a call with device="cuda"'
        return None

    def _check_module_calls(self, stmt: ast.stmt) -> None:
        # descend into module-level control flow, but not into defs/classes
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        stack = [stmt]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                                 ast.ClassDef)):
                continue
            if isinstance(node, ast.Call):
                what = self._cuda_work(node)
                if what is not None:
                    self.flag("JX001", node, f"{what} runs at module import time")
            stack.extend(ast.iter_child_nodes(node))

    # -- scoped rules --------------------------------------------------------

    def visit_FunctionDef(self, node):
        self._visit_func(node)

    def visit_AsyncFunctionDef(self, node):
        self._visit_func(node)

    def visit_ClassDef(self, node):
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    def _visit_func(self, node) -> None:
        self._scope.append(node.name)
        if self.in_kernels or node.name.endswith("_batch"):
            self._check_device_scope(node)
        if "reference" in node.name:
            self._check_reference_path(node)
        self.generic_visit(node)
        self._scope.pop()

    def visit_Call(self, node):
        # RT001: direct wall-clock calls in the serving layer
        f = node.func
        if self.in_serve and isinstance(f, ast.Attribute) and \
                f.attr in _TIME_CALLS and isinstance(f.value, ast.Name) and \
                f.value.id == "time":
            self.flag("RT001", node, (
                f"direct time.{f.attr}() call in serve/: the clock must be injectable"
            ))
        # FJ001: fault hooks outside the instrumented serving modules
        if self._is_fault_hook(node) and not self.is_faults_mod and \
                not self.path.endswith(("serve/retrieval.py", "serve/sharded.py")):
            self.flag("FJ001", node, (
                "fault site introduced outside the instrumented serving "
                "modules (serve/{retrieval,sharded}.py)"
            ))
        if isinstance(f, ast.Name) and f.id == "FaultInjectedError" and \
                not self.is_faults_mod:
            self.flag("FJ001", node, (
                "FaultInjectedError raised directly: an unregistered fault "
                "site bypassing the seeded schedules"
            ))
        self.generic_visit(node)

    @staticmethod
    def _is_fault_hook(node: ast.Call) -> bool:
        f = node.func
        return isinstance(f, ast.Attribute) and f.attr in _FAULT_HOOKS and \
            isinstance(f.value, ast.Name) and f.value.id == "faults"

    # -- TR001 helpers -------------------------------------------------------

    @staticmethod
    def _device_params(node) -> set:
        """Positional-no-default parameter names: device tensors by the
        serving ABI (static knobs are keyword-only or defaulted)."""
        args = node.args
        pos = list(args.posonlyargs) + list(args.args)
        n_default = len(args.defaults)
        tensors = pos[: len(pos) - n_default] if n_default else pos
        return {a.arg for a in tensors if a.arg not in ("self", "cls")}

    @staticmethod
    def _static_names(expr: ast.AST) -> set:
        """Names only reached through static reads (``x.shape``,
        ``x.size()``) inside ``expr``: reading those is no host sync."""
        static = set()
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Attribute) and isinstance(sub.value, ast.Name) and \
                    sub.attr in _STATIC_ATTRS | _STATIC_CALLS:
                static.add(sub.value.id)
        return static

    def _check_device_scope(self, node) -> None:
        params = self._device_params(node)
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                    sub is not node:
                # nested helpers' parameters shadow the outer names
                params = params - self._device_params(sub)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                f = sub.func
                if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
                    self.flag("TR001", sub, (
                        f".{f.attr}() host sync inside a batched/kernel scope"
                    ))
                elif isinstance(f, ast.Name) and f.id in _CAST_BUILTINS and \
                        sub.args and isinstance(sub.args[0], ast.Name) and \
                        sub.args[0].id in params:
                    self.flag("TR001", sub, (
                        f"{f.id}({sub.args[0].id}) forces a host sync on a device "
                        f"parameter"
                    ))
            tests = []
            if isinstance(sub, (ast.If, ast.While, ast.IfExp)):
                tests.append(sub.test)
            for test in tests:
                static_ok = self._static_names(test)
                for name in ast.walk(test):
                    if isinstance(name, ast.Name) and name.id in params and \
                            name.id not in static_ok and \
                            isinstance(name.ctx, ast.Load):
                        self.flag("TR001", test, (
                            f"Python branch on device parameter {name.id!r} "
                            f"inside a batched/kernel scope"
                        ))
                        break

    # -- FJ001: the reference path stays uninstrumented ----------------------

    def _check_reference_path(self, node) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and self._is_fault_hook(sub):
                self.flag("FJ001", sub, (
                    f"fault site inside reference-path function "
                    f"{node.name!r}: the degradation target must stay "
                    f"fault-free"
                ))


def lint_file(path: pathlib.Path, rel: str) -> list[LintViolation]:
    tree = ast.parse(path.read_text(), filename=str(path))
    linter = _FileLinter(rel, tree)
    linter._scan_module_cuda()
    linter.visit(tree)
    return linter.out


def _allowed(v: LintViolation, allowlist: dict) -> bool:
    entries = allowlist.get(v.rule, [])
    return v.path in entries or f"{v.path}:{v.qualname}" in entries


def lint_tree(root, allowlist: dict | None = None) -> tuple[list, dict]:
    """Lint every .py file under ``root``.  Returns (violations, stats)."""
    root = pathlib.Path(root)
    allowlist = _load_allowlist() if allowlist is None else allowlist
    violations, files = [], 0
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        files += 1
        rel = path.relative_to(root).as_posix()
        for v in lint_file(path, rel):
            if not _allowed(v, allowlist):
                violations.append(v)
    stats = {
        "files_scanned": files,
        "rules": sorted(FIXITS),
        "allowlisted": {r: len(v) for r, v in allowlist.items()},
    }
    return violations, stats
