"""repro-lint for the port: AST rules for this repo's conventions.

The port's counterpart of the JAX package's ``analysis/lint.py``.  Run
as ``python -m repro_torch.analysis.lint [paths] [--json out.json]``
(default paths: the port's package, its tests, their harness and
``chip_smoke.py``).  Exit status 1 when any unsuppressed finding
remains.  Rules:

* **REP001** — version-sensitive torch API outside
  ``repro_torch/compat.py``, the one place that absorbs PyTorch API
  churn.  The set is what the port uses and what moved or changed
  between releases it runs on:

  - ``torch.distributed.device_mesh`` and its ``init_device_mesh`` /
    ``DeviceMesh`` (moved out of ``torch.distributed._tensor`` in 2.2;
    ``DeviceMesh.get_group`` changed its signature since) — today only
    ``compat.make_mesh`` imports it;
  - private torch namespaces: an import from, or an attribute chain
    through, a ``torch`` path with a ``_``-prefixed part
    (``torch._C``, ``torch._neg_view``,
    ``torch.distributed._functional_collectives``): no stability promise
    from one release to the next;
  - the profiler's ``self_cuda_time_total`` / ``cuda_time_total``
    (renamed ``*_device_time_total`` in 2.4): read device time through a
    ``getattr`` fallback, as ``chip_smoke.profile_run`` does.

  Aliases are followed (``import torch.distributed as dist`` makes
  ``dist._x`` a private chain).
* **REP002** — ``time.perf_counter()`` / ``time.monotonic()`` calls in
  code without an injectable timer: the enclosing function (or the
  enclosing class's ``__init__``) must take a ``timer`` parameter, the
  repo's hermetic-timing convention (``StepWatchdog``, ``PlanWarmer``,
  the tuner's measurement loop are the pattern).  ``time.time()`` is
  not flagged — it stamps wall-clock timestamps (wisdom ``ts``), not
  measured durations.
* **REP003** — wisdom/tuning file writes (``open(..., "w"/"a")``,
  ``os.replace``) outside ``core/plan.py``: only ``TuningCache._save``
  holds the fcntl lock and does the read-merge-rename dance; any other
  writer can tear or clobber the shared file.
* **REP004** — module-level cache dicts (name matching CACHE/MEMO)
  with no visible eviction (``.popitem``, ``del NAME[...]``) in the
  module: long-running serving processes must not grow caches without
  bound.

The JAX package's **REP005** (side effects inside a ``shard_map`` body,
which fire at trace time) has no counterpart: the port traces no body —
each rank runs its pipeline eagerly, so a side effect there fires once
per call, as written.  The rule is not dropped silently; its code is not
reused.

Suppress a finding with an inline comment carrying a reason::

    t0 = time.perf_counter()  # repro-lint: disable=REP002 driver wall

A bare ``disable=REPxxx`` with no reason does **not** suppress.
"""
from __future__ import annotations

import argparse
import ast
import glob
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Set

from .diagnostics import Diagnostic, DiagnosticReport

RULES = ("REP001", "REP002", "REP003", "REP004")
DEFAULT_PATHS = ("src/repro_torch", "tests/test_torch_*.py",
                 "tests/torch_harness.py", "chip_smoke.py")
_DEVICE_MESH = ("torch", "distributed", "device_mesh")
_DEVICE_MESH_NAMES = {"init_device_mesh", "DeviceMesh"}
_PROFILER_RENAMED = {"self_cuda_time_total", "cuda_time_total"}
_TIMER_CALLS = {"perf_counter", "monotonic"}
_CACHE_NAME = re.compile(r"(CACHE|MEMO)", re.IGNORECASE)
_WISDOM_TEXT = re.compile(r"(wisdom|tuning)", re.IGNORECASE)
_SUPPRESS = re.compile(
    r"#\s*repro-lint:\s*disable=(?P<codes>[A-Z0-9, ]+?)(?:\s+(?P<reason>\S.*))?$")


def _suppressions(source: str) -> Dict[int, Set[str]]:
    """line -> suppressed codes (only when the comment carries a reason)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS.search(line)
        if m and m.group("reason"):
            out[i] = {c.strip() for c in m.group("codes").split(",")
                      if c.strip()}
    return out


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """['torch', 'distributed', 'device_mesh'] for a dotted chain, else
    None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _private(parts: Sequence[str]) -> bool:
    """A torch path with a ``_``-prefixed part (dunders are public)."""
    return any(p.startswith("_") and not (p.startswith("__")
                                          and p.endswith("__"))
               for p in parts[1:])


def _versioned_torch_path(parts: Sequence[str]) -> Optional[str]:
    """Why a resolved torch path is version-sensitive (None if it is not)."""
    if not parts or parts[0] != "torch":
        return None
    if tuple(parts[:3]) == _DEVICE_MESH:
        return "torch.distributed.device_mesh"
    if _private(parts):
        return "a private torch namespace"
    return None


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.findings: List[Diagnostic] = []
        norm = path.replace(os.sep, "/")
        self.is_compat = norm.endswith("repro_torch/compat.py")
        self.is_wisdom_home = norm.endswith("core/plan.py")
        # Function/class nesting for the REP002 timer exemption.
        self._func_stack: List[ast.AST] = []
        self._class_stack: List[ast.ClassDef] = []
        # Names imported `from time import ...` (REP002 on bare calls).
        self._time_names: Set[str] = set()
        # Local name -> the torch path it stands for (REP001 aliases).
        self._aliases: Dict[str, List[str]] = {}

    def _emit(self, code: str, node: ast.AST, message: str,
              hint: str) -> None:
        self.findings.append(Diagnostic(
            code=code, severity="error", message=message, hint=hint,
            path=self.path, line=getattr(node, "lineno", 0)))

    # -- REP001 --------------------------------------------------------------

    def _rep001(self, node: ast.AST, what: str, why: str) -> None:
        self._emit("REP001", node,
                   f"version-sensitive torch API {what!r} ({why}) used "
                   f"outside repro_torch/compat.py",
                   "wrap it in repro_torch.compat and import it from there")

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            parts = alias.name.split(".")
            if alias.asname:
                self._aliases[alias.asname] = parts
            else:
                self._aliases[parts[0]] = parts[:1]
            why = _versioned_torch_path(parts)
            if why and not self.is_compat:
                self._rep001(node, alias.name, why)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and node.level == 0:
            parts = node.module.split(".")
            for alias in node.names:
                full = parts + [alias.name]
                self._aliases[alias.asname or alias.name] = full
                why = _versioned_torch_path(full)
                if why is None and parts[0] == "torch" \
                        and alias.name in _DEVICE_MESH_NAMES:
                    why = "torch.distributed.device_mesh"
                if why and not self.is_compat:
                    self._rep001(node, ".".join(full), why)
            if node.module == "time":
                self._time_names.update(a.name for a in node.names
                                        if a.name in _TIMER_CALLS)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if not self.is_compat:
            if node.attr in _PROFILER_RENAMED:
                self._rep001(node, node.attr,
                             "the profiler renamed it *_device_time_total")
            else:
                chain = _attr_chain(node)
                if chain and chain[0] in self._aliases:
                    resolved = self._aliases[chain[0]] + chain[1:]
                    why = _versioned_torch_path(resolved)
                    if why:
                        self._rep001(node, ".".join(resolved), why)
                        return   # one finding per chain, not per prefix
        self.generic_visit(node)

    # -- function / class nesting --------------------------------------------

    def _has_timer_param(self, fn: ast.AST) -> bool:
        args = fn.args
        names = [a.arg for a in
                 args.posonlyargs + args.args + args.kwonlyargs]
        return "timer" in names

    def _timer_injectable(self) -> bool:
        for fn in self._func_stack:
            if self._has_timer_param(fn):
                return True
        for cls in self._class_stack:
            for stmt in cls.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and stmt.name == "__init__" \
                        and self._has_timer_param(stmt):
                    return True
        return False

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node)
        self.generic_visit(node)
        self._class_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._func_stack.append(node)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- REP002 / REP003 -----------------------------------------------------

    def _is_wall_clock_call(self, node: ast.Call) -> bool:
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "time" and f.attr in _TIMER_CALLS:
            return True
        return isinstance(f, ast.Name) and f.id in self._time_names

    def _segment(self, node: ast.AST) -> str:
        return ast.get_source_segment(self.source, node) or ""

    def _check_wisdom_write(self, node: ast.Call) -> None:
        f = node.func
        is_open = isinstance(f, ast.Name) and f.id == "open" \
            and len(node.args) >= 2 \
            and isinstance(node.args[1], ast.Constant) \
            and isinstance(node.args[1].value, str) \
            and any(m in node.args[1].value for m in ("w", "a", "+"))
        chain = _attr_chain(f) or []
        is_replace = chain == ["os", "replace"]
        if (is_open or is_replace) \
                and _WISDOM_TEXT.search(self._segment(node)):
            self._emit(
                "REP003", node,
                "wisdom/tuning file write outside the fcntl-locked "
                "TuningCache._save path",
                "route writes through TuningCache (core/plan.py) so the "
                "read-merge-rename dance and the advisory lock apply")

    def visit_Call(self, node: ast.Call) -> None:
        if self._is_wall_clock_call(node) and not self._timer_injectable():
            self._emit(
                "REP002", node,
                "wall-clock timing call without an injectable timer in "
                "scope",
                "take a timer=time.perf_counter parameter (function or "
                "owning class __init__) and call it instead")
        if not self.is_wisdom_home:
            self._check_wisdom_write(node)
        self.generic_visit(node)

    # -- REP004 --------------------------------------------------------------

    def _module_evicts(self, name: str) -> bool:
        for n in ast.walk(self.tree):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "popitem" \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id == name:
                return True
            if isinstance(n, ast.Delete):
                for t in n.targets:
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == name:
                        return True
        return False

    def _check_module_caches(self) -> None:
        for stmt in self.tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target, value = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                target, value = stmt.target, stmt.value
            else:
                continue
            if not (isinstance(target, ast.Name)
                    and _CACHE_NAME.search(target.id)):
                continue
            is_dict = isinstance(value, ast.Dict) or (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id in ("dict", "OrderedDict", "defaultdict"))
            if is_dict and not self._module_evicts(target.id):
                self._emit(
                    "REP004", stmt,
                    f"module-level cache dict {target.id!r} has no visible "
                    f"eviction (no .popitem / del {target.id}[...] in this "
                    f"module)",
                    "bound it (LRU popitem like _PLAN_MEMO, or use "
                    "plan.PlanCache)")

    # -- driver --------------------------------------------------------------

    def run(self) -> List[Diagnostic]:
        self._check_module_caches()
        self.visit(self.tree)
        return self.findings


def lint_source(source: str, path: str = "<string>") -> DiagnosticReport:
    """Lint one module's source; suppressions already applied."""
    report = DiagnosticReport()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        report.add(Diagnostic(
            code="REP000", severity="error",
            message=f"cannot parse: {e.msg}", hint="fix the syntax error",
            path=path, line=e.lineno or 0))
        return report
    suppressed = _suppressions(source)
    for diag in _Linter(path, source, tree).run():
        if diag.code in suppressed.get(diag.line or 0, ()):
            continue
        report.add(diag)
    report.diagnostics.sort(key=lambda d: (d.path or "", d.line or 0,
                                           d.code))
    return report


def iter_python_files(paths: Sequence[str]) -> List[str]:
    """The ``.py`` files under ``paths`` (files, directories or glob
    patterns), sorted."""
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        else:
            out.extend(f for f in glob.glob(p) if f.endswith(".py"))
    return sorted(set(out))


def lint_paths(paths: Sequence[str],
               select: Optional[Sequence[str]] = None) -> DiagnosticReport:
    report = DiagnosticReport()
    for path in iter_python_files(paths):
        with open(path) as f:
            source = f.read()
        for diag in lint_source(source, path):
            if select is None or diag.code in select:
                report.add(diag)
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repro-lint for the port (rules REP001..REP004)")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files, directories or glob patterns to lint "
                         "(default: the port, its tests and chip_smoke.py, "
                         "from the repo root)")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="write the diagnostic stream as JSON ('-' for "
                         "stdout)")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule codes to report")
    args = ap.parse_args(argv)
    select = (tuple(c.strip() for c in args.select.split(","))
              if args.select else None)
    report = lint_paths(args.paths, select=select)
    if args.json_path == "-":
        print(report.to_json())
    elif args.json_path:
        os.makedirs(os.path.dirname(args.json_path) or ".", exist_ok=True)
        with open(args.json_path, "w") as f:
            f.write(report.to_json())
            f.write("\n")
    if report and args.json_path != "-":
        print(report.render(), file=sys.stderr)
    print(f"repro-lint: {len(report)} finding(s) over "
          f"{len(iter_python_files(args.paths))} file(s)",
          file=sys.stderr)
    return 1 if report else 0


if __name__ == "__main__":
    sys.exit(main())
