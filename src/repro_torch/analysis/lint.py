"""Repo-specific static hazard linter for the PyTorch port (the port's
counterpart of ``repro.analysis.lint``). Its rules carry names of their
own, so that a waiver of the JAX linter does not silence them:

``cuda-unsynced-timing``
    A host-clock ``t1 - t0`` window with no barrier in its scope. CUDA
    launches return before the work ends; without a barrier the window
    times the launches, not the computation. A barrier is
    ``torch.cuda.synchronize``, an event's ``synchronize()`` or
    ``elapsed_time``, a stream's ``synchronize``, or a function of the
    same module that calls one of them. A window that times host work
    only says so in its waiver.

``cached-tensor-args``
    ``functools.lru_cache``/``cache`` (or a memo decorator) on a function
    whose parameters are unannotated or annotated as tensors or arrays.
    A tensor hashes by identity: a cache keyed on one returns a stale
    result once the tensor is written in place, and keeps the tensor
    alive. Key the cache on hashable metadata instead.

``repro-torch-imports-benchmarks``
    ``repro_torch.*`` (the library) importing ``benchmarks.*`` (the
    harness): the library stays importable without the harness.

``jit-arg-flavor`` has no counterpart: the port has no jit cache. That
the port imports neither ``jax`` nor ``repro`` is a test
(``tests/test_torch_core.py``).

A ``# lint: waive=<rule>[,<rule>...]`` pragma on the flagged line or on
the enclosing ``def``/``class`` line waives a finding, visibly.

Run as ``python -m repro_torch.analysis.lint`` (default paths:
``src/repro_torch``, ``chip_smoke.py`` and ``examples/*_torch.py``);
exits non-zero on unwaived findings. The fixtures in
``tests/torch_lint_fixtures/`` pin one known-bad snippet per rule and a
clean near-miss file.
"""
from __future__ import annotations

import ast
import dataclasses
import sys
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["Finding", "lint_source", "lint_file", "lint_paths", "RULES",
           "main"]

RULES = ("cuda-unsynced-timing", "cached-tensor-args",
         "repro-torch-imports-benchmarks")

WAIVE_TAG = "# lint: waive="

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "examples/*_torch.py")

_HASHABLE_ANNOTATIONS = {
    "int", "float", "str", "bool", "bytes", "complex", "tuple",
    "frozenset", "None", "Fraction", "Number", "Optional", "Union",
    "Literal", "Hashable", "dtype", "device", "Sequence", "Iterable",
}
_TENSORISH_ANNOTATIONS = {"Tensor", "ndarray", "Array", "ArrayLike",
                          "Parameter"}

_TIME_FUNCS = {"perf_counter", "monotonic", "time", "process_time",
               "perf_counter_ns", "monotonic_ns"}
#: calls that wait for the device: a CUDA, event or stream synchronize,
#: and an event pair's elapsed time (it requires both events done)
_BARRIERS = {"synchronize", "elapsed_time"}


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str
    waived: bool = False

    def __str__(self) -> str:
        tag = " (waived)" if self.waived else ""
        return f"{self.path}:{self.line}: {self.rule}{tag}: {self.message}"


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression ('torch.cuda.synchronize')."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return _dotted(node.func)
    return ""


def _is_cache_expr(node: ast.AST) -> bool:
    return _dotted(node).rsplit(".", 1)[-1] in ("lru_cache", "cache",
                                                 "memoize", "memo")


def _annotation_kind(ann: Optional[ast.expr]) -> str:
    """'hashable' | 'tensorish' | 'unknown' | 'missing' for one param."""
    if ann is None:
        return "missing"
    names = {n.rsplit(".", 1)[-1]
             for n in (_dotted(x) for x in ast.walk(ann)) if n}
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        names |= {ann.value.rsplit(".", 1)[-1]}
    if names & _TENSORISH_ANNOTATIONS:
        return "tensorish"
    if isinstance(ann, ast.Constant) and ann.value is None:
        return "hashable"
    if names and names <= _HASHABLE_ANNOTATIONS:
        return "hashable"
    return "unknown"


class _ModuleLinter(ast.NodeVisitor):
    """The import and cache rules."""

    def __init__(self, path: str, is_library: bool):
        self.path, self.is_library = path, is_library
        self.findings: list[Finding] = []

    def add(self, line: int, rule: str, message: str):
        self.findings.append(Finding(self.path, line, rule, message))

    def _check_import(self, node, module: str):
        if self.is_library and (module == "benchmarks"
                                or module.startswith("benchmarks.")):
            self.add(node.lineno, "repro-torch-imports-benchmarks",
                     f"library module imports {module!r}; repro_torch.* "
                     "must not depend on the benchmark harness")

    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            self._check_import(node, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module and node.level == 0:
            self._check_import(node, node.module)
        self.generic_visit(node)

    def _visit_funcdef(self, node):
        if any(_is_cache_expr(d) for d in node.decorator_list):
            a = node.args
            params = (a.posonlyargs + a.args + a.kwonlyargs
                      + ([a.vararg] if a.vararg else []))
            bad = [(p.arg, _annotation_kind(p.annotation)) for p in params
                   if _annotation_kind(p.annotation) in ("missing",
                                                         "tensorish")]
            if bad:
                what = ", ".join(f"{n} ({k} annotation)" for n, k in bad)
                self.add(node.lineno, "cached-tensor-args",
                         f"cached function {node.name!r} may take tensor "
                         f"arguments: {what}; a tensor hashes by identity, "
                         "so an in-place write leaves the cache stale — "
                         "key the cache on hashable metadata instead")
        self.generic_visit(node)

    visit_FunctionDef = _visit_funcdef
    visit_AsyncFunctionDef = _visit_funcdef


def body_walk(body) -> Iterable[ast.AST]:
    """Walk statements without descending into nested function scopes."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class _TimingLinter(ast.NodeVisitor):
    """cuda-unsynced-timing: per-scope t1 - t0 windows with no barrier."""

    def __init__(self, path: str):
        self.path = path
        self.findings: list[Finding] = []
        self.barriers = set(_BARRIERS)      # + module-local wrappers

    def _scan_scope(self, body):
        def is_time_call(n: ast.AST) -> bool:
            name = _dotted(n.func) if isinstance(n, ast.Call) else ""
            return (name.rsplit(".", 1)[-1] in _TIME_FUNCS
                    and name.split(".", 1)[0] in {"time"} | _TIME_FUNCS)

        time_names: set[str] = set()
        synced = False
        nodes = list(body_walk(body))
        for sub in nodes:
            if isinstance(sub, ast.Assign) and is_time_call(sub.value):
                time_names.update(t.id for t in sub.targets
                                  if isinstance(t, ast.Name))
            if isinstance(sub, ast.Call) and \
                    _dotted(sub.func).rsplit(".", 1)[-1] in self.barriers:
                synced = True

        def timed(n: ast.AST) -> bool:
            return is_time_call(n) or (isinstance(n, ast.Name)
                                       and n.id in time_names)
        # both operands on the host clock: a one-sided
        # ``deadline - perf_counter()`` is a deadline, not a measurement
        subs = [sub.lineno for sub in nodes
                if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Sub)
                and timed(sub.left) and timed(sub.right)]
        if subs and not synced:
            self.findings.append(Finding(
                self.path, min(subs), "cuda-unsynced-timing",
                "host-clock window with no CUDA barrier in scope "
                "(torch.cuda.synchronize, an event's synchronize or "
                "elapsed_time, a stream's synchronize): CUDA launches are "
                "asynchronous, so this times the launches"))

    def _visit_funcdef(self, node):
        self._scan_scope(node.body)
        self.generic_visit(node)

    visit_FunctionDef = _visit_funcdef
    visit_AsyncFunctionDef = _visit_funcdef

    def scan_module(self, tree: ast.Module):
        # a def of this module that calls a barrier is one at its call
        # sites (a ``_sync()`` helper)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and any(isinstance(s, ast.Call) and
                            _dotted(s.func).rsplit(".", 1)[-1] in _BARRIERS
                            for s in ast.walk(node)):
                self.barriers.add(node.name)
        self._scan_scope([n for n in tree.body
                          if not isinstance(n, (ast.FunctionDef,
                                                ast.AsyncFunctionDef,
                                                ast.ClassDef))])
        self.visit(tree)


def _apply_waivers(findings: list[Finding], source: str) -> list[Finding]:
    """Mark findings waived by a pragma on their line or an enclosing
    def/class line."""
    lines = source.splitlines()

    def waivers_on(lineno: int) -> set[str]:
        if 1 <= lineno <= len(lines):
            text = lines[lineno - 1]
            idx = text.find(WAIVE_TAG)
            while idx >= 0:
                spec = text[idx + len(WAIVE_TAG):].split("#", 1)[0]
                got = {r.strip() for r in spec.split(",") if r.strip()}
                if got & set(RULES) or "all" in got:
                    return got
                idx = text.find(WAIVE_TAG, idx + 1)
        return set()

    enclosing: dict[int, list[int]] = {}
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            for ln in range(node.lineno,
                            getattr(node, "end_lineno", node.lineno) + 1):
                enclosing.setdefault(ln, []).append(node.lineno)
    out = []
    for f in findings:
        cand = {f.line, *enclosing.get(f.line, [])}
        waived = any(f.rule in waivers_on(ln) or "all" in waivers_on(ln)
                     for ln in cand)
        out.append(dataclasses.replace(f, waived=True) if waived else f)
    return out


def lint_source(source: str, path: str = "<string>",
                is_library: Optional[bool] = None) -> list[Finding]:
    """Lint one module's source; findings with waivers applied.
    ``is_library`` (default: ``repro_torch`` in the path) turns on the
    import rule."""
    if is_library is None:
        is_library = "repro_torch" in Path(path).parts
    tree = ast.parse(source, filename=path)
    mod = _ModuleLinter(path, is_library)
    mod.visit(tree)
    tim = _TimingLinter(path)
    tim.scan_module(tree)
    return _apply_waivers(sorted(mod.findings + tim.findings,
                                 key=lambda f: (f.line, f.rule)), source)


def lint_file(path: Path, is_library: Optional[bool] = None
              ) -> list[Finding]:
    return lint_source(Path(path).read_text(), str(path), is_library)


def _expand(patterns: Iterable[str]) -> list[Path]:
    out = []
    for p in patterns:
        if any(c in p for c in "*?["):
            out.extend(sorted(Path(".").glob(p)))
        else:
            out.append(Path(p))
    return out


def lint_paths(paths: Iterable[Path]) -> list[Finding]:
    findings: list[Finding] = []
    for root in paths:
        files = sorted(Path(root).rglob("*.py")) if Path(root).is_dir() \
            else [Path(root)]
        for f in files:
            findings.extend(lint_file(f))
    return findings


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Repo-specific PyTorch/CUDA hazard linter (see the "
                    "module docs).")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files, directories or globs to lint (default: "
                         + " ".join(DEFAULT_PATHS) + ")")
    ap.add_argument("--show-waived", action="store_true",
                    help="also print waived findings")
    args = ap.parse_args(argv)
    findings = lint_paths(_expand(args.paths))
    active = [f for f in findings if not f.waived]
    for f in active:
        print(f)
    if args.show_waived:
        for f in findings:
            if f.waived:
                print(f)
    print(f"lint: {len(active)} finding(s), "
          f"{len(findings) - len(active)} waived, rules: {', '.join(RULES)}")
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
