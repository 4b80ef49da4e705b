r"""Python-side static analysis for jaxmc_torch itself.

ruff (rule selection in ruff.toml: pyflakes + bugbear) is preferred
where the host has it; this module is the container fallback —
a small stdlib-ast checker covering the two finding classes the
satellite gates on:

  JPY401  unused import (pyflakes F401)
  JPY841  local variable assigned but never used (pyflakes F841)

Conservative by construction: `__init__.py` re-exports, `__all__`
entries, underscore names, tuple-unpacking targets, and augmented /
annotated assignments are all exempt — a finding here is meant to be
FIXED, so false positives are worse than misses.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import List, Tuple


def _loads_in(tree: ast.AST) -> set:
    """Every name read anywhere under tree (Load context), plus names
    referenced by `global`/`nonlocal` declarations."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and \
                isinstance(node.ctx, ast.Load):
            out.add(node.id)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            out.update(node.names)
        elif isinstance(node, ast.AugAssign) and \
                isinstance(node.target, ast.Name):
            # `x += 1` reads x even though the target ctx is Store
            out.add(node.target.id)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _all_strings(tree: ast.Module) -> set:
    """Names listed in a module-level __all__ literal."""
    out = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    for el in ast.walk(node.value):
                        if isinstance(el, ast.Constant) and \
                                isinstance(el.value, str):
                            out.add(el.value)
    return out


def _check_imports(tree: ast.Module, path: str,
                   findings: List[str]) -> None:
    if os.path.basename(path) == "__init__.py":
        return  # re-export idiom: imported names ARE the public surface
    used = _loads_in(tree)
    used |= _all_strings(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                name = alias.asname or alias.name.split(".")[0]
                if name.startswith("_"):
                    continue
                if name not in used:
                    findings.append(
                        f"{path}:{node.lineno}: JPY401 unused import "
                        f"'{alias.asname or alias.name}'")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                name = alias.asname or alias.name
                if name.startswith("_"):
                    continue
                if name not in used:
                    findings.append(
                        f"{path}:{node.lineno}: JPY401 unused import "
                        f"'{name}' from {node.module or '.'}")


def _direct_assigns(fn: ast.AST) -> List[ast.Assign]:
    """Assign statements belonging to fn's own scope: the subtree minus
    nested FunctionDef/ClassDef bodies (those are other scopes)."""
    out: List[ast.Assign] = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            if isinstance(child, ast.Assign):
                out.append(child)
            walk(child)

    walk(fn)
    return out


def _check_unused_locals(tree: ast.Module, path: str,
                         findings: List[str]) -> None:
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        loads = _loads_in(fn)
        for node in _direct_assigns(fn):
            if len(node.targets) != 1 or \
                    not isinstance(node.targets[0], ast.Name):
                continue  # tuple unpacking / attributes: exempt
            name = node.targets[0].id
            if name.startswith("_") or name in loads:
                continue
            # a later read exists nowhere in the function: flag once
            findings.append(
                f"{path}:{node.lineno}: JPY841 local variable "
                f"'{name}' is assigned but never used")


def check_file(path: str) -> List[str]:
    try:
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        tree = ast.parse(src, filename=path)
    except (OSError, SyntaxError) as ex:
        return [f"{path}:1: JPY100 does not parse: {ex}"]
    findings: List[str] = []
    _check_imports(tree, path, findings)
    _check_unused_locals(tree, path, findings)
    return findings


def check_tree(root: str) -> Tuple[int, List[str]]:
    """(files checked, findings) over every .py under root."""
    findings: List[str] = []
    n = 0
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                n += 1
                findings.extend(check_file(os.path.join(dirpath, fn)))
    return n, findings


def main(paths: List[str]) -> int:
    total = 0
    findings: List[str] = []
    for p in paths or ["jaxmc_torch"]:
        if os.path.isdir(p):
            n, fs = check_tree(p)
            total += n
            findings.extend(fs)
        else:
            total += 1
            findings.extend(check_file(p))
    for f in findings:
        print(f)
    print(f"pylint (builtin): {total} files, {len(findings)} finding"
          f"{'s' if len(findings) != 1 else ''}", file=sys.stderr)
    return 1 if findings else 0
