"""Analyzer core: findings, AST scanning scaffolding, fingerprints.

``repro_torch.analysis`` is a repo-specific static analyzer: every rule
encodes a serving invariant this codebase actually depends on (CUDA-graph
capture discipline, refcount balance, host syncs and compile hygiene — see
rules.py for the catalog and the bug class each rule is grounded in). The
core is deliberately stdlib-only: the analyzer must run in CI images and
pre-commit hooks that have neither jax nor torch.

A ``Finding`` is anchored by a *fingerprint* — a hash of
(rule, path, enclosing function, normalized source line, occurrence index) —
NOT by its line number, so accepted findings in the checked-in baseline
survive unrelated edits that shift lines (see baseline.py).
"""
from __future__ import annotations

import ast
import hashlib
import os
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Finding:
    rule: str                 # "RPR00x"
    path: str                 # repo-relative, forward slashes
    line: int
    col: int
    message: str
    func: str = "<module>"    # enclosing function qualname
    line_text: str = ""       # stripped source of the offending line
    fingerprint: str = ""     # stable id (assigned by fingerprint_findings)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}  [{self.fingerprint}]")

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message, "func": self.func,
                "line_text": self.line_text, "fingerprint": self.fingerprint}


@dataclass
class ModuleContext:
    """One parsed file, shared by every rule visiting it."""
    path: str                       # repo-relative
    tree: ast.Module
    source_lines: list[str]
    is_test: bool = False
    parents: dict = field(default_factory=dict)   # node -> parent node

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.source_lines):
            return self.source_lines[lineno - 1].strip()
        return ""

    def qualname(self, node: ast.AST) -> str:
        """Dotted enclosing-scope name for ``node`` (Class.method or
        function, '<module>' at top level)."""
        names = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                names.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(names)) or "<module>"

    def enclosing_class(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_function(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None


class Rule:
    """Base rule: subclasses set ``rule_id``/``title`` and implement
    ``check(ctx) -> list[Finding]`` (fingerprints are filled in later).
    ``applies_to_tests=False`` rules skip test files — their invariants
    target production paths (tests deliberately corrupt pools, sync devices
    mid-loop, etc.)."""

    rule_id = "RPR000"
    title = ""
    applies_to_tests = True

    def check(self, ctx: ModuleContext) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(rule=self.rule_id, path=ctx.path,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       message=message, func=ctx.qualname(node),
                       line_text=ctx.line_text(getattr(node, "lineno", 0)))


# ----------------------------------------------------------------------
# AST helpers shared by the rules
# ----------------------------------------------------------------------

def attr_chain(node: ast.AST) -> list[str]:
    """['self', 'pool', 'alloc'] for ``self.pool.alloc``; [] if the
    expression is not a plain name/attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def call_name(call: ast.Call) -> str:
    """Last component of the called name ('alloc' for self.pool.alloc(..))."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def receiver_name(call: ast.Call) -> str:
    """Name the method receiver: 'pool' for ``self.pool.alloc(...)``,
    '' for bare calls."""
    f = call.func
    if isinstance(f, ast.Attribute):
        chain = attr_chain(f)
        if len(chain) >= 2:
            return chain[-2]
    return ""


def walk_calls(node: ast.AST):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            yield sub


def is_test_path(path: str) -> bool:
    parts = path.replace(os.sep, "/").split("/")
    base = parts[-1]
    return ("tests" in parts[:-1] or base.startswith("test_")
            or base == "conftest.py")


def build_parents(tree: ast.Module) -> dict:
    parents: dict = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


# ----------------------------------------------------------------------
# scanning
# ----------------------------------------------------------------------

def iter_python_files(paths, root: str):
    """Yield repo-relative .py paths under ``paths`` (files or dirs),
    skipping caches/hidden dirs, sorted for deterministic output."""
    seen = set()
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(ap) and ap.endswith(".py"):
            seen.add(os.path.relpath(ap, root))
            continue
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = sorted(d for d in dirnames
                                 if not d.startswith(".")
                                 and d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    seen.add(os.path.relpath(os.path.join(dirpath, fn), root))
    return sorted(s.replace(os.sep, "/") for s in seen)


def parse_module(relpath: str, root: str) -> ModuleContext | None:
    ap = os.path.join(root, relpath)
    try:
        with open(ap, encoding="utf-8") as f:
            src = f.read()
        tree = ast.parse(src, filename=relpath)
    except (OSError, SyntaxError):
        return None                      # unparseable: not this tool's beat
    ctx = ModuleContext(path=relpath, tree=tree,
                        source_lines=src.splitlines(),
                        is_test=is_test_path(relpath))
    ctx.parents = build_parents(tree)
    return ctx


def fingerprint_findings(findings: list[Finding]) -> list[Finding]:
    """Assign stable fingerprints: hash of (rule, path, func, normalized
    line text, occurrence index) — line numbers deliberately excluded so
    unrelated edits don't churn the baseline."""
    counts: dict[tuple, int] = {}
    out = []
    for f in findings:
        key = (f.rule, f.path, f.func, " ".join(f.line_text.split()))
        idx = counts.get(key, 0)
        counts[key] = idx + 1
        raw = "|".join((f.rule, f.path, f.func,
                        " ".join(f.line_text.split()), str(idx)))
        fp = hashlib.sha1(raw.encode()).hexdigest()[:12]
        out.append(Finding(rule=f.rule, path=f.path, line=f.line, col=f.col,
                           message=f.message, func=f.func,
                           line_text=f.line_text, fingerprint=fp))
    return out


def analyze_paths(paths, root: str, rules) -> list[Finding]:
    """Run every rule over every python file under ``paths``; returns
    fingerprinted findings sorted by (path, line, rule)."""
    findings: list[Finding] = []
    for relpath in iter_python_files(paths, root):
        ctx = parse_module(relpath, root)
        if ctx is None:
            continue
        for rule in rules:
            if ctx.is_test and not rule.applies_to_tests:
                continue
            findings.extend(rule.check(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.col))
    return fingerprint_findings(findings)
