"""simlint core: file contexts, the rule registry, suppressions.

A *rule* is an id + severity + one-line description, registered in
``RULES`` so the CLI, the docs, and the suppression checker share one
catalogue. A *pass* is a callable producing :class:`Finding`s — either
per-file (``(FileContext) -> findings``) or project-wide
(``(list[FileContext]) -> findings`` — the trace-kind cross-check needs
to see the declaration and every emission site at once).

Suppressions are inline comments::

    expr  # simlint: ok(rule-id, why this specific site is fine)

matching findings on the same line, or — for a comment-only line — on
the next source line. The reason is mandatory: a reasonless ``ok(...)``
does not suppress and is reported as ``suppression-needs-reason``.

The port's copy of the JAX package's ``analysis/core.py``.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

__all__ = ["Finding", "FileContext", "Linter", "Rule", "RULES",
           "lint_paths", "register_rule", "dotted_name"]

SEVERITIES = ("warning", "error")


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: str
    description: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity: {self.severity!r}")


# one catalogue shared by every pass, the CLI, and the docs
RULES: Dict[str, Rule] = {}


def register_rule(rule_id: str, severity: str, description: str) -> Rule:
    if rule_id in RULES:
        raise ValueError(f"duplicate rule id: {rule_id!r}")
    rule = Rule(rule_id, severity, description)
    RULES[rule_id] = rule
    return rule


register_rule("suppression-needs-reason", "error",
              "a `# simlint: ok(rule)` comment must carry a written "
              "reason: `# simlint: ok(rule, reason)`")
register_rule("suppression-unknown-rule", "error",
              "a suppression names a rule id that does not exist")
register_rule("parse-error", "error",
              "a linted file does not parse as Python")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str                  # posix-style, as given to the linter
    line: int                  # 1-indexed
    rule: str
    message: str

    @property
    def severity(self) -> str:
        return RULES[self.rule].severity

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.severity} "
                f"[{self.rule}] {self.message}")


class FileContext:
    """One parsed source file plus the helpers every pass needs."""

    def __init__(self, path: str, source: str):
        self.path = Path(path).as_posix()
        self.source = source
        self.tree = ast.parse(source, filename=self.path)
        self.lines = source.splitlines()

    def in_dir(self, *parts: str) -> bool:
        """True when any of ``parts`` appears as a path component
        sequence, e.g. ``in_dir("repro/serverless")``."""
        p = "/" + self.path.strip("/") + "/"
        return any(f"/{part.strip('/')}/" in p for part in parts)

    def finding(self, node: ast.AST, rule: str, message: str) -> Finding:
        return Finding(self.path, getattr(node, "lineno", 1), rule, message)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``np.random.RandomState`` for the matching Attribute chain, or
    None when the chain does not bottom out at a plain Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# -- suppressions ------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*simlint:\s*ok\(\s*(?P<rule>[\w-]+)\s*(?:,\s*(?P<reason>[^)]*?)\s*)?\)")


@dataclasses.dataclass(frozen=True)
class _Suppression:
    line: int
    rule: str
    reason: str
    comment_only: bool         # a bare-comment line also covers line+1


def _parse_suppressions(ctx: FileContext) -> List[_Suppression]:
    # real COMMENT tokens only — a `# simlint: ok(...)` shown inside a
    # docstring or string literal is documentation, not a suppression
    out = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(ctx.source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m is None:
                continue
            line = tok.start[0]
            comment_only = ctx.lines[line - 1].lstrip().startswith("#")
            out.append(_Suppression(line, m.group("rule"),
                                    (m.group("reason") or "").strip(),
                                    comment_only))
    except tokenize.TokenizeError:
        pass                    # file parsed, so this should not happen
    return out


def _apply_suppressions(ctx: FileContext,
                        findings: List[Finding]) -> List[Finding]:
    sups = _parse_suppressions(ctx)
    if not sups:
        return findings
    out = []
    active: Dict[tuple, _Suppression] = {}
    for s in sups:
        if not s.reason:
            out.append(Finding(ctx.path, s.line, "suppression-needs-reason",
                               f"suppression of {s.rule!r} has no reason; "
                               f"write `# simlint: ok({s.rule}, <why>)`"))
            continue
        if s.rule not in RULES:
            out.append(Finding(ctx.path, s.line, "suppression-unknown-rule",
                               f"no such rule: {s.rule!r}"))
            continue
        active[(s.line, s.rule)] = s
        if s.comment_only:
            active[(s.line + 1, s.rule)] = s
    for f in findings:
        if (f.line, f.rule) in active:
            continue
        out.append(f)
    return out


# -- the linter --------------------------------------------------------------

FilePass = Callable[[FileContext], Iterable[Finding]]
ProjectPass = Callable[[Sequence[FileContext]], Iterable[Finding]]


class Linter:
    """Collect ``.py`` files, run every pass, filter suppressions."""

    def __init__(self, file_passes: Optional[Sequence[FilePass]] = None,
                 project_passes: Optional[Sequence[ProjectPass]] = None):
        if file_passes is None or project_passes is None:
            # deferred: the pass modules import this one
            from repro_torch.analysis import api, coverage, determinism, units
            file_passes = [determinism.check_file, units.check_file]
            project_passes = [coverage.check_project, api.check_project]
        self.file_passes = list(file_passes)
        self.project_passes = list(project_passes)

    def collect(self, paths: Sequence[str]) -> List[str]:
        files: List[str] = []
        for p in paths:
            path = Path(p)
            if path.is_dir():
                files.extend(sorted(str(f) for f in path.rglob("*.py")))
            elif path.suffix == ".py":
                files.append(str(path))
        return files

    def lint_files(self, files: Sequence[str]) -> List[Finding]:
        contexts = []
        findings: List[Finding] = []
        for f in files:
            src = Path(f).read_text()
            try:
                contexts.append(FileContext(f, src))
            except SyntaxError as e:
                findings.append(Finding(Path(f).as_posix(), e.lineno or 1,
                                        "parse-error",
                                        f"file does not parse: {e.msg}"))
        per_file: Dict[str, List[Finding]] = {c.path: [] for c in contexts}
        for ctx in contexts:
            for fp in self.file_passes:
                per_file[ctx.path].extend(fp(ctx))
        for pp in self.project_passes:
            for f in pp(contexts):
                per_file.setdefault(f.path, []).append(f)
        by_path = {c.path: c for c in contexts}
        for path, fs in per_file.items():
            ctx = by_path.get(path)
            findings.extend(_apply_suppressions(ctx, fs) if ctx else fs)
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return findings

    def lint_paths(self, paths: Sequence[str]) -> List[Finding]:
        return self.lint_files(self.collect(paths))


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    return Linter().lint_paths(paths)
