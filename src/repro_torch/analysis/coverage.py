"""Trace/event coverage pass (project-wide).

Two invariants that runtime checks only half-enforce:

- **Trace kinds, both directions.** ``TraceEvent.__post_init__``
  rejects an *emitted* kind missing from ``KINDS`` — but only when that
  code path actually runs, and it can never notice the converse: a kind
  declared in ``KINDS`` that nothing emits any more (the runtime check
  was added precisely because a typo'd kind silently vanished from
  traces; a dead declared kind is the same bug seen from the other
  side, keeping ``events if e.kind == ...`` filters looking alive).
  This pass collects every ``KINDS`` declaration and every literal kind
  passed to a ``TraceEvent(...)`` construction across the whole tree
  and reports both mismatch directions.

- **Event push targets.** ``CalendarQueue``/``ContentionDomain``
  records are ``(t, seq, fn, payload)`` tuples holding a *bound method*
  — there is no registry to validate against at runtime, so a renamed
  handler only fails when the event fires (possibly hours into a
  sweep). In any module that uses those classes, every ``at``/``at2``/
  ``at2_bulk``/``push``/``push_bulk`` call whose handler is written as
  an attribute (``self._compute_done``) must name a function defined
  somewhere in that module. Handlers passed through variables or
  parameters are skipped — the pass only proves what it can see.

The port's copy of the JAX package's ``analysis/coverage.py``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import (FileContext, Finding, dotted_name,
                                 register_rule)

register_rule("trace-kind-undeclared", "error",
              "TraceEvent(...) constructed with a literal kind missing "
              "from TraceEvent.KINDS")
register_rule("trace-kind-dead", "warning",
              "a kind declared in TraceEvent.KINDS is never emitted by "
              "any TraceEvent(...) construction in the tree")
register_rule("event-unbound-handler", "error",
              "an event pushed at a CalendarQueue/ContentionDomain names "
              "a handler attribute with no matching function definition "
              "in the module")

_TRACE_CLASSES = ("TraceEvent",)
_KIND_ARG_INDEX = 2                     # TraceEvent(t, epoch, kind, ...)


def _literal_strings(node: ast.AST) -> Optional[Set[str]]:
    """The set of strings a KINDS declaration holds, if it is a literal
    frozenset/set of string constants (possibly ``frozenset({...})``)."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("frozenset", "set") and len(node.args) == 1:
        return _literal_strings(node.args[0])
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        out: Set[str] = set()
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            out.add(elt.value)
        return out
    return None


def _kind_of_call(call: ast.Call) -> Optional[Tuple[str, ast.AST]]:
    """(kind string, node-to-blame) for a literal-kind TraceEvent call."""
    for kw in call.keywords:
        if kw.arg == "kind":
            if isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value, kw.value
            return None
    if len(call.args) > _KIND_ARG_INDEX:
        arg = call.args[_KIND_ARG_INDEX]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value, arg
    return None


def _check_trace_kinds(contexts: Sequence[FileContext]) -> List[Finding]:
    declared: Dict[str, Set[str]] = {}          # class -> kinds
    decl_site: Dict[str, Tuple[FileContext, ast.AST]] = {}
    emissions: List[Tuple[FileContext, ast.AST, str, str]] = []
    for ctx in contexts:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef) and node.name in _TRACE_CLASSES:
                for stmt in node.body:
                    tgt = None
                    if isinstance(stmt, ast.AnnAssign) \
                            and isinstance(stmt.target, ast.Name):
                        tgt, val = stmt.target.id, stmt.value
                    elif isinstance(stmt, ast.Assign) \
                            and len(stmt.targets) == 1 \
                            and isinstance(stmt.targets[0], ast.Name):
                        tgt, val = stmt.targets[0].id, stmt.value
                    if tgt == "KINDS" and val is not None:
                        kinds = _literal_strings(val)
                        if kinds is not None:
                            declared[node.name] = kinds
                            decl_site[node.name] = (ctx, stmt)
            elif isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if name is None:
                    continue
                cls = name.split(".")[-1]
                if cls in _TRACE_CLASSES:
                    got = _kind_of_call(node)
                    if got is not None:
                        emissions.append((ctx, got[1], cls, got[0]))

    out: List[Finding] = []
    emitted: Dict[str, Set[str]] = {c: set() for c in declared}
    for ctx, node, cls, kind in emissions:
        if cls not in declared:
            continue
        emitted[cls].add(kind)
        if kind not in declared[cls]:
            out.append(ctx.finding(
                node, "trace-kind-undeclared",
                f"{cls}(kind={kind!r}) is not declared in {cls}.KINDS — "
                "this raises at runtime; register the kind (or fix the "
                "typo)"))
    for cls, kinds in declared.items():
        ctx, site = decl_site[cls]
        # fixture trees may declare a class nothing emits; only judge
        # deadness when the class is constructed somewhere in this run
        if not emitted[cls]:
            continue
        for kind in sorted(kinds - emitted[cls]):
            out.append(ctx.finding(
                site, "trace-kind-dead",
                f"{cls}.KINDS declares {kind!r} but no {cls}(...) in the "
                f"tree emits it; drop it so `kind == {kind!r}` filters "
                "can't silently match nothing"))
    return out


# -- event handler binding ---------------------------------------------------

_QUEUE_MARKERS = ("CalendarQueue", "ContentionDomain")
# method -> index of the handler inside the call's argument list, or,
# for the tuple/bulk forms, inside each record tuple
_DIRECT = {"at": 1, "at2": 1}
_RECORD = {"push": 2}                    # (t, seq, fn, payload)
_BULK = {"at2_bulk": 1, "push_bulk": 2}  # list of tuples, fn at index


def _handler_exprs(call: ast.Call, method: str) -> List[ast.AST]:
    if method in _DIRECT:
        idx = _DIRECT[method]
        return [call.args[idx]] if len(call.args) > idx else []
    if method in _RECORD:
        idx = _RECORD[method]
        if call.args and isinstance(call.args[0], (ast.Tuple, ast.List)) \
                and len(call.args[0].elts) > idx:
            return [call.args[0].elts[idx]]
        return []
    if method in _BULK:
        idx = _BULK[method]
        out = []
        if not call.args:
            return out
        seq = call.args[0]
        elts: List[ast.AST] = []
        if isinstance(seq, (ast.List, ast.Tuple, ast.Set)):
            elts = list(seq.elts)
        elif isinstance(seq, (ast.ListComp, ast.GeneratorExp)):
            elts = [seq.elt]
        for e in elts:
            if isinstance(e, (ast.Tuple, ast.List)) and len(e.elts) > idx:
                out.append(e.elts[idx])
        return out
    return []


def _check_handlers(contexts: Sequence[FileContext]) -> List[Finding]:
    out: List[Finding] = []
    for ctx in contexts:
        if not any(m in ctx.source for m in _QUEUE_MARKERS):
            continue
        defined = {n.name for n in ast.walk(ctx.tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            method = node.func.attr
            if method not in {**_DIRECT, **_RECORD, **_BULK}:
                continue
            # attribute handlers are provable; bare names may be
            # parameters or loop variables (unresolvable statically)
            # and lambdas/calls are accepted as-is
            for h in _handler_exprs(node, method):
                if isinstance(h, ast.Attribute) and h.attr not in defined:
                    out.append(ctx.finding(
                        h, "event-unbound-handler",
                        f"handler .{h.attr} pushed at the event queue "
                        f"but no function named {h.attr!r} is defined "
                        "in this module — the event would raise (or "
                        "call the wrong thing) when it fires"))
    return out


def check_project(contexts: Sequence[FileContext]) -> List[Finding]:
    return _check_trace_kinds(contexts) + _check_handlers(contexts)
