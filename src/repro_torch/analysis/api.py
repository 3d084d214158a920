"""API-misuse pass (project-wide).

- ``api-unseeded-rng`` (error): a zero-argument
  ``np.random.RandomState()`` / ``np.random.default_rng()`` /
  ``random.Random()`` seeds itself from the OS — inside a function that
  *takes* a ``seed`` parameter this silently discards the caller's
  seed, which is the exact failure mode ``core.rng`` exists to
  prevent; anywhere else it is still hidden nondeterminism.

- ``api-frozen-mutation`` (error): the repo's configs are frozen
  dataclasses so a sweep can share one instance across engines. The two
  escape hatches that defeat that are ``object.__setattr__(cfg, ...)``
  used outside the owning class (``__post_init__`` normalisation is the
  one legitimate site) and plain attribute assignment to a value whose
  annotation names a frozen class (which raises ``FrozenInstanceError``
  at runtime — but only on the code path that runs). The fix is
  ``dataclasses.replace(cfg, field=...)``.

The pass is project-wide because the frozen-class registry must be
built from every file before any single file can be judged.

The port's copy of the JAX package's ``analysis/api.py``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.analysis.core import (FileContext, Finding, dotted_name,
                                 register_rule)

register_rule("api-unseeded-rng", "error",
              "a fresh RNG constructed with no seed (OS-seeded); thread "
              "the caller's seed through core.rng instead")
register_rule("api-frozen-mutation", "error",
              "mutation of a frozen-dataclass field outside the owning "
              "class; use dataclasses.replace")

_RNG_CONSTRUCTORS = {
    "RandomState": "np.random.RandomState",
    "default_rng": "np.random.default_rng",
    "Random": "random.Random",
}


def _frozen_classes(contexts: Sequence[FileContext]) -> Set[str]:
    """Names of classes decorated ``@dataclass(frozen=True)`` anywhere."""
    out: Set[str] = set()
    for ctx in contexts:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for dec in node.decorator_list:
                if not isinstance(dec, ast.Call):
                    continue
                name = dotted_name(dec.func)
                if name not in ("dataclass", "dataclasses.dataclass"):
                    continue
                for kw in dec.keywords:
                    if kw.arg == "frozen" \
                            and isinstance(kw.value, ast.Constant) \
                            and kw.value.value is True:
                        out.add(node.name)
    return out


def _takes_seed(fn: ast.AST) -> bool:
    args = fn.args
    names = [a.arg for a in (args.posonlyargs + args.args
                             + args.kwonlyargs)]
    return any(n == "seed" or n.endswith("_seed") for n in names)


def _annotation_name(node: Optional[ast.AST]) -> Optional[str]:
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(".")[-1].strip()
    name = dotted_name(node)
    if name is not None:
        return name.split(".")[-1]
    if isinstance(node, ast.Subscript):   # Optional[Cfg] / list[Cfg]: outer
        return None
    return None


def _check_unseeded(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    funcs = [n for n in ast.walk(ctx.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    seeded_spans = [(f.lineno, max(f.lineno, getattr(f, "end_lineno",
                                                    f.lineno)))
                    for f in funcs if _takes_seed(f)]
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or node.args or node.keywords:
            continue
        name = dotted_name(node.func)
        if name is None:
            continue
        tail = name.split(".")[-1]
        if tail not in _RNG_CONSTRUCTORS:
            continue
        # `Random` is a common identifier; require the module prefix.
        # `RandomState`/`default_rng` are distinctive enough bare.
        if tail == "Random" and "." not in name:
            continue
        in_seeded = any(lo <= node.lineno <= hi for lo, hi in seeded_spans)
        where = ("inside a seed-taking function, discarding the caller's "
                 "seed" if in_seeded else "OS-seeded, so every run differs")
        out.append(ctx.finding(
            node, "api-unseeded-rng",
            f"{_RNG_CONSTRUCTORS[tail]}() with no seed is {where}; use "
            "core.rng streams"))
    return out


def _check_frozen(ctx: FileContext, frozen: Set[str]) -> List[Finding]:
    out: List[Finding] = []
    # classes defined in this file; object.__setattr__ inside their own
    # method bodies (i.e. __post_init__ normalisation) is legitimate
    own_spans = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef) and node.name in frozen:
            own_spans.append((node.lineno,
                              getattr(node, "end_lineno", node.lineno)))
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name == "object.__setattr__":
                inside_owner = any(lo <= node.lineno <= hi
                                   for lo, hi in own_spans)
                if not inside_owner:
                    out.append(ctx.finding(
                        node, "api-frozen-mutation",
                        "object.__setattr__ outside the owning frozen "
                        "class bypasses immutability; build a new "
                        "instance with dataclasses.replace"))
    # attribute assignment to names annotated with a frozen class:
    # parameters and AnnAssign locals give us the annotation
    for fn in [n for n in ast.walk(ctx.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        typed: Dict[str, str] = {}
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            ann = _annotation_name(a.annotation)
            if ann in frozen:
                typed[a.arg] = ann
        for node in ast.walk(fn):
            if isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                ann = _annotation_name(node.annotation)
                if ann in frozen:
                    typed[node.target.id] = ann
        if not typed:
            continue
        for node in ast.walk(fn):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id in typed:
                    cls = typed[tgt.value.id]
                    out.append(ctx.finding(
                        tgt, "api-frozen-mutation",
                        f"{tgt.value.id}.{tgt.attr} = ... mutates frozen "
                        f"dataclass {cls} (FrozenInstanceError at "
                        f"runtime); use dataclasses.replace({tgt.value.id}"
                        f", {tgt.attr}=...)"))
    return out


def check_project(contexts: Sequence[FileContext]) -> List[Finding]:
    frozen = _frozen_classes(contexts)
    out: List[Finding] = []
    for ctx in contexts:
        out.extend(_check_unseeded(ctx))
        out.extend(_check_frozen(ctx, frozen))
    return out
