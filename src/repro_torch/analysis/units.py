"""Billing-units pass: suffix-inferred dimensions on names.

The repo's naming convention carries dimensions in identifier suffixes
(``wall_s``, ``bw_gbps``, ``state_mb``, ``cost_usd``, ``n_ev``). The
simulator's latent keep-alive billing bug was exactly a cross-unit slip
— seconds billed against the wrong store's rate — that type checkers
cannot see because everything is ``float``. Two rules:

- ``unit-mix`` (error): ``a_s + b_usd``, ``a_mb - b_gb``, or a
  comparison between two differently-dimensioned operands. Addition,
  subtraction, and comparison require like dimensions; multiplication
  and division are how conversions happen and are never flagged.
- ``unit-assign`` (warning): ``x_s = y_mb`` style assignments (and
  keyword arguments, ``f(wall_s=item.cost_usd)``) where both sides
  carry a known dimension and they differ, with no arithmetic in
  between to perform the conversion.

Inference is deliberately shallow: only bare names and attribute
accesses whose final component carries a known suffix get a dimension.
Any expression containing arithmetic is treated as dimensionless (a
conversion may have happened inside it).

The port's copy of the JAX package's ``analysis/units.py``.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.core import FileContext, Finding, register_rule

register_rule("unit-mix", "error",
              "arithmetic or comparison mixing incompatible unit "
              "dimensions (suffix-inferred: _s, _gbps, _mb, _gb, _usd, "
              "_usd_per_s, _usd_per_hr, _ev)")
register_rule("unit-assign", "warning",
              "assignment (or keyword argument) carries a value of one "
              "unit dimension into a name of another without conversion")

# endswith-matched, longest suffix first so `_gbps` is not read as `_s`
# and `_mbps`-style names never alias `_s`. `_mb` and `_gb` are distinct
# dimensions on purpose: adding megabytes to gigabytes without a /1024
# is exactly the class of bug this pass exists for. The billing *rates*
# (`_usd_per_s`, `_usd_per_hr`) come first for the same reason: a
# per-second rate is neither seconds nor dollars, and adding an hourly
# rate to a per-second one without the /3600 is the exact spot-market
# slip the multi-backend billing paths are exposed to.
_SUFFIXES = (
    ("_usd_per_hr", "dollars per hour"),
    ("_usd_per_s", "dollars per second"),
    ("_gbps", "bandwidth (Gbit/s)"),
    ("_usd", "dollars"),
    ("_mb", "megabytes"),
    ("_gb", "gigabytes"),
    ("_ev", "events"),
    ("_ns", "nanoseconds"),
    ("_ms", "milliseconds"),
    ("_s", "seconds"),
)

# plural/indexed forms: `times_s`, `sizes_mb` — same dimension per element
_ZERO_LIKE = (0, 0.0, -1, -1.0, 1, 1.0)


def _dim_of_name(name: str) -> Optional[str]:
    for suffix, dim in _SUFFIXES:
        if name.endswith(suffix) or name.endswith(suffix + "s"):
            return dim
    return None


def _dim(node: ast.AST) -> Optional[str]:
    """Dimension of an expression, or None when unknown/dimensionless.

    Only bare names, attributes, and subscripts of those are inferred;
    calls and arithmetic are opaque (conversion may occur inside).
    """
    if isinstance(node, ast.Name):
        return _dim_of_name(node.id)
    if isinstance(node, ast.Attribute):
        return _dim_of_name(node.attr)
    if isinstance(node, ast.Subscript):
        return _dim(node.value)
    if isinstance(node, ast.UnaryOp):
        return _dim(node.operand)
    return None


def _is_zero_like(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp):
        node = node.operand
    return isinstance(node, ast.Constant) and node.value in _ZERO_LIKE


def check_file(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.Add, ast.Sub)):
            ld, rd = _dim(node.left), _dim(node.right)
            if ld is not None and rd is not None and ld != rd:
                out.append(ctx.finding(
                    node, "unit-mix",
                    f"adding/subtracting {ld} and {rd}; convert one side "
                    "explicitly first"))
        elif isinstance(node, ast.Compare) and len(node.ops) == 1:
            ld, rd = _dim(node.left), _dim(node.comparators[0])
            if ld is not None and rd is not None and ld != rd:
                out.append(ctx.finding(
                    node, "unit-mix",
                    f"comparing {ld} against {rd}; the comparison is "
                    "meaningless without a conversion"))
        elif isinstance(node, ast.Assign):
            rd = _dim(node.value)
            if rd is None or _is_zero_like(node.value):
                continue
            for tgt in node.targets:
                td = _dim(tgt)
                if td is not None and td != rd:
                    out.append(ctx.finding(
                        node, "unit-assign",
                        f"{ast.unparse(tgt)} ({td}) assigned a {rd} value "
                        "with no conversion"))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            rd, td = _dim(node.value), _dim(node.target)
            if td is not None and rd is not None and td != rd:
                out.append(ctx.finding(
                    node, "unit-assign",
                    f"{ast.unparse(node.target)} ({td}) assigned a {rd} "
                    "value with no conversion"))
        elif isinstance(node, ast.AugAssign) and isinstance(
                node.op, (ast.Add, ast.Sub)):
            td, rd = _dim(node.target), _dim(node.value)
            if td is not None and rd is not None and td != rd:
                out.append(ctx.finding(
                    node, "unit-mix",
                    f"accumulating {rd} into {ast.unparse(node.target)} "
                    f"({td}); convert first"))
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg is None:
                    continue
                td, rd = _dim_of_name(kw.arg), _dim(kw.value)
                if td is not None and rd is not None and td != rd:
                    out.append(ctx.finding(
                        kw.value, "unit-assign",
                        f"keyword {kw.arg} ({td}) passed a {rd} value "
                        "with no conversion"))
    return out
