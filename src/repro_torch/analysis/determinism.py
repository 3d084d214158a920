"""Determinism pass: every draw through named streams, no wall clocks.

The engine's same-seed bit-identity guarantee (tests/golden_engine_trace
and the invariants suite) holds only because every stochastic draw
routes through ``core.rng`` named streams and every timestamp is
simulation time. The four rules here catch the ways that discipline has
historically eroded:

- ``det-global-rng``: ``np.random.rand(...)``, ``random.random()`` and
  friends mutate interpreter-global generator state — two call sites
  silently couple, and import order changes results.
- ``det-wallclock``: ``time.time()`` / ``datetime.now()`` reads make
  output depend on when (and on which machine) the run happened.
  ``time.perf_counter`` / ``time.monotonic`` are allowed: they are
  duration timers for explicitly-timed bench regions, not wall clocks.
- ``det-raw-randomstate``: inside ``src/repro`` and ``src/repro_torch``
  (except each package's ``core.rng`` itself, which is the one place seed
  formulas may live) a direct ``np.random.RandomState(...)`` bypasses the
  named streams — adjacent integer seeds produce correlated streams, and
  the seed-formula sprawl is how the earlier ad-hoc seeding bugs happened.
- ``det-set-iter``: in the event-scheduling layers (``serverless/``,
  ``workflow/`` of either package) iteration order feeds event schedules,
  trace lines, and hashes; ``set`` iteration order depends on
  PYTHONHASHSEED, so an unsorted walk is a cross-process nondeterminism
  bug. ``sorted(s)`` is the fix (and is not flagged). ``dict.keys()``
  iteration is flagged in the same scope: it is insertion-ordered today,
  but the insertion order of these registries is itself
  schedule-dependent.

The port's copy of the JAX package's ``analysis/determinism.py``: the two
path-scoped rules also cover the port's own package, ``repro_torch``.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.analysis.core import (FileContext, Finding, dotted_name,
                                 register_rule)

register_rule("det-global-rng", "error",
              "global-state RNG call (np.random.<draw> / random.<draw>); "
              "use a core.rng named stream")
register_rule("det-wallclock", "warning",
              "wall-clock read (time.time / datetime.now); use simulation "
              "time, or time.perf_counter for timed bench regions")
register_rule("det-raw-randomstate", "warning",
              "direct np.random.RandomState construction inside "
              "src/repro or src/repro_torch; route through the package's "
              "core.rng named streams")
register_rule("det-set-iter", "warning",
              "iteration over a set (or dict.keys()) in an "
              "event-scheduling layer; wrap in sorted() for a "
              "hash-seed-independent order")

# the packages whose files the path-scoped rules cover: the JAX reference
# and its PyTorch port
PACKAGES = ("repro", "repro_torch")

# np.random attributes that are constructors/types, not global-state draws
_NP_RANDOM_OK = {
    "RandomState", "default_rng", "Generator", "SeedSequence",
    "BitGenerator", "MT19937", "PCG64", "PCG64DXSM", "Philox", "SFC64",
}

# stdlib random module functions that read/mutate the global generator
_PY_RANDOM_GLOBAL = {
    "random", "seed", "randint", "randrange", "choice", "choices",
    "shuffle", "sample", "uniform", "gauss", "normalvariate",
    "lognormvariate", "expovariate", "betavariate", "gammavariate",
    "triangular", "vonmisesvariate", "paretovariate", "weibullvariate",
    "getrandbits", "randbytes", "binomialvariate",
}

_WALLCLOCK = {
    "time.time", "time.time_ns", "time.localtime", "time.gmtime",
    "time.ctime", "time.asctime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}

# order-insensitive consumers: iterating a set inside these is fine
_ORDER_SAFE_CALLS = {
    "sorted", "len", "min", "max", "sum", "any", "all", "set", "frozenset",
}


class _Aliases:
    """Import-derived aliasing: which local names mean numpy, the stdlib
    random module, time, and datetime members."""

    def __init__(self, tree: ast.AST):
        self.numpy: Set[str] = set()        # import numpy as np -> {"np"}
        self.np_random: Set[str] = set()    # import numpy.random as npr
        self.py_random: Set[str] = set()    # import random [as r]
        self.time_mod: Set[str] = set()     # import time [as t]
        self.dt_mod: Set[str] = set()       # import datetime [as dt]
        self.dt_class: Set[str] = set()     # from datetime import datetime
        self.date_class: Set[str] = set()   # from datetime import date
        self.from_time: Set[str] = set()    # from time import time -> {"time"}
        self.from_random: Set[str] = set()  # from random import random, ...
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    name = a.asname or a.name.split(".")[0]
                    if a.name == "numpy":
                        self.numpy.add(name)
                    elif a.name == "numpy.random" and a.asname:
                        self.np_random.add(a.asname)
                    elif a.name == "random":
                        self.py_random.add(name)
                    elif a.name == "time":
                        self.time_mod.add(name)
                    elif a.name == "datetime":
                        self.dt_mod.add(name)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "datetime":
                    for a in node.names:
                        tgt = a.asname or a.name
                        if a.name == "datetime":
                            self.dt_class.add(tgt)
                        elif a.name == "date":
                            self.date_class.add(tgt)
                elif node.module == "time":
                    for a in node.names:
                        if a.name in ("time", "time_ns"):
                            self.from_time.add(a.asname or a.name)
                elif node.module == "random":
                    for a in node.names:
                        if a.name in _PY_RANDOM_GLOBAL:
                            self.from_random.add(a.asname or a.name)


def _rng_violation(dotted: str, al: _Aliases) -> Optional[str]:
    """Why a dotted call name is a global-state RNG call, or None."""
    parts = dotted.split(".")
    if len(parts) == 3 and parts[0] in al.numpy and parts[1] == "random":
        if parts[2] not in _NP_RANDOM_OK:
            return (f"np.random.{parts[2]} draws from numpy's global "
                    "generator")
    if len(parts) == 2:
        if parts[0] in al.np_random and parts[1] not in _NP_RANDOM_OK:
            return (f"numpy.random.{parts[1]} draws from numpy's global "
                    "generator")
        if parts[0] in al.py_random and parts[1] in _PY_RANDOM_GLOBAL:
            return (f"random.{parts[1]} draws from the interpreter-global "
                    "generator")
    return None


def _wallclock_violation(dotted: str, al: _Aliases) -> bool:
    parts = dotted.split(".")
    if len(parts) == 1:
        return parts[0] in al.from_time
    if len(parts) == 2:
        mod, fn = parts
        if mod in al.time_mod and f"time.{fn}" in _WALLCLOCK:
            return True
        if mod in al.dt_class and fn in ("now", "utcnow", "today"):
            return True
        if mod in al.date_class and fn == "today":
            return True
    if len(parts) == 3:
        mod, cls, fn = parts
        if mod in al.dt_mod and f"datetime.{cls}.{fn}" in _WALLCLOCK:
            return True
    return False


# -- set-iteration detection -------------------------------------------------

def _is_set_expr(node: ast.AST, local_sets: Set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in ("set", "frozenset"):
            return True
        if isinstance(fn, ast.Attribute) and fn.attr == "keys":
            return True                 # dict.keys(): see module docstring
        if isinstance(fn, ast.Attribute) and fn.attr in (
                "union", "intersection", "difference",
                "symmetric_difference"):
            return _is_set_expr(fn.value, local_sets)
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return (_is_set_expr(node.left, local_sets)
                or _is_set_expr(node.right, local_sets))
    if isinstance(node, ast.Name):
        return node.id in local_sets
    return False


def _local_set_names(scope: ast.AST) -> Set[str]:
    """Names assigned a provably-set value (and never a non-set value)
    anywhere in ``scope`` — a function body, or the module."""
    is_set: Dict[str, bool] = {}
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            val = _is_set_expr(node.value, set())
            is_set[name] = val and is_set.get(name, True)
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and isinstance(node.target, ast.Name):
            name = node.target.id
            val = _is_set_expr(node.value, set())
            is_set[name] = val and is_set.get(name, True)
    return {n for n, ok in is_set.items() if ok}


def _iter_sites(scope: ast.AST) -> Iterable[ast.AST]:
    """(site, iterated-expression) pairs inside one scope."""
    for node in ast.walk(scope):
        if isinstance(node, ast.For):
            yield node, node.iter
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.DictComp,
                               ast.SetComp)):
            for gen in node.generators:
                yield node, gen.iter
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("list", "tuple", "enumerate", "iter",
                                     "reversed") and node.args:
            yield node, node.args[0]


def _package_of(ctx: FileContext) -> Optional[str]:
    """The package (``repro`` or ``repro_torch``) a file lies in, or None."""
    return next((p for p in PACKAGES if ctx.in_dir(p)), None)


def check_file(ctx: FileContext) -> List[Finding]:
    al = _Aliases(ctx.tree)
    out: List[Finding] = []
    pkg = _package_of(ctx)
    in_repro = pkg is not None and not ctx.path.endswith(
        f"{pkg}/core/rng.py")
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = dotted_name(node.func)
        if dotted is None:
            continue
        why = _rng_violation(dotted, al)
        if why is not None:
            out.append(ctx.finding(node, "det-global-rng", why))
        elif _wallclock_violation(dotted, al):
            out.append(ctx.finding(
                node, "det-wallclock",
                f"{dotted}() reads the wall clock; results now depend on "
                "when the run happened (use time.perf_counter for "
                "durations, simulation time for schedules)"))
        elif in_repro and dotted.split(".")[-1] == "RandomState" and (
                len(dotted.split(".")) == 3
                and dotted.split(".")[0] in al.numpy
                or len(dotted.split(".")) == 2
                and dotted.split(".")[0] in al.np_random):
            out.append(ctx.finding(
                node, "det-raw-randomstate",
                f"construct streams via {pkg}.core.rng (stream/base_stream/"
                "worker_stream/...) so seed formulas live in one place"))

    if ctx.in_dir(*(f"{p}/{layer}" for p in PACKAGES
                    for layer in ("serverless", "workflow"))):
        scopes = [n for n in ast.walk(ctx.tree)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        module_sets = _local_set_names(ctx.tree)
        for scope in scopes or [ctx.tree]:
            local = module_sets | _local_set_names(scope)
            for site, it in _iter_sites(scope):
                if _is_set_expr(it, local):
                    out.append(ctx.finding(
                        site, "det-set-iter",
                        "iteration order over a set depends on "
                        "PYTHONHASHSEED and feeds the event schedule/"
                        "trace; iterate sorted(...) instead"))
    return out
