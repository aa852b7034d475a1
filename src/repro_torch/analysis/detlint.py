"""detlint: an AST-based determinism & invariant linter for the scheduling core.

Every CI gate in this repo ultimately rests on one property: schedule
sha256s are bit-identical across runs, machines, and the
fleet/streaming/serve fast paths.  The conventions that make that hold
are enforced dynamically (golden fixtures, fleet digest checks) — a
regression is found only *after* a golden fails.  detlint checks the
conventions statically, at lint time:

=======  ==============================================================
rule     convention it guards
=======  ==============================================================
DET001   no observable iteration over ``set``/``frozenset`` (or a
         dict built from one via ``dict.fromkeys``): set order is
         hash/ASLR-dependent and must never feed ordering-sensitive
         sinks (heap pushes, list materialization, schedule
         construction).  Wrap in ``sorted()`` with a total key.
DET002   no unseeded or global-state RNG: ``random.*``,
         ``np.random.<fn>`` convenience calls, and bare
         ``default_rng()`` are banned — core code draws from explicit
         ``default_rng([seed, ...])`` substreams.
DET003   no wall-clock reads (``time.time``/``perf_counter``/
         ``datetime.now`` ...) inside simulator/policy logic: the core
         is virtual-time-only.  Reporting-only instrumentation (the
         ``wall_s`` sites) is allowlisted in ``[tool.detlint]``.
DET004   no unordered filesystem enumeration (``os.listdir``,
         ``glob.glob``, ``Path.iterdir`` ...) without ``sorted()``:
         directory order is filesystem-dependent.
DET005   no plain ``sum()``/``+=`` float accumulation inside
         digest-bearing scopes (config ``digest_scopes`` or an inline
         ``# detlint: digest-path`` marker): use ``math.fsum`` or the
         Shewchuk-partials helpers so streaming == materialized.
DET006   no ``id()``/``hash()`` as a sort or grouping key: CPython
         object ids are allocation-order- and ASLR-dependent.
DET007   bounded-cache eviction (``.popitem()``) changes *which*
         entries are recomputed; it is digest-safe only when
         recomputation is bit-identical to the cached value — document
         that with a ``skip`` reason at the site.
=======  ==============================================================

(POL001/POL002 — SchedulingPolicy dispatch contract and
frozen-dataclass mutation — ride the same walker; see
``repro_torch.analysis.policy_rules``.)

Suppressions and markers
------------------------
``# detlint: skip=DET003(reason)`` on the finding's line (or on a
comment-only line immediately above it) suppresses that rule there; the
reason is mandatory — a bare ``skip=DET003`` or empty parens is itself
a finding (DET900).  Multiple directives:
``# detlint: skip=DET001(why), DET004(why)``.  ``# detlint:
digest-path`` on (or directly above) a ``def``/``class`` line marks the
scope digest-bearing for DET005.

Configuration (``[tool.detlint]`` in pyproject.toml)
----------------------------------------------------
``paths``/``exclude``/``ignore``/``select`` scope the run;
``[tool.detlint.det005] digest_scopes`` lists ``path::qualname``
digest-bearing scopes; ``[tool.detlint.per_rule_exclude]`` maps rule id
-> file globs; ``[[tool.detlint.allow]]`` entries (``rule``, ``path``,
optional ``context`` = enclosing def/class name, mandatory ``reason``)
form the structured allowlist — matching findings are reported as
allowed, not failures.  Python 3.11+ parses the file with ``tomllib``;
on 3.10 a strict mini-parser reads only the ``tool.detlint`` sections
(anything it cannot parse there fails loudly).

CLI
---
``python -m repro_torch.analysis.detlint [paths] [--format=text|json|github]``
Exit codes are stable: 0 = no unsuppressed findings, 1 = unsuppressed
findings (or malformed suppressions), 2 = usage/config error.
"""

from __future__ import annotations

import argparse
import ast
import fnmatch
import io
import json
import re
import sys
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "AllowEntry",
    "Config",
    "Finding",
    "Report",
    "Rule",
    "all_rules",
    "lint_paths",
    "load_config",
    "main",
    "register",
]


# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------


@dataclass
class Finding:
    """One rule violation at ``path:line:col`` (1-based line, 0-based col,
    matching ``ast`` and the GitHub annotation format)."""

    rule: str
    path: str  # config-root-relative posix path (or the path as given)
    line: int
    col: int
    message: str
    hint: str = ""
    qualname: str = ""  # enclosing def/class chain, e.g. "SimResult.add"
    suppressed: bool = False
    suppression: str = ""  # "inline" | "allowlist" | ""
    reason: str = ""

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "hint": self.hint,
            "qualname": self.qualname,
            "suppressed": self.suppressed,
            "suppression": self.suppression,
            "reason": self.reason,
        }


@dataclass
class Report:
    """Everything one ``lint_paths`` run produced."""

    findings: List[Finding]
    n_files: int

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def failed(self) -> bool:
        return bool(self.unsuppressed)


class UsageError(Exception):
    """Bad CLI arguments or configuration — exit code 2, never 1."""


# ---------------------------------------------------------------------------
# Inline directives: suppressions and markers
# ---------------------------------------------------------------------------

_DIRECTIVE_LINE = re.compile(r"#\s*detlint:\s*(?P<body>.*)$")
_SKIP_DIRECTIVE = re.compile(
    r"skip=(?P<rule>[A-Z]+\d+)\s*(?:\(\s*(?P<reason>[^()]*?)\s*\))?"
)
_MARKERS = frozenset({"digest-path"})

# Engine-level pseudo-rule for malformed/unrecognized directives: a
# suppression that cannot be parsed must fail the run, not silently
# suppress nothing.
DET900 = "DET900"
_DET900_SUMMARY = "malformed or unrecognized `# detlint:` directive"
_DET900_HINT = (
    "write `# detlint: skip=RULEID(reason)` — the reason is mandatory — "
    "or the scope marker `# detlint: digest-path`"
)


def _iter_comments(source: str) -> Iterator[Tuple[int, str]]:
    """Yield ``(lineno, text)`` for every real comment token — directives
    inside string literals/docstrings (e.g. this linter documenting its
    own syntax) must not parse as directives."""
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except tokenize.TokenizeError:  # pragma: no cover - ast.parse passed
        return


def _parse_directives(
    source: str,
) -> Tuple[Dict[int, Dict[str, str]], Dict[int, str], List[Tuple[int, str]]]:
    """Scan source comments for ``# detlint:`` directives.

    Returns ``(skips, markers, errors)``: ``skips`` maps lineno ->
    {rule: reason}, ``markers`` maps lineno -> marker name, ``errors``
    lists ``(lineno, message)`` for malformed directives.
    """
    skips: Dict[int, Dict[str, str]] = {}
    markers: Dict[int, str] = {}
    errors: List[Tuple[int, str]] = []
    for lineno, text in _iter_comments(source):
        m = _DIRECTIVE_LINE.search(text)
        if m is None:
            continue
        body = m.group("body").strip()
        if body in _MARKERS:
            markers[lineno] = body
            continue
        found = list(_SKIP_DIRECTIVE.finditer(body))
        if not found or not body.startswith("skip="):
            errors.append(
                (lineno, f"unrecognized detlint directive {body!r}")
            )
            continue
        per_line: Dict[str, str] = {}
        for d in found:
            rule, reason = d.group("rule"), d.group("reason")
            if reason is None or not reason.strip():
                errors.append(
                    (
                        lineno,
                        f"suppression for {rule} is missing its mandatory "
                        f"reason — write skip={rule}(why this is safe)",
                    )
                )
                continue
            per_line[rule] = reason.strip()
        if per_line:
            skips[lineno] = per_line
    return skips, markers, errors


# ---------------------------------------------------------------------------
# Per-module context shared by all rules
# ---------------------------------------------------------------------------

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Map local names to the dotted module path they were imported as.

    ``import numpy as np`` -> ``{"np": "numpy"}``; ``from numpy import
    random as npr`` -> ``{"npr": "numpy.random"}``; ``from time import
    perf_counter`` -> ``{"perf_counter": "time.perf_counter"}``.  Only
    absolute imports are tracked — the banned modules (time, random,
    numpy, os, glob, datetime) are never relative.
    """
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    head = a.name.split(".", 1)[0]
                    aliases[head] = head
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


class ModuleContext:
    """One linted file: source, AST, parent links, alias map, config."""

    def __init__(
        self, path: Path, rel_path: str, source: str, tree: ast.Module,
        config: "Config",
    ) -> None:
        self.path = path
        self.rel_path = rel_path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.config = config
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.aliases = _import_aliases(tree)
        self.skips, self.markers, self.directive_errors = _parse_directives(
            source
        )

    # -- structure queries ---------------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def qualname(self, node: ast.AST) -> str:
        """Enclosing def/class chain of ``node`` (excluding ``node``
        itself unless it is nested), e.g. ``"SimResult.add"``."""
        parts: List[str] = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, _SCOPE_NODES):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(parts))

    def enclosing_function(
        self, node: ast.AST
    ) -> Optional[ast.FunctionDef]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def has_marker(self, node: ast.AST, marker: str) -> bool:
        """True when ``marker`` sits on the node's first line or on the
        line directly above it (the conventional spot above a ``def``)."""
        lineno = getattr(node, "lineno", None)
        if lineno is None:
            return False
        return (
            self.markers.get(lineno) == marker
            or self.markers.get(lineno - 1) == marker
        )

    # -- name resolution -----------------------------------------------------

    def resolve_call(self, func: ast.AST) -> Optional[str]:
        """Dotted path of a call target *through the import aliases* —
        ``None`` when the root is a local name (so ``rng.random()`` on a
        Generator instance never resolves to ``random.random``)."""
        parts: List[str] = []
        node = func
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.aliases.get(node.id)
        if base is None:
            return None
        parts.append(base)
        return ".".join(reversed(parts))

    def raw_name(self, func: ast.AST) -> Optional[str]:
        """Bare callable name for builtins (``sorted``, ``list`` ...)."""
        if isinstance(func, ast.Name):
            return func.id
        return None

    def consumer_call(self, node: ast.AST) -> Optional[str]:
        """Name of the call consuming ``node`` as a direct argument
        (``sorted`` for ``sorted(<node>)``), else None."""
        parent = self.parents.get(node)
        if isinstance(parent, ast.Call) and any(
            arg is node for arg in parent.args
        ):
            return self.raw_name(parent.func) or self.resolve_call(
                parent.func
            )
        return None


# ---------------------------------------------------------------------------
# Rule base + registry
# ---------------------------------------------------------------------------


class Rule:
    """One lint rule.  Subclasses set ``id``/``summary``/``hint`` and the
    AST ``node_types`` they want dispatched; ``visit`` yields ``(node,
    message)`` pairs.  ``begin_module`` runs once per file for rules
    needing a module-level pre-analysis (symbol tables etc.)."""

    id: str = ""
    summary: str = ""
    hint: str = ""
    node_types: Tuple[type, ...] = ()

    def begin_module(self, ctx: ModuleContext) -> None:  # pragma: no cover
        pass

    def visit(
        self, node: ast.AST, ctx: ModuleContext
    ) -> Iterator[Tuple[ast.AST, str]]:
        raise NotImplementedError


_REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    """Class decorator adding a Rule to the global registry (the plug-in
    point: any module may register rules before ``lint_paths`` runs)."""
    if not issubclass(cls, Rule) or not cls.id:
        raise TypeError(f"{cls!r} is not a Rule with an id")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.id}")
    _REGISTRY[cls.id] = cls
    return cls


def all_rules() -> Dict[str, type]:
    """All registered rules (importing the sibling passes first)."""
    from . import policy_rules  # noqa: F401  (registers POL001/POL002)

    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# DET001 — unordered-container iteration
# ---------------------------------------------------------------------------

# Consumers whose result cannot observe iteration order.  ``sum`` is
# order-insensitive only for exact (int-like) elements — float addition
# rounds per add, so Det001SetIteration gates it on _int_like.
_ORDER_INSENSITIVE_CONSUMERS = frozenset(
    {"set", "frozenset", "len", "any", "all", "min", "max", "sum", "sorted"}
)
_SET_ANNOTATIONS = frozenset(
    {"set", "frozenset", "Set", "FrozenSet", "AbstractSet", "MutableSet"}
)


def _is_set_ctor(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in ("set", "frozenset")
    )


def _annotation_is_set(node: ast.AST) -> bool:
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):  # typing.Set etc.
        return node.attr in _SET_ANNOTATIONS
    return isinstance(node, ast.Name) and node.id in _SET_ANNOTATIONS


def _ref_key(node: ast.AST) -> Optional[str]:
    """Tracking key for a name: ``"x"`` or ``"self.x"``."""
    if isinstance(node, ast.Name):
        return node.id
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return f"self.{node.attr}"
    return None


@register
class Det001SetIteration(Rule):
    id = "DET001"
    summary = "iteration over an unordered set (or set-built dict)"
    hint = (
        "wrap in sorted() with a total, value-based key (or restructure "
        "so the order is never observable)"
    )
    node_types = (ast.For, ast.ListComp, ast.GeneratorExp, ast.Call)

    def begin_module(self, ctx: ModuleContext) -> None:
        # Flow-insensitive symbol table: any name (or self-attribute)
        # ever bound to a set constructor — or annotated as a set — is
        # treated as set-typed everywhere in the module.  Second phase
        # picks up dicts built from a tracked set via dict.fromkeys.
        tracked: set = set()
        assigns: List[Tuple[ast.AST, Optional[ast.AST]]] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    assigns.append((tgt, node.value))
            elif isinstance(node, ast.AnnAssign):
                key = _ref_key(node.target)
                if key and _annotation_is_set(node.annotation):
                    tracked.add(key)
                if node.value is not None:
                    assigns.append((node.target, node.value))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                for arg in (
                    *args.posonlyargs, *args.args, *args.kwonlyargs
                ):
                    if arg.annotation is not None and _annotation_is_set(
                        arg.annotation
                    ):
                        tracked.add(arg.arg)
        for tgt, value in assigns:
            key = _ref_key(tgt)
            if key and value is not None and _is_set_ctor(value):
                tracked.add(key)
        for tgt, value in assigns:  # dict.fromkeys(<tracked set>)
            key = _ref_key(tgt)
            if (
                key
                and isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr == "fromkeys"
                and isinstance(value.func.value, ast.Name)
                and value.func.value.id == "dict"
                and value.args
                and self._unordered_expr(value.args[0], tracked)
            ):
                tracked.add(key)
        self._tracked = tracked

    @staticmethod
    def _unordered_expr(node: ast.AST, tracked: set) -> bool:
        if _is_set_ctor(node):
            return True
        key = _ref_key(node)
        if key is not None and key in tracked:
            return True
        # s.keys()/.values()/.items() of a tracked (set-built) dict, or
        # .keys() of a tracked set-typed mapping-like name
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("keys", "values", "items")
            and not node.args
        ):
            inner = _ref_key(node.func.value)
            return inner is not None and inner in tracked
        return False

    def _unordered(self, node: ast.AST) -> bool:
        return self._unordered_expr(node, self._tracked)

    def visit(self, node, ctx):
        if isinstance(node, ast.For):
            if self._unordered(node.iter):
                yield node.iter, (
                    "for-loop iterates an unordered set: iteration order "
                    "is hash- and ASLR-dependent"
                )
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            consumer = ctx.consumer_call(node)
            if consumer in _ORDER_INSENSITIVE_CONSUMERS and (
                consumer != "sum" or _int_like(node.elt)
            ):
                return
            kind = (
                "list comprehension"
                if isinstance(node, ast.ListComp)
                else "generator"
            )
            for gen in node.generators:
                if self._unordered(gen.iter):
                    yield gen.iter, (
                        f"{kind} materializes unordered set iteration "
                        "into an ordered sequence"
                    )
        elif isinstance(node, ast.Call):
            name = ctx.raw_name(node.func)
            if name in ("list", "tuple", "enumerate") and node.args:
                if self._unordered(node.args[0]):
                    if ctx.consumer_call(node) == "sorted":
                        return
                    yield node, (
                        f"{name}() materializes unordered set iteration "
                        "into an ordered sequence"
                    )


# ---------------------------------------------------------------------------
# DET002 — unseeded / global-state RNG
# ---------------------------------------------------------------------------

# Explicit-state constructors under numpy.random that are fine to call.
_NP_RANDOM_OK = frozenset(
    {
        "default_rng",
        "Generator",
        "SeedSequence",
        "BitGenerator",
        "PCG64",
        "PCG64DXSM",
        "Philox",
        "MT19937",
        "SFC64",
    }
)


@register
class Det002GlobalRng(Rule):
    id = "DET002"
    summary = "unseeded or global-state RNG"
    hint = (
        "draw from an explicit numpy substream: "
        "rng = np.random.default_rng([seed, ...]); rng.<fn>(...)"
    )
    node_types = (ast.Call,)

    def visit(self, node, ctx):
        resolved = ctx.resolve_call(node.func)
        if resolved is None:
            return
        if resolved == "numpy.random.default_rng":
            if not node.args and not node.keywords:
                yield node, (
                    "bare default_rng() is OS-entropy-seeded: every run "
                    "draws a different stream"
                )
            return
        if resolved.startswith("numpy.random."):
            leaf = resolved.rsplit(".", 1)[1]
            if leaf not in _NP_RANDOM_OK:
                yield node, (
                    f"np.random.{leaf}() uses numpy's hidden global "
                    "RandomState: call order anywhere in the process "
                    "shifts the draws"
                )
            return
        if resolved == "random" or resolved.startswith("random."):
            leaf = resolved.rsplit(".", 1)[1] if "." in resolved else resolved
            if leaf == "Random":
                return  # explicit seeded instance is fine
            yield node, (
                f"random.{leaf}() uses the stdlib global (or OS-entropy) "
                "RNG state"
            )


# ---------------------------------------------------------------------------
# DET003 — wall-clock reads
# ---------------------------------------------------------------------------

_WALL_CLOCK = frozenset(
    {
        "time.time",
        "time.time_ns",
        "time.monotonic",
        "time.monotonic_ns",
        "time.perf_counter",
        "time.perf_counter_ns",
        "time.process_time",
        "time.process_time_ns",
        "time.clock_gettime",
        "datetime.datetime.now",
        "datetime.datetime.utcnow",
        "datetime.datetime.today",
        "datetime.date.today",
    }
)


@register
class Det003WallClock(Rule):
    id = "DET003"
    summary = "wall-clock read inside virtual-time core code"
    hint = (
        "the core is virtual-time-only — thread simulated time through; "
        "reporting-only instrumentation belongs in the [tool.detlint] "
        "allowlist with a reason"
    )
    node_types = (ast.Call,)

    def visit(self, node, ctx):
        resolved = ctx.resolve_call(node.func)
        if resolved in _WALL_CLOCK:
            yield node, (
                f"{resolved}() reads the wall clock: results become "
                "machine- and load-dependent"
            )


# ---------------------------------------------------------------------------
# DET004 — unordered filesystem enumeration
# ---------------------------------------------------------------------------

_FS_ENUM = frozenset(
    {"os.listdir", "os.scandir", "os.walk", "glob.glob", "glob.iglob"}
)
_FS_ENUM_METHODS = frozenset({"iterdir", "glob", "rglob"})


@register
class Det004FsOrder(Rule):
    id = "DET004"
    summary = "unordered filesystem enumeration"
    hint = "wrap the enumeration in sorted(): directory order is fs-dependent"
    node_types = (ast.Call,)

    def visit(self, node, ctx):
        resolved = ctx.resolve_call(node.func)
        name = None
        if resolved in _FS_ENUM:
            name = resolved
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _FS_ENUM_METHODS
            and resolved is None  # Path-like instance method
        ):
            name = f".{node.func.attr}"
        if name is None:
            return
        if ctx.consumer_call(node) == "sorted":
            return
        # also fine when it feeds a comprehension that sorted() consumes
        parent = ctx.parent(node)
        if (
            isinstance(parent, ast.comprehension)
            and ctx.consumer_call(ctx.parent(parent)) == "sorted"
        ):
            return
        yield node, (
            f"{name}() yields entries in filesystem order, which differs "
            "across machines and runs"
        )


# ---------------------------------------------------------------------------
# DET005 — naive float accumulation in digest-bearing scopes
# ---------------------------------------------------------------------------


def _int_like(node: ast.AST) -> bool:
    """Expressions that cannot introduce float rounding: int literals,
    len() calls, and unary +/- of those (counters, not accumulators)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, int) and not isinstance(
            node.value, bool
        )
    if isinstance(node, ast.UnaryOp):
        return _int_like(node.operand)
    if isinstance(node, ast.Call):
        return isinstance(node.func, ast.Name) and node.func.id == "len"
    return False


@register
class Det005FloatAccumulation(Rule):
    id = "DET005"
    summary = "plain float accumulation in a digest-bearing scope"
    hint = (
        "use math.fsum / the Shewchuk-partials helpers (_msum_add) so the "
        "aggregate is an order-independent correctly-rounded sum"
    )
    node_types = (ast.Call, ast.AugAssign)

    def _in_digest_scope(self, node: ast.AST, ctx: ModuleContext) -> bool:
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, _SCOPE_NODES) and ctx.has_marker(
                cur, "digest-path"
            ):
                return True
            cur = ctx.parents.get(cur)
        qn = ctx.qualname(node)
        for scope in ctx.config.digest_scopes:
            path_pat, _, qual = scope.partition("::")
            if not fnmatch.fnmatch(ctx.rel_path, path_pat):
                continue
            if not qual or qn == qual or qn.startswith(qual + "."):
                return True
        return False

    def visit(self, node, ctx):
        if isinstance(node, ast.Call):
            if ctx.raw_name(node.func) != "sum" or not node.args:
                return
            arg = node.args[0]
            if isinstance(arg, (ast.GeneratorExp, ast.ListComp)) and _int_like(
                arg.elt
            ):
                return  # sum(1 for ...) / sum(len(x) for ...): a counter
            if all(_int_like(a) for a in node.args):
                return
            if self._in_digest_scope(node, ctx):
                yield node, (
                    "builtin sum() accumulates left-to-right with per-add "
                    "rounding: the result depends on operand order"
                )
        else:  # AugAssign
            if not isinstance(node.op, ast.Add):
                return
            if _int_like(node.value):
                return  # += 1 style counters are exact
            if self._in_digest_scope(node, ctx):
                yield node, (
                    "+= float accumulation rounds per add: fold through "
                    "Shewchuk partials instead"
                )


# ---------------------------------------------------------------------------
# DET006 — id()/hash() as sort or grouping key
# ---------------------------------------------------------------------------

_KEYED_CALLABLES = frozenset(
    {"sorted", "min", "max", "nsmallest", "nlargest", "groupby", "sort"}
)


def _contains_id_or_hash(node: ast.AST) -> Optional[str]:
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Name)
            and sub.func.id in ("id", "hash")
        ):
            return sub.func.id
    if isinstance(node, ast.Name) and node.id in ("id", "hash"):
        return node.id  # key=id / key=hash passed directly
    return None


@register
class Det006IdentityKey(Rule):
    id = "DET006"
    summary = "id()/hash() used as a sort or grouping key"
    hint = (
        "key on a stable value (job_id, name, tuple of fields): object "
        "ids are allocation-order- and ASLR-dependent"
    )
    node_types = (ast.Call, ast.Subscript)

    def visit(self, node, ctx):
        if isinstance(node, ast.Call):
            name = ctx.raw_name(node.func)
            if name is None and isinstance(node.func, ast.Attribute):
                name = node.func.attr
            if name not in _KEYED_CALLABLES:
                return
            for kw in node.keywords:
                if kw.arg == "key":
                    fn = _contains_id_or_hash(kw.value)
                    if fn:
                        yield kw.value, (
                            f"{name}(key=...{fn}()...) orders by object "
                            "identity, which varies across runs"
                        )
        else:  # Subscript: d[id(x)] grouping
            sl = node.slice
            if (
                isinstance(sl, ast.Call)
                and isinstance(sl.func, ast.Name)
                and sl.func.id in ("id", "hash")
            ):
                yield node, (
                    f"container keyed by {sl.func.id}(): entry identity "
                    "varies across runs"
                )


# ---------------------------------------------------------------------------
# DET007 — bounded-cache eviction
# ---------------------------------------------------------------------------


@register
class Det007CacheEviction(Rule):
    id = "DET007"
    summary = "bounded-cache eviction (.popitem()) in schedule-feeding code"
    hint = (
        "eviction changes which entries are recomputed — digest-safe only "
        "when recomputation is bit-identical to the cached value; document "
        "that with a skip=DET007(reason) at the site"
    )
    node_types = (ast.Call,)

    def visit(self, node, ctx):
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "popitem"
        ):
            yield node, (
                "cache eviction via popitem(): safe only if a later "
                "recomputation reproduces the evicted entry byte for byte"
            )


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclass
class AllowEntry:
    """One structured-allowlist entry from ``[[tool.detlint.allow]]``."""

    rule: str
    path: str  # fnmatch glob over config-root-relative posix paths
    reason: str
    context: str = ""  # enclosing def/class name; "" matches anywhere

    def matches(self, finding: Finding) -> bool:
        if finding.rule != self.rule:
            return False
        if not fnmatch.fnmatch(finding.path, self.path):
            return False
        if not self.context:
            return True
        return self.context in finding.qualname.split(".")


@dataclass
class Config:
    root: Path = field(default_factory=Path.cwd)
    paths: List[str] = field(default_factory=list)
    exclude: List[str] = field(default_factory=list)
    ignore: List[str] = field(default_factory=list)
    select: List[str] = field(default_factory=list)
    per_rule_exclude: Dict[str, List[str]] = field(default_factory=dict)
    digest_scopes: List[str] = field(default_factory=list)
    allow: List[AllowEntry] = field(default_factory=list)


# -- TOML loading -----------------------------------------------------------


def _strip_toml_comment(line: str) -> str:
    out: List[str] = []
    quote = ""
    escaped = False
    for ch in line:
        if escaped:
            out.append(ch)
            escaped = False
            continue
        if quote == '"' and ch == "\\":
            out.append(ch)
            escaped = True
            continue
        if quote:
            if ch == quote:
                quote = ""
        elif ch in ('"', "'"):
            quote = ch
        elif ch == "#":
            break
        out.append(ch)
    return "".join(out)


_TOML_STRING = re.compile(r'"((?:[^"\\]|\\.)*)"|\'([^\']*)\'')


def _toml_unescape(s: str) -> str:
    return (
        s.replace("\\\\", "\x00")
        .replace('\\"', '"')
        .replace("\\n", "\n")
        .replace("\\t", "\t")
        .replace("\x00", "\\")
    )


def _split_toml_array(inner: str) -> List[str]:
    """Split array body on top-level commas, respecting quoted strings."""
    parts: List[str] = []
    buf: List[str] = []
    quote = ""
    escaped = False
    for ch in inner:
        if escaped:
            buf.append(ch)
            escaped = False
            continue
        if quote == '"' and ch == "\\":
            buf.append(ch)
            escaped = True
            continue
        if quote:
            buf.append(ch)
            if ch == quote:
                quote = ""
        elif ch in ('"', "'"):
            quote = ch
            buf.append(ch)
        elif ch == ",":
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    parts.append("".join(buf))
    return parts


def _parse_toml_value(text: str) -> object:
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise UsageError(
                f"unterminated array in [tool.detlint] config: {text!r}"
            )
        vals: List[str] = []
        for part in _split_toml_array(text[1:-1]):
            part = part.strip()
            if not part:  # trailing comma
                continue
            m = _TOML_STRING.fullmatch(part)
            if m is None:
                raise UsageError(
                    f"unsupported TOML array element in [tool.detlint] "
                    f"config: {part!r} (the 3.10 mini-parser supports "
                    "string arrays only)"
                )
            vals.append(
                _toml_unescape(m.group(1)) if m.group(1) is not None
                else m.group(2)
            )
        return vals
    m = _TOML_STRING.fullmatch(text)
    if m:
        return (
            _toml_unescape(m.group(1)) if m.group(1) is not None
            else m.group(2)
        )
    if text in ("true", "false"):
        return text == "true"
    if re.fullmatch(r"[+-]?\d+", text):
        return int(text)
    raise UsageError(
        f"unsupported TOML value in [tool.detlint] config: {text!r} "
        "(the 3.10 mini-parser reads strings, string arrays, booleans "
        "and integers)"
    )


def _parse_detlint_toml(text: str) -> Dict[str, object]:
    """Strict mini-parser for the ``tool.detlint`` sections of a
    pyproject.toml (the Python 3.10 fallback when ``tomllib`` is
    absent).  Sections outside ``tool.detlint`` are skipped verbatim;
    unsupported constructs *inside* it fail loudly."""
    root: Dict[str, object] = {}
    cur: Optional[Dict[str, object]] = None
    pending_key: Optional[str] = None
    pending_val = ""

    def open_section(name: str, is_array: bool) -> Optional[Dict[str, object]]:
        if name != "tool.detlint" and not name.startswith("tool.detlint."):
            return None
        node: Dict[str, object] = root
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})  # type: ignore[assignment]
        leaf = parts[-1]
        if is_array:
            lst = node.setdefault(leaf, [])
            if not isinstance(lst, list):
                raise UsageError(f"[[{name}]] conflicts with earlier table")
            entry: Dict[str, object] = {}
            lst.append(entry)
            return entry
        tbl = node.setdefault(leaf, {})
        if not isinstance(tbl, dict):
            raise UsageError(f"[{name}] conflicts with earlier array")
        return tbl

    for raw in text.splitlines():
        line = _strip_toml_comment(raw).strip()
        if pending_key is not None:
            pending_val += " " + line
            if pending_val.count("[") <= pending_val.count("]"):
                assert cur is not None
                cur[pending_key] = _parse_toml_value(pending_val)
                pending_key = None
                pending_val = ""
            continue
        if not line:
            continue
        if line.startswith("[["):
            cur = open_section(line.strip("[]").strip(), is_array=True)
            continue
        if line.startswith("["):
            cur = open_section(line.strip("[]").strip(), is_array=False)
            continue
        if cur is None:
            continue
        key, eq, value = line.partition("=")
        if not eq:
            raise UsageError(
                f"unparseable line in [tool.detlint] config: {raw!r}"
            )
        key = key.strip().strip('"')
        value = value.strip()
        if value.startswith("[") and value.count("[") > value.count("]"):
            pending_key, pending_val = key, value
            continue
        cur[key] = _parse_toml_value(value)
    if pending_key is not None:
        raise UsageError(
            f"unterminated array for key {pending_key!r} in [tool.detlint]"
        )
    return root


def _load_toml(path: Path) -> Dict[str, object]:
    try:
        import tomllib  # Python 3.11+
    except ImportError:  # pragma: no cover - exercised on 3.10 only
        return _parse_detlint_toml(path.read_text(encoding="utf-8"))
    with path.open("rb") as fh:
        return tomllib.load(fh)


_KNOWN_KEYS = frozenset(
    {
        "paths",
        "exclude",
        "ignore",
        "select",
        "allow",
        "det005",
        "per_rule_exclude",
    }
)


def _str_list(section: Dict[str, object], key: str) -> List[str]:
    val = section.get(key, [])
    if not isinstance(val, list) or not all(
        isinstance(v, str) for v in val
    ):
        raise UsageError(f"[tool.detlint] {key} must be a list of strings")
    return list(val)


def config_from_dict(data: Dict[str, object], root: Path) -> Config:
    """Build (and strictly validate) a :class:`Config` from parsed
    pyproject data.  Unknown keys and reason-less allow entries fail
    loudly — a typo must never silently disable a gate."""
    section = data.get("tool", {})
    section = section.get("detlint", {}) if isinstance(section, dict) else {}
    if not isinstance(section, dict):
        raise UsageError("[tool.detlint] must be a table")
    unknown = sorted(set(section) - _KNOWN_KEYS)
    if unknown:
        raise UsageError(
            f"unknown [tool.detlint] key(s): {', '.join(unknown)} "
            f"(known: {', '.join(sorted(_KNOWN_KEYS))})"
        )
    known_rules = set(all_rules()) | {DET900}

    def check_rules(ids: Iterable[str], where: str) -> None:
        bad = sorted(set(ids) - known_rules)
        if bad:
            raise UsageError(
                f"unknown rule id(s) in {where}: {', '.join(bad)}"
            )

    cfg = Config(
        root=root,
        paths=_str_list(section, "paths"),
        exclude=_str_list(section, "exclude"),
        ignore=_str_list(section, "ignore"),
        select=_str_list(section, "select"),
    )
    check_rules(cfg.ignore, "ignore")
    check_rules(cfg.select, "select")

    det005 = section.get("det005", {})
    if not isinstance(det005, dict) or set(det005) - {"digest_scopes"}:
        raise UsageError(
            "[tool.detlint.det005] supports exactly one key: digest_scopes"
        )
    cfg.digest_scopes = _str_list(det005, "digest_scopes")

    pre = section.get("per_rule_exclude", {})
    if not isinstance(pre, dict):
        raise UsageError("[tool.detlint.per_rule_exclude] must be a table")
    check_rules(pre, "per_rule_exclude")
    for rule_id, globs in pre.items():
        if not isinstance(globs, list) or not all(
            isinstance(g, str) for g in globs
        ):
            raise UsageError(
                f"per_rule_exclude.{rule_id} must be a list of globs"
            )
        cfg.per_rule_exclude[rule_id] = list(globs)

    allow = section.get("allow", [])
    if not isinstance(allow, list):
        raise UsageError("[[tool.detlint.allow]] must be an array of tables")
    for i, entry in enumerate(allow):
        if not isinstance(entry, dict) or set(entry) - {
            "rule",
            "path",
            "context",
            "reason",
        }:
            raise UsageError(
                f"allow entry #{i}: keys are rule, path, reason[, context]"
            )
        rule_id = entry.get("rule", "")
        path = entry.get("path", "")
        reason = str(entry.get("reason", "")).strip()
        check_rules([rule_id], f"allow entry #{i}")
        if not path:
            raise UsageError(f"allow entry #{i} ({rule_id}): path required")
        if not reason:
            raise UsageError(
                f"allow entry #{i} ({rule_id}, {path}): a reason is "
                "mandatory — say why the site is digest-safe"
            )
        cfg.allow.append(
            AllowEntry(
                rule=str(rule_id),
                path=str(path),
                reason=reason,
                context=str(entry.get("context", "")),
            )
        )
    return cfg


def load_config(
    config_path: Optional[Path] = None, no_config: bool = False
) -> Config:
    """Locate and parse ``[tool.detlint]``.  ``config_path`` points at a
    pyproject.toml; otherwise the nearest one upward from cwd is used.
    ``no_config`` (or no pyproject found) yields pure defaults."""
    if no_config:
        return Config()
    if config_path is None:
        cur = Path.cwd()
        for candidate in [cur, *cur.parents]:
            if (candidate / "pyproject.toml").is_file():
                config_path = candidate / "pyproject.toml"
                break
        if config_path is None:
            return Config()
    config_path = Path(config_path)
    if not config_path.is_file():
        raise UsageError(f"config file not found: {config_path}")
    data = _load_toml(config_path)
    return config_from_dict(data, root=config_path.resolve().parent)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def _collect_files(paths: Sequence[str], config: Config) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        pp = Path(p)
        if not pp.is_absolute():
            pp = config.root / pp
        if pp.is_dir():
            files.extend(sorted(pp.rglob("*.py")))
        elif pp.is_file():
            files.append(pp)
        else:
            raise UsageError(f"no such file or directory: {p}")
    out: List[Path] = []
    for f in dict.fromkeys(files):
        rel = _rel_path(f, config)
        if any(fnmatch.fnmatch(rel, pat) for pat in config.exclude):
            continue
        out.append(f)
    return out


def _rel_path(path: Path, config: Config) -> str:
    try:
        return path.resolve().relative_to(config.root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def _active_rules(
    config: Config,
    select: Optional[Sequence[str]],
    ignore: Optional[Sequence[str]],
) -> List[Rule]:
    registry = all_rules()
    selected = list(select or config.select) or sorted(registry)
    ignored = set(ignore or ()) | set(config.ignore)
    bad = sorted(set(selected) - set(registry))
    if bad:
        raise UsageError(f"unknown rule id(s): {', '.join(bad)}")
    return [
        registry[rid]() for rid in selected if rid not in ignored
    ]


def _lint_file(
    path: Path, config: Config, rules: Sequence[Rule]
) -> List[Finding]:
    rel = _rel_path(path, config)
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError) as exc:
        raise UsageError(f"cannot parse {rel}: {exc}") from exc
    ctx = ModuleContext(path, rel, source, tree, config)

    findings: List[Finding] = []
    for lineno, msg in ctx.directive_errors:
        findings.append(
            Finding(
                rule=DET900, path=rel, line=lineno, col=0,
                message=msg, hint=_DET900_HINT,
            )
        )

    active: List[Rule] = []
    dispatch: Dict[type, List[Rule]] = {}
    for rule in rules:
        globs = config.per_rule_exclude.get(rule.id, ())
        if any(fnmatch.fnmatch(rel, pat) for pat in globs):
            continue
        active.append(rule)
        for nt in rule.node_types:
            dispatch.setdefault(nt, []).append(rule)
    for rule in active:
        rule.begin_module(ctx)
    for node in ast.walk(tree):
        for rule in dispatch.get(type(node), ()):
            for target, message in rule.visit(node, ctx):
                findings.append(
                    Finding(
                        rule=rule.id,
                        path=rel,
                        line=getattr(target, "lineno", 0),
                        col=getattr(target, "col_offset", 0),
                        message=message,
                        hint=rule.hint,
                        qualname=ctx.qualname(target),
                    )
                )

    # Apply inline suppressions (same line, or a comment-only line just
    # above), then the structured allowlist.
    for f in findings:
        if f.rule == DET900:
            continue
        reason = _inline_reason(ctx, f)
        if reason is not None:
            f.suppressed = True
            f.suppression = "inline"
            f.reason = reason
            continue
        for entry in config.allow:
            if entry.matches(f):
                f.suppressed = True
                f.suppression = "allowlist"
                f.reason = entry.reason
                break
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def _inline_reason(ctx: ModuleContext, f: Finding) -> Optional[str]:
    direct = ctx.skips.get(f.line, {})
    if f.rule in direct:
        return direct[f.rule]
    above = ctx.skips.get(f.line - 1, {})
    if f.rule in above:
        prev = ctx.lines[f.line - 2].strip() if f.line >= 2 else ""
        if prev.startswith("#"):  # comment-only line
            return above[f.rule]
    return None


def lint_paths(
    paths: Sequence[str],
    config: Optional[Config] = None,
    select: Optional[Sequence[str]] = None,
    ignore: Optional[Sequence[str]] = None,
) -> Report:
    """Lint ``paths`` (files or trees) and return a :class:`Report`."""
    config = config or Config()
    rules = _active_rules(config, select, ignore)
    files = _collect_files(paths, config)
    findings: List[Finding] = []
    for path in files:
        findings.extend(_lint_file(path, config, rules))
    return Report(findings=findings, n_files=len(files))


# ---------------------------------------------------------------------------
# Output formats + CLI
# ---------------------------------------------------------------------------


def _emit_text(report: Report, show_suppressed: bool, out) -> None:
    for f in report.findings:
        if f.suppressed and not show_suppressed:
            continue
        tag = f" [suppressed: {f.suppression}]" if f.suppressed else ""
        print(f"{f.path}:{f.line}:{f.col}: {f.rule} {f.message}{tag}", file=out)
        if f.hint and not f.suppressed:
            print(f"    hint: {f.hint}", file=out)
    n = len(report.findings)
    bad = len(report.unsuppressed)
    print(
        f"detlint: {bad} finding(s) ({n - bad} suppressed/allowed) "
        f"in {report.n_files} file(s)",
        file=out,
    )


def _emit_json(report: Report, out) -> None:
    doc = {
        "version": 1,
        "n_files": report.n_files,
        "counts": {
            "total": len(report.findings),
            "unsuppressed": len(report.unsuppressed),
            "suppressed": len(report.findings) - len(report.unsuppressed),
        },
        "findings": [f.to_dict() for f in report.findings],
    }
    json.dump(doc, out, indent=2, sort_keys=True)
    out.write("\n")


def _emit_github(report: Report, out) -> None:
    """GitHub Actions workflow annotations (one ``::error`` per
    unsuppressed finding, shown inline on the diff)."""
    for f in report.unsuppressed:
        msg = f.message + (f" — {f.hint}" if f.hint else "")
        msg = msg.replace("%", "%25").replace("\n", "%0A")
        # Annotation columns are 1-based; Finding.col is an ast
        # col_offset (0-based).
        print(
            f"::error file={f.path},line={f.line},col={f.col + 1},"
            f"title=detlint {f.rule}::{msg}",
            file=out,
        )
    print(
        f"detlint: {len(report.unsuppressed)} finding(s) in "
        f"{report.n_files} file(s)",
        file=out,
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.detlint",
        description=(
            "Determinism & invariant linter for the scheduling core "
            "(see docs/DETERMINISM.md).  Exit codes: 0 clean, 1 findings, "
            "2 usage/config error."
        ),
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to lint (default: [tool.detlint] paths)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "github"), default="text",
        help="output format (github = workflow annotations)",
    )
    parser.add_argument(
        "--config", type=Path, default=None, metavar="PYPROJECT",
        help="pyproject.toml to read [tool.detlint] from "
        "(default: nearest upward from cwd)",
    )
    parser.add_argument(
        "--no-config", action="store_true",
        help="ignore pyproject.toml entirely (pure rule defaults)",
    )
    parser.add_argument(
        "--select", default="", metavar="IDS",
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--ignore", default="", metavar="IDS",
        help="comma-separated rule ids to skip",
    )
    parser.add_argument(
        "--show-suppressed", action="store_true",
        help="also print suppressed/allowed findings (text format)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print every registered rule and exit",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rid, cls in sorted(all_rules().items()):
            print(f"{rid}  {cls.summary}")
        print(f"{DET900}  {_DET900_SUMMARY} (engine-level)")
        return 0

    try:
        config = load_config(args.config, no_config=args.no_config)
        paths = list(args.paths) or list(config.paths)
        if not paths:
            raise UsageError(
                "no paths given and no [tool.detlint] paths configured"
            )
        report = lint_paths(
            paths,
            config=config,
            select=[s for s in args.select.split(",") if s] or None,
            ignore=[s for s in args.ignore.split(",") if s] or None,
        )
    except UsageError as exc:
        print(f"detlint: error: {exc}", file=sys.stderr)
        return 2

    if args.format == "json":
        _emit_json(report, sys.stdout)
    elif args.format == "github":
        _emit_github(report, sys.stdout)
    else:
        _emit_text(report, args.show_suppressed, sys.stdout)
    return 1 if report.failed else 0


if __name__ == "__main__":
    # Under ``python -m repro_torch.analysis.detlint`` this module object is
    # registered only as ``__main__``; ``all_rules()``'s
    # ``from . import policy_rules`` would then re-import detlint under
    # its canonical name, and the POL rules would register into that
    # second copy's registry instead of this one.  Alias the canonical
    # name to this module (or, if a canonical copy somehow already
    # exists, delegate to it) so there is exactly one registry.
    _canonical = sys.modules.setdefault(
        "repro_torch.analysis.detlint", sys.modules[__name__]
    )
    sys.exit(_canonical.main())
