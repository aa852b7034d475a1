"""Policy-invariant lint pass: a second rule set on the detlint walker.

Two structural contracts the scheduling engine relies on, checked
statically alongside the determinism rules (same engine, same
suppressions, same CLI):

POL001 — the ``plan_pass`` dispatch contract.  The simulator's canonical
pass entry is ``plan_pass``; ``schedule`` survives only as the
pre-protocol name, and the engine binds *through ``schedule``* exactly when
a subclass overrides it.  That makes two shapes hazardous:

* a class overriding **both** ``schedule`` and ``plan_pass`` where
  ``schedule`` never delegates to ``self.plan_pass`` — the engine
  dispatches through ``schedule``, silently shadowing the ``plan_pass``
  override (the in-tree ``Policy`` base passes because its ``schedule``
  is exactly the delegation alias);
* a class overriding **only** ``schedule`` — legacy-supported but the
  wrong entry point for new code, and invisible to tooling that targets
  the protocol name.

POL002 — frozen-dataclass mutation.  ``object.__setattr__`` is the
sanctioned escape hatch *inside* ``__init__``/``__post_init__`` (how
``Scenario.__post_init__`` canonicalizes its event timeline); anywhere
else it mutates a value every reader assumes immutable — hashes, cached
``to_dict`` forms, and fleet-shared state go stale silently.
"""

from __future__ import annotations

import ast
from typing import Iterator, Tuple

from .detlint import Rule, register

__all__ = ["Pol001ScheduleDispatch", "Pol002FrozenMutation"]


def _is_policy_class(node: ast.ClassDef) -> bool:
    """Heuristic: the class, or any syntactic base, is Policy-named
    (``Policy``, ``SchedulingPolicy``, ``ASRPTPolicy`` ...) or the
    migration mixin that composes with them."""
    names = [node.name]
    for base in node.bases:
        if isinstance(base, ast.Name):
            names.append(base.id)
        elif isinstance(base, ast.Attribute):
            names.append(base.attr)
    return any(n.endswith("Policy") or n == "MigrationMixin" for n in names)


def _delegates_to_plan_pass(fn: ast.FunctionDef) -> bool:
    for sub in ast.walk(fn):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "plan_pass"
            and isinstance(sub.func.value, ast.Name)
            and sub.func.value.id == "self"
        ):
            return True
    return False


@register
class Pol001ScheduleDispatch(Rule):
    id = "POL001"
    summary = "schedule() override outside the PR-5 dispatch contract"
    hint = (
        "override plan_pass() (the SchedulingPolicy protocol entry); keep "
        "schedule() only as a delegation alias calling self.plan_pass()"
    )
    node_types = (ast.ClassDef,)

    def visit(
        self, node: ast.ClassDef, ctx
    ) -> Iterator[Tuple[ast.AST, str]]:
        if not _is_policy_class(node):
            return
        methods = {
            stmt.name: stmt
            for stmt in node.body
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        sched = methods.get("schedule")
        if sched is None:
            return
        if "plan_pass" in methods:
            if not _delegates_to_plan_pass(sched):
                yield sched, (
                    f"{node.name} overrides both schedule() and "
                    "plan_pass() but schedule() never calls "
                    "self.plan_pass(): the engine dispatches through "
                    "schedule(), silently shadowing the plan_pass() "
                    "override"
                )
        else:
            yield sched, (
                f"{node.name} overrides only schedule(), the pre-protocol "
                "(PR 1-4) pass entry"
            )


@register
class Pol002FrozenMutation(Rule):
    id = "POL002"
    summary = "object.__setattr__ outside __init__/__post_init__"
    hint = (
        "frozen dataclasses may only be written during construction; "
        "derive a new instance (dataclasses.replace) instead of mutating"
    )
    node_types = (ast.Call,)

    def visit(self, node: ast.Call, ctx) -> Iterator[Tuple[ast.AST, str]]:
        if not (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "__setattr__"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "object"
        ):
            return
        fn = ctx.enclosing_function(node)
        if fn is not None and fn.name in ("__init__", "__post_init__"):
            return
        where = f"inside {fn.name}()" if fn is not None else "at module scope"
        yield node, (
            f"object.__setattr__ {where} mutates a frozen value after "
            "construction: every reader (hashes, cached serializations, "
            "fleet-shared state) assumes it is immutable"
        )
