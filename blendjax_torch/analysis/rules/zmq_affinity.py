"""BJX104 zmq-thread-affinity: sockets crossing thread boundaries.

ZMQ sockets are not thread-safe: a socket must be used only from the
thread that created it (libzmq's documented contract, and the reason
``RemoteStream`` defers socket construction to ``__iter__`` so the
PULL socket is born on the ingest thread that drains it). This rule
flags a class that creates a socket in one method, then spawns a
``threading.Thread`` whose target (transitively, within the class)
uses that socket attribute — unless the creation site, thread-spawn
site, or target ``def`` line carries a ``# bjx: thread-owner``
ownership-transfer annotation.
"""

from __future__ import annotations

import ast
from collections import defaultdict
from typing import Iterator

from blendjax_torch.analysis.core import (
    Finding,
    ModuleContext,
    Rule,
    dotted_name,
    register,
)

OWNER_MARKER = "bjx: thread-owner"


def _socket_attrs_created(method: ast.AST) -> dict[str, int]:
    """``self.X = ...socket(...)`` assignments -> attr name + line."""
    out: dict[str, int] = {}
    for node in ast.walk(method):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target = node.targets[0]
        if not (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
        ):
            continue
        for call in ast.walk(node.value):
            if (
                isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "socket"
            ):
                out[target.attr] = node.lineno
                break
    return out


def _self_attr_loads(method: ast.AST) -> set[str]:
    return {
        node.attr
        for node in ast.walk(method)
        if isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and isinstance(node.ctx, ast.Load)
    }


def _self_calls(method: ast.AST) -> set[str]:
    return {
        node.func.attr
        for node in ast.walk(method)
        if isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id == "self"
    }


@register
class ZmqThreadAffinityRule(Rule):
    id = "BJX104"
    name = "zmq-thread-affinity"
    description = (
        "a ZMQ socket created in one method is used from a "
        "threading.Thread target without a thread-owner annotation"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(module, node)

    def _check_class(
        self, module: ModuleContext, cls: ast.ClassDef
    ) -> Iterator[Finding]:
        methods = {
            item.name: item
            for item in cls.body
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        created: dict[str, tuple[str, int]] = {}
        for name, method in methods.items():
            for attr, line in _socket_attrs_created(method).items():
                created.setdefault(attr, (name, line))
        if not created:
            return

        # (Thread call node, target method name, spawning method)
        spawns: list[tuple[ast.Call, str, str]] = []
        for name, method in methods.items():
            for node in ast.walk(method):
                if not isinstance(node, ast.Call):
                    continue
                resolved = module.resolve(node.func) or ""
                if resolved.rsplit(".", 1)[-1] != "Thread":
                    continue
                # Thread(group, target, ...): target is the second
                # positional arg when not passed by keyword.
                target_node: ast.expr | None = next(
                    (kw.value for kw in node.keywords if kw.arg == "target"),
                    node.args[1] if len(node.args) >= 2 else None,
                )
                if target_node is None:
                    continue
                target = dotted_name(target_node) or ""
                if target.startswith("self."):
                    spawns.append((node, target[5:], name))

        calls: defaultdict[str, set[str]] = defaultdict(set)
        for name, method in methods.items():
            calls[name] = _self_calls(method) & set(methods)
        for node, target, _spawner in spawns:
            if target not in methods:
                continue
            reachable = set()
            frontier = [target]
            while frontier:
                m = frontier.pop()
                if m in reachable:
                    continue
                reachable.add(m)
                frontier.extend(calls[m])
            used = set()
            for m in reachable:
                used |= _self_attr_loads(methods[m])
            for attr in sorted(used & set(created)):
                creator, created_line = created[attr]
                if creator in reachable:
                    continue  # socket is born on the spawned thread itself
                if self._annotated(
                    module, node.lineno, created_line,
                    methods[target].lineno,
                ):
                    continue
                yield self.finding(
                    module,
                    node,
                    f"socket 'self.{attr}' created in "
                    f"'{cls.name}.{creator}' but used from thread target "
                    f"'{cls.name}.{target}': ZMQ sockets are single-thread "
                    "only (create it on the target thread, or annotate "
                    f"'# {OWNER_MARKER}' after handing off ownership)",
                )

    @staticmethod
    def _annotated(module: ModuleContext, *lines: int) -> bool:
        for line in lines:
            for probe in (line, line - 1):
                if OWNER_MARKER in module.line_text(probe):
                    return True
        return False
