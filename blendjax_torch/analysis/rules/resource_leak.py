"""BJX105 socket-leak: socket/context creation without close on all paths.

A leaked ZMQ socket keeps its context's ``term()`` blocked forever (the
reason ``blendjax_torch.transport.term_context`` exists at all), and a leaked
context keeps an IO thread alive past interpreter shutdown. This rule
does a function-local walk: a socket (``*.socket(...)``) or context
(``zmq.Context()``) bound to a local name must be closed/termed on
every path — an unconditional ``close()``, a ``finally`` block, or a
``with`` statement all count; ownership transfers (returned, yielded,
stored on an object, passed to a call, aliased) exempt the name.
"""

from __future__ import annotations

import ast
from typing import Iterator

from blendjax_torch.analysis.core import (
    Finding,
    FunctionNode,
    ModuleContext,
    Rule,
    register,
    walk_shallow,
)

CLOSE_METHODS = {"close", "term", "destroy"}


def _creations(
    module: ModuleContext, fn: ast.AST
) -> Iterator[tuple[str, str, ast.Assign]]:
    """Function-local ``name = ...socket(...)`` / ``name = zmq.Context()``."""
    for node in walk_shallow(fn):
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
        ):
            continue
        func = node.value.func
        kind = None
        if isinstance(func, ast.Attribute) and func.attr == "socket":
            kind = "socket"
        else:
            resolved = module.resolve(func) or ""
            if resolved in ("zmq.Context", "zmq.asyncio.Context"):
                kind = "context"
        if kind is not None:
            yield node.targets[0].id, kind, node


def _transferred(fn: ast.AST, name: str, creation: ast.Assign) -> bool:
    """Ownership left the function: the BARE name is returned/yielded,
    passed to a call, or re-assigned (aliased / stored on an object or
    in a container). Using the socket — ``msg = sock.recv()``,
    ``f(sock.recv())`` — is NOT a transfer: only the object itself
    crossing a boundary exempts the leak check."""
    for node in ast.walk(fn):
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            value = node.value
            if value is not None and _is_bare(value, name):
                return True
        elif isinstance(node, ast.Call):
            if any(_is_bare(a, name) for a in node.args):
                return True
            if any(_is_bare(k.value, name) for k in node.keywords):
                return True
        elif isinstance(node, ast.Assign) and node is not creation:
            if _is_bare(node.value, name):
                return True
    return False


def _is_bare(node: ast.AST, name: str) -> bool:
    """The name itself (possibly inside container literals), not an
    expression merely derived from it."""
    if isinstance(node, ast.Name):
        return node.id == name
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return any(_is_bare(e, name) for e in node.elts)
    if isinstance(node, ast.Dict):
        return any(
            v is not None and _is_bare(v, name)
            for v in (*node.keys, *node.values)
        )
    if isinstance(node, ast.Starred):
        return _is_bare(node.value, name)
    return False


def _is_close(stmt: ast.stmt, name: str) -> bool:
    return (
        isinstance(stmt, ast.Expr)
        and isinstance(stmt.value, ast.Call)
        and isinstance(stmt.value.func, ast.Attribute)
        and stmt.value.func.attr in CLOSE_METHODS
        and isinstance(stmt.value.func.value, ast.Name)
        and stmt.value.func.value.id == name
    )


def _guarantees_close(stmts: list[ast.stmt], name: str) -> bool:
    """True if this statement sequence closes ``name`` on every path
    through it (simple structural CFG: if/else both close, or a
    try/finally closes, or an unconditional close/with)."""
    for stmt in stmts:
        if _is_close(stmt, name):
            return True
        if isinstance(stmt, ast.With):
            if any(
                isinstance(item.context_expr, ast.Name)
                and item.context_expr.id == name
                for item in stmt.items
            ):
                return True
            if _guarantees_close(stmt.body, name):
                return True
        elif isinstance(stmt, ast.If):
            if _guarantees_close(stmt.body, name) and _guarantees_close(
                stmt.orelse, name
            ):
                return True
        elif isinstance(stmt, ast.Try):
            if _guarantees_close(stmt.finalbody, name):
                return True
    return False


def _containing_block(fn: FunctionNode, creation: ast.Assign) -> list[ast.stmt]:
    """The statement list the creation is a direct element of — the
    scope whose paths must close the socket (a socket created inside an
    ``if``/loop body only exists on that path, so a close in the same
    block covers it)."""
    for node in ast.walk(fn):
        for field in ("body", "orelse", "finalbody"):
            block = getattr(node, field, None)
            if isinstance(block, list) and creation in block:
                return block
    return fn.body


def _any_close(fn: ast.AST, name: str) -> bool:
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in CLOSE_METHODS
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == name
        ):
            return True
    return False


@register
class SocketLeakRule(Rule):
    id = "BJX105"
    name = "socket-leak"
    description = (
        "function-local ZMQ socket/context creation without a "
        "close()/term() on every path (and no ownership transfer)"
    )

    def check(self, module: ModuleContext) -> Iterator[Finding]:
        for qual, fn, _cls in module.iter_functions():
            for name, kind, creation in _creations(module, fn):
                if _transferred(fn, name, creation):
                    continue
                # Either the block the socket is born in closes it on
                # every path, or the function's top level does (close
                # hoisted below a conditional creation).
                if _guarantees_close(
                    _containing_block(fn, creation), name
                ) or _guarantees_close(fn.body, name):
                    continue
                if _any_close(fn, name):
                    how = (
                        "closed only on some paths (move the "
                        f"{'close()' if kind == 'socket' else 'term()'} "
                        "into a finally block or use a with statement)"
                    )
                else:
                    how = (
                        "never closed (a leaked "
                        + ("socket blocks context term() forever"
                           if kind == "socket"
                           else "context keeps an IO thread alive")
                        + ")"
                    )
                yield self.finding(
                    module,
                    creation,
                    f"{kind} '{name}' in '{qual}' is {how}",
                )
