"""BJX117/118/119: the whole-program concurrency rules.

All three run over one :class:`~blendjax_torch.analysis.project.
ProjectContext` (the thread-spawn graph + lockset tables built from
the shared AST cache) instead of a single module:

- **BJX117 unlocked-shared-mutation** — the Eraser lockset algorithm
  (Savage et al., 1997), statically: an instance attribute written
  outside ``__init__`` and accessed from >= 2 thread contexts must
  have a NON-EMPTY intersection of the locks held over all its
  accesses; an empty intersection means some interleaving reads or
  writes the attribute unprotected.
- **BJX118 lock-order-inversion** — two locks acquired in inconsistent
  nesting order anywhere in the project (directly or through the
  resolvable call graph) is a latent deadlock; the ordering becomes a
  checked invariant instead of a review note.
- **BJX119 blocking-call-under-lock** — socket send/recv, ``join``,
  ``block_until_ready``, untimed ``wait``, or untimed queue ops while
  holding a lock that other threads contend turns one slow/dead peer
  into a fleet-wide wedge (a scenario service wedged by one dead
  producer, generalized).

Project findings carry an ``identity`` (attribute / lock pair / site
key) so their baseline fingerprints survive the line edits that fixing
neighbors causes — see ``docs/static-analysis.md`` "Whole-program
rules".
"""

from __future__ import annotations

import ast
from collections import defaultdict
from typing import Iterator

from blendjax_torch.analysis.core import Finding, ProjectRule, register
from blendjax_torch.analysis.project import (
    MAIN_CONTEXT,
    CallSite,
    ClassInfo,
    NodeId,
    ProjectContext,
)

QUEUE_TYPES = {
    "queue.Queue",
    "queue.SimpleQueue",
    "queue.LifoQueue",
    "queue.PriorityQueue",
}

_SOCKETISH = ("sock", "chan", "channel", "publisher", "receiver", "duplex")


def _ctx_label(ctx: str) -> str:
    return ctx if ctx == MAIN_CONTEXT else ctx.split(":", 1)[-1]


@register
class UnlockedSharedMutationRule(ProjectRule):
    id = "BJX117"
    name = "unlocked-shared-mutation"
    description = (
        "an instance attribute is written from >= 2 thread contexts "
        "with no common lock held over all its accesses (empty Eraser "
        "lockset intersection)"
    )

    def check_project(self, project: ProjectContext) -> Iterator[Finding]:
        for cls in project.classes.values():
            yield from self._check_class(project, cls)

    def _check_class(
        self, project: ProjectContext, cls: ClassInfo
    ) -> Iterator[Finding]:
        for attr, sites in sorted(project.attr_map(cls).items()):
            live = [(nid, a) for nid, a in sites if not a.init]
            if not any(a.write for _, a in live):
                continue  # config: only ever written during __init__
            ctxs: set[str] = set()
            for nid, _a in live:
                ctxs |= project.contexts.get(nid, set())
            if len(ctxs) < 2:
                continue  # single thread context: no interleaving
            locksets = [
                project.held_at(nid, a.held) for nid, a in live
            ]
            common = frozenset.intersection(*locksets)
            if common:
                continue  # one lock protects every access: Eraser-clean
            # anchor the finding at the first UNPROTECTED access,
            # preferring writes (that's where the fix goes)
            unprotected = [
                (nid, a)
                for (nid, a), ls in zip(live, locksets)
                if not ls
            ] or live
            unprotected.sort(
                key=lambda na: (
                    not na[1].write,
                    na[0][0],
                    getattr(na[1].node, "lineno", 0),
                )
            )
            nid, acc = unprotected[0]
            module = project.by_path[nid[0]]
            others = sorted(
                {
                    f"{n[0]}:{getattr(a.node, 'lineno', 0)}"
                    for n, a in unprotected[1:4]
                }
            )
            ctx_names = ", ".join(sorted(_ctx_label(c) for c in ctxs))
            yield self.finding(
                module,
                acc.node,
                f"attribute 'self.{attr}' of {cls.qual.rsplit('.', 1)[-1]} "
                f"is shared across thread contexts [{ctx_names}] but this "
                f"{'write' if acc.write else 'read'} in '{nid[1]}' holds no "
                "common lock (empty lockset intersection over all accesses"
                + (f"; also unguarded at {', '.join(others)}" if others else "")
                + ") — hold the object's lock here, or justify with "
                "'# bjx: ignore[BJX117]'",
                identity=f"{cls.qual}.{attr}",
            )


@register
class LockOrderInversionRule(ProjectRule):
    id = "BJX118"
    name = "lock-order-inversion"
    description = (
        "two locks are acquired in inconsistent nesting order somewhere "
        "in the project (latent deadlock)"
    )

    def check_project(self, project: ProjectContext) -> Iterator[Finding]:
        # ordered pairs (outer, inner) -> first site observed
        pairs: dict[tuple[str, str], tuple[NodeId, ast.AST]] = {}
        for nid, info in project.functions.items():
            for w in info.with_sites:
                held = project.held_at(nid, w.held_before)
                for outer in held:
                    if outer != w.lock:
                        pairs.setdefault((outer, w.lock), (nid, w.node))
            for call in info.calls:
                if call.target is None:
                    continue
                held = project.held_at(nid, call.held)
                if not held:
                    continue
                inner_locks = project.acquires.get(
                    call.target, frozenset()
                )
                for outer in held:
                    for inner in inner_locks:
                        if outer != inner:
                            pairs.setdefault(
                                (outer, inner), (nid, call.node)
                            )
        reported: set[frozenset[str]] = set()
        for (a, b), (nid, node) in sorted(
            pairs.items(), key=lambda kv: (kv[0][0], kv[0][1])
        ):
            if (b, a) not in pairs:
                continue
            key = frozenset((a, b))
            if key in reported:
                continue
            reported.add(key)
            other_nid, other_node = pairs[(b, a)]
            module = project.by_path[nid[0]]
            yield self.finding(
                module,
                node,
                f"lock order inversion: '{a}' -> '{b}' here in "
                f"'{nid[1]}' but '{b}' -> '{a}' in "
                f"{other_nid[0]}:{getattr(other_node, 'lineno', 0)} "
                f"('{other_nid[1]}') — pick one global order for this "
                "pair (latent deadlock under contention)",
                identity="<>".join(sorted((a, b))),
            )


@register
class BlockingCallUnderLockRule(ProjectRule):
    id = "BJX119"
    name = "blocking-call-under-lock"
    description = (
        "a blocking call (socket send/recv, join, block_until_ready, "
        "untimed wait/queue op) runs while holding a contended lock"
    )

    def check_project(self, project: ProjectContext) -> Iterator[Finding]:
        relevant = self._relevant_locks(project)
        for nid, info in project.functions.items():
            module = project.by_path[nid[0]]
            for call in info.calls:
                held = project.held_at(nid, call.held) & relevant
                if not held:
                    continue
                form = self._blocking_form(call)
                if form is None:
                    continue
                lock = sorted(held)[0]
                yield self.finding(
                    module,
                    call.node,
                    f"blocking {form} in '{nid[1]}' while holding "
                    f"'{lock}': a slow or dead peer stalls every thread "
                    "contending this lock — move the call outside the "
                    "lock, bound it with a timeout, or justify with "
                    "'# bjx: ignore[BJX119]'",
                    identity=(
                        f"{nid[0]}:{nid[1]}:{form}:{lock}"
                    ),
                )

    @staticmethod
    def _relevant_locks(project: ProjectContext) -> frozenset[str]:
        """Locks that other threads can actually contend: locks of
        classes whose methods run in >= 2 contexts (or are declared
        thread-shared), plus module-level locks of modules that spawn
        threads."""
        out: set[str] = set()
        union: dict[str, set[str]] = defaultdict(set)
        for nid, info in project.functions.items():
            if info.cls_qual:
                union[info.cls_qual] |= project.contexts.get(nid, set())
        for cls in project.classes.values():
            if cls.shared or len(union.get(cls.qual, ())) >= 2:
                out |= {f"{cls.qual}.{a}" for a in cls.lock_attrs}
        spawn_modules = {
            site[0] for site, _entry, _node in project.spawns
        }
        for var, lock in project.module_locks.items():
            mod = var.rsplit(".", 1)[0]
            if any(
                project.by_path[p].modname == mod for p in spawn_modules
            ):
                out.add(lock)
        return frozenset(out)

    @staticmethod
    def _blocking_form(call: CallSite) -> str | None:
        node = call.node
        func = node.func
        kw = {k.arg for k in node.keywords}
        kw_vals = {k.arg: k.value for k in node.keywords}

        def _timed() -> bool:
            if "timeout" in kw or "timeoutms" in kw:
                v = kw_vals.get("timeout", kw_vals.get("timeoutms"))
                return not (
                    isinstance(v, ast.Constant) and v.value is None
                )
            return False

        if not isinstance(func, ast.Attribute):
            return None
        m = func.attr
        if m == "block_until_ready":
            return "block_until_ready()"
        if m == "join" and not node.args and not _timed():
            return "join()"
        if m == "wait":
            if call.recv_type == "threading.Condition":
                return None  # cv.wait releases the lock by design
            if not node.args and not _timed():
                return "wait()"
            return None
        if m in ("get", "put"):
            queueish = call.recv_type in QUEUE_TYPES or any(
                h in call.recv_text.lower() for h in ("queue", "_cmds", "_q")
            )
            if not queueish or _timed():
                return None
            # positional timeout slot: get(block, timeout) /
            # put(item, block, timeout)
            if len(node.args) >= (2 if m == "get" else 3):
                return None
            block = kw_vals.get("block")
            if isinstance(block, ast.Constant) and block.value is False:
                return None
            if m == "get" and node.args:
                first = node.args[0]
                if isinstance(first, ast.Constant) and first.value is False:
                    return None
            return f"queue {m}() with no timeout"
        if m in ("send", "recv", "send_multipart", "recv_multipart", "call"):
            recv_type = (call.recv_type or "").lower()
            sockish = any(
                h in call.recv_text.lower() for h in _SOCKETISH
            ) or any(h in recv_type for h in _SOCKETISH)
            if sockish and not _timed():
                return f"socket {m}()"
        return None


__all__ = [
    "BlockingCallUnderLockRule",
    "LockOrderInversionRule",
    "UnlockedSharedMutationRule",
]
