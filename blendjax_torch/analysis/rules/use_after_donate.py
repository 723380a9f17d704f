"""BJX121 stale-alias-after-capture: a view of a captured step's state,
taken before the call, is read after it.

The static twin of the runtime donation audit
(:mod:`blendjax_torch.testing.donation`) and the complement of BJX112:
BJX112 makes captured steps write their state in place, this rule
catches callers that keep a view of that state across the call. Every
captured call (``CapturedStep``, ``build_aot_step``,
``make_graphed_callables``) writes its state argument, position 0, in
place. A name bound BEFORE the call to a view or alias of that state —
``.detach()``, ``.view(...)``, an item of ``state_dict()``,
``model.parameters()``, or the tensors themselves
(``state.params["w"]``) — holds the step's NEW values after it, and
every later replay overwrites it again. Reading that name after the
call (using it as the old values, returning it, or handing it to
another thread or the actor pool) without a ``.clone()`` or copy in
between is the PR 12 policy-sync bug in torch form: the JAX package
shipped a donated buffer to the actors, the port would ship a live view
the learner overwrites under them.

The JAX rule's loop form (a donated variable passed again in a loop
that never rebinds it) is no bug here: ``for b in batches:
step(state, b)`` is how a captured step is driven, and the state itself
is never flagged.
"""

from __future__ import annotations

from typing import Iterator

from blendjax_torch.analysis.core import Finding, ProjectRule, register
from blendjax_torch.analysis.project import ProjectContext


@register
class StaleAliasAfterCaptureRule(ProjectRule):
    id = "BJX121"
    name = "stale-alias-after-capture"
    description = (
        "a view or alias of a captured step's state argument, taken "
        "before the call, is read, returned or shipped after it without "
        "a clone"
    )

    def check_project(self, project: ProjectContext) -> Iterator[Finding]:
        df = project.dataflow()
        for nid in sorted(df.ir):
            ir = df.ir[nid]
            if not ir.donate_uses:
                continue
            module = project.by_path[nid[0]]
            for use in ir.donate_uses:
                identity = f"{module.modname}.{nid[1]}:{use.var}"
                yield self.finding(
                    module,
                    use.node,
                    f"stale alias in '{nid[1]}': '{use.var}' views "
                    f"'{use.state}', which {use.jit_desc} at line "
                    f"{getattr(use.donate_node, 'lineno', '?')} writes in "
                    "place — it now holds the new values and every later "
                    "replay overwrites it; .clone() it before the call, "
                    "or justify with '# bjx: ignore[BJX121]'",
                    identity=identity,
                )
