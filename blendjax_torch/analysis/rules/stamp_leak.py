"""BJX120 stamp-leak-into-capture: a batch dict still carrying host-side
sidecar keys reaches a captured step's arguments.

The JAX package's bug of this class crashed at runtime with "not a
valid JAX type" only after a traced batch happened to arrive. The
port's captured step fails the same way, as rarely: ``CapturedStep``
keys its graphs by ``aot._plan_signature``, which hashes every host
value of the batch. A ``_traces`` list (``obs/trace.py:TRACES_KEY``)
is not among the keys ``aot._UNKEYED`` leaves out, so
``_plan_signature`` raises ``TypeError: unhashable type: 'list'`` on
the first sampled batch (``tests/test_torch_analysis.py`` pins it on
the CPU); a hashable stamp (``_seq``, ``_pub_wall``) is keyed by value
instead and captures a new graph, with a private memory pool, per
message. ``torch.cuda.make_graphed_callables`` takes tensors only and
refuses every sidecar. Statically, the shape is always the same: some
frame stamps a dict (subscript store of an underscored key, a stamped
dict literal, or a call returning a stamped batch), and the dict then
flows — through rebinding, copies, helper calls — to a captured callable
without an intervening strip (``.pop``, ``del``, a filtered rebuild, or
a helper like ``blendjax_torch.obs.lineage.strip_stamps`` whose summary
strips).

The keys a ``CapturedStep``/``build_aot_step`` set passes through by
design (``_meta``, ``_scenario``, ``_scenario_rows``, the draw token's
``_by_reference`` and ``_echo_counter``) are no leak into one.

The finding anchors in the frame where the taint ORIGINATES (that's
where the fix goes), at the call that starts the leaking chain; the
interprocedural part rides the per-function summaries of the
:class:`~blendjax_torch.analysis.project.Dataflow` layer, so a leak
through one or more call hops is still one finding.
"""

from __future__ import annotations

from typing import Iterator

from blendjax_torch.analysis.core import Finding, ProjectRule, register
from blendjax_torch.analysis.project import ProjectContext


@register
class StampLeakIntoCaptureRule(ProjectRule):
    id = "BJX120"
    name = "stamp-leak-into-capture"
    description = (
        "a batch dict that can carry host sidecar keys (_traces, _seq, "
        "lineage stamps, ...) reaches a captured step's arguments "
        "without an intervening strip/pop"
    )

    def check_project(self, project: ProjectContext) -> Iterator[Finding]:
        df = project.dataflow()
        for nid in sorted(df.flow_results):
            res = df.flow_results[nid]
            if not res.leaks:
                continue
            module = project.by_path[nid[0]]
            seen: set[tuple[int, frozenset[str]]] = set()
            for leak in res.leaks:
                dedup = (id(leak.node), leak.keys)
                if dedup in seen:
                    continue
                seen.add(dedup)
                keys = ", ".join(f"'{k}'" for k in sorted(leak.keys))
                if leak.via is None:
                    sink = f"captured {leak.jit_desc}"
                else:
                    sink = (
                        f"'{leak.via}', which forwards it into a "
                        "captured step"
                    )
                identity = (
                    f"{module.modname}.{nid[1]}:"
                    f"{'+'.join(sorted(leak.keys))}->"
                    f"{leak.via or leak.jit_desc}"
                )
                yield self.finding(
                    module,
                    leak.node,
                    f"batch dict carrying sidecar key(s) {keys} is passed "
                    f"to {sink} in '{nid[1]}' without an intervening "
                    "strip — pop the sidecars (strip_stamps / pop_traces "
                    "/ a filtered rebuild) before the captured call, or "
                    "justify with '# bjx: ignore[BJX120]'",
                    identity=identity,
                )
