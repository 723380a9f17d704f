"""BJX122 recapture-risk: a captured call whose plan signature derives
from per-message data — an unbounded set of CUDA graphs.

``CapturedStep`` (``blendjax_torch/train/aot.py``) captures one CUDA
graph per distinct ``_plan_signature`` of its batch: each tensor's shape
and dtype, each host plan entry BY VALUE, and the batch's key set. Every
new signature is a capture (warm-up calls plus the capture itself) and
a graph with a private memory pool (~300 MiB for the palette form,
~1.6 GiB for StreamFormer on an H100). The repo's contract for
data-dependent sizes is the bucket ladder: per-message sizes pass
through ``pad_to_bucket``/the decode-plan capacity idiom, so the set of
signatures is small and fixed. A host plan entry fed straight from a
message (``step(state, {"tiles": t, "n": int(batch["count"])})``), or a
batch dict whose KEY SET was extended under a per-message-derived key
before the call, captures per distinct value — silent, each capture
seconds long, memory growth unbounded. That is the port's counterpart
of the JAX package's retrace.

Heuristics (all local to the calling function, by design — this is a
call-site property): an expression is *per-message-derived* when it
reads a parameter with a batch-ish name (``batch``/``msg``/``item``/
``frame``/``sample``/``row``...) or a local assigned from one;
derivation is laundered (bounded) by passing through a call whose name
carries a ``bucket``/``plan``/``pad``/``cap``/``quant`` segment. A host
plan entry is a dict entry (literal or subscript store) whose value is a
host scalar, string or tuple (``int(...)``, ``len(...)``, ``.item()``,
a ``.shape``), under a key that ``aot._UNKEYED`` does not leave out;
only ``CapturedStep``/``build_aot_step`` calls key by it. ANY captured
call is checked for the dynamic-key-set variant.
"""

from __future__ import annotations

from typing import Iterator

from blendjax_torch.analysis.core import Finding, ProjectRule, register
from blendjax_torch.analysis.project import ProjectContext


@register
class RecaptureRiskRule(ProjectRule):
    id = "BJX122"
    name = "recapture-risk"
    description = (
        "a host plan entry (or dict key set) of a captured call's batch "
        "derives from per-message/per-batch data without passing "
        "through the pad_to_bucket/decode-plan ladder"
    )

    def check_project(self, project: ProjectContext) -> Iterator[Finding]:
        df = project.dataflow()
        for nid in sorted(df.ir):
            ir = df.ir[nid]
            if not ir.retraces:
                continue
            module = project.by_path[nid[0]]
            seen: set[tuple[int, str]] = set()
            for ev in ir.retraces:
                dedup = (id(ev.node), ev.arg_desc)
                if dedup in seen:
                    continue
                seen.add(dedup)
                identity = (
                    f"{module.modname}.{nid[1]}:{ev.jit_desc}:{ev.arg_desc}"
                )
                if ev.keyset:
                    detail = (
                        f"dict '{ev.arg_desc}' gained a key derived from "
                        "per-message data before reaching "
                        f"{ev.jit_desc} — every distinct key set is a "
                        "fresh capture"
                    )
                else:
                    detail = (
                        f"host plan entry '{ev.arg_desc}' of "
                        f"{ev.jit_desc}'s batch derives from per-message "
                        "data — every distinct value is a fresh capture"
                    )
                yield self.finding(
                    module,
                    ev.node,
                    f"recapture risk in '{nid[1]}': {detail}; bound it "
                    "through the bucket ladder (pad_to_bucket / the "
                    "decode-plan capacity idiom) or hoist it to config, "
                    "or justify with '# bjx: ignore[BJX122]'",
                    identity=identity,
                )
