"""Contract-drift gate: code-derived string catalogs vs the docs.

``python -m blendjax_torch.analysis --contracts`` extracts three string-keyed
catalogs from the AST of the scanned modules and cross-checks each
against the documentation that promises to enumerate it:

- **metric names** at ``metrics.count/gauge/observe/span`` call sites
  (constant first arguments; f-strings contribute their constant
  prefix, e.g. ``f"ingest.recv.shard{i}"`` -> ``ingest.recv.shard*``)
  vs the tables in ``blendjax_torch/docs/observability.md``,
- **wire stamp/sidecar keys** (module-level ``*_KEY`` constants with
  underscored values, the analysis layer's sidecar universe, and the
  ``_batched``/``_prebatched`` control literals) vs
  ``blendjax_torch/docs/wire-protocol.md``,
- **``BLENDJAX_*`` env knobs** (string constants mentioning a knob
  name anywhere in code) vs the knob tables across ``blendjax_torch/docs/*.md``.

Both directions fail the gate as BJX123 findings: an **undocumented**
entry (in code, missing from the doc — anchored at the code site where
it is introduced) and a **stale** entry (documented, gone from the
code — anchored at the doc line). Doc-side matching is wildcard-aware:
``tiles.*`` documents every ``tiles.``-prefixed counter, and a
trailing ``N`` (``ingest.recv.shardN``) matches the f-string prefix
the code emits. Stale checking for metrics is scoped to name families
the code actually emits, so prose references to ``jax.jit`` or
``blendjax_torch.testing.donation`` never read as dead metrics.

Like the rest of bjx-lint this runs on stdlib only (``ast`` + ``re``)
so it works offline and inside Blender's Python.
"""

from __future__ import annotations

import ast
import os
import re

from blendjax_torch.analysis.core import Finding, ModuleContext
from blendjax_torch.analysis.project import (
    NON_SIDECAR_KEYS,
    SIDECAR_LITERAL_KEYS,
)

RULE = "BJX123"

#: Registry methods whose first argument names a metric.
_METRIC_METHODS = frozenset({
    "count", "gauge", "gauge_max", "observe", "observe_many", "span",
})

#: Wire-control literals: protocol keys that are spelled inline at
#: their pop/stamp sites rather than through a ``*_KEY`` constant.
_CONTROL_LITERALS = frozenset({"_batched", "_prebatched"})

_BACKTICK_RE = re.compile(r"`([^`]+)`")
_METRIC_NAME_RE = re.compile(
    r"^[a-z][a-z0-9_]*(?:\.(?:[a-z0-9_]+N?|\*))+$"
)
_STAMP_DOC_RE = re.compile(r"^(_[a-z][a-z0-9_]*)")
#: Backticked tokens that are artifact filenames, not metric names.
_FILEISH_SUFFIXES = (
    ".json", ".jsonl", ".md", ".py", ".txt", ".yml", ".yaml", ".bjr",
    ".btr", ".log",
)
_KNOB_RE = re.compile(r"\bBLENDJAX_[A-Z0-9_]+\b")
_KEY_CONST_RE = re.compile(r"^_[a-z][a-z0-9_]*$")

#: Docs that carry each catalog (relative to the docs directory).
#: The port's contract docs, relative to the repo root.
DOCS_DIR = os.path.join("blendjax_torch", "docs")
METRICS_DOC = "observability.md"
WIRE_DOC = "wire-protocol.md"


class Catalog:
    """One code-side catalog: exact names (and, for metrics, f-string
    prefixes), each mapped to the first code site that introduces it."""

    def __init__(self) -> None:
        self.names: dict[str, tuple[str, int, int]] = {}
        self.prefixes: dict[str, tuple[str, int, int]] = {}

    def add(self, name: str, site: tuple[str, int, int]) -> None:
        self.names.setdefault(name, site)

    def add_prefix(self, prefix: str, site: tuple[str, int, int]) -> None:
        self.prefixes.setdefault(prefix, site)


def _site(module: ModuleContext, node: ast.AST) -> tuple[str, int, int]:
    return (
        module.relpath,
        getattr(node, "lineno", 1),
        getattr(node, "col_offset", 0),
    )


def _is_registry_receiver(module: ModuleContext, recv: ast.expr) -> bool:
    """``metrics.count(...)``, ``self.registry.span(...)`` and friends:
    the receiver's final name segment is the registry convention."""
    resolved = module.resolve(recv)
    if resolved is not None:
        last = resolved.rsplit(".", 1)[-1]
        if last in ("metrics", "registry"):
            return True
    if isinstance(recv, ast.Attribute) and recv.attr in (
        "metrics", "registry",
    ):
        return True
    return False


def extract_metrics(modules: list[ModuleContext]) -> Catalog:
    cat = Catalog()
    for module in modules:
        # Locals bound to a constant or f-string name (the bounded
        # dynamic-name idiom: ``span_name = f"ingest.recv.shard{i}"``).
        name_binds: dict[str, ast.expr] = {}
        for assign in module.nodes(ast.Assign):
            if (
                len(assign.targets) == 1
                and isinstance(assign.targets[0], ast.Name)
                and isinstance(assign.value, (ast.Constant, ast.JoinedStr))
            ):
                name_binds[assign.targets[0].id] = assign.value
        for call in module.nodes(ast.Call):
            func = call.func
            if (
                not isinstance(func, ast.Attribute)
                or func.attr not in _METRIC_METHODS
                or not call.args
            ):
                continue
            if not _is_registry_receiver(module, func.value):
                continue
            arg = call.args[0]
            if isinstance(arg, ast.Name):
                arg = name_binds.get(arg.id, arg)
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                if "." in arg.value:
                    cat.add(arg.value, _site(module, call))
            elif isinstance(arg, ast.JoinedStr) and arg.values:
                head = arg.values[0]
                if (
                    isinstance(head, ast.Constant)
                    and isinstance(head.value, str)
                    and "." in head.value
                ):
                    cat.add_prefix(head.value, _site(module, call))
        # Table-driven emission: metric names listed in a module-level
        # ALL-CAPS spec table and observed in a loop (the frame-trace
        # transition table idiom) are names too.
        for node in module.tree.body:
            if not (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.isupper()
                and isinstance(node.value, (ast.Tuple, ast.List))
            ):
                continue
            for const in ast.walk(node.value):
                if (
                    isinstance(const, ast.Constant)
                    and isinstance(const.value, str)
                    and _METRIC_NAME_RE.match(const.value)
                ):
                    cat.add(const.value, _site(module, const))
    return cat


def extract_stamp_keys(modules: list[ModuleContext]) -> Catalog:
    cat = Catalog()
    literal_sites: dict[str, tuple[str, int, int]] = {}
    for module in modules:
        for node in module.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.endswith("_KEY")
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
                and _KEY_CONST_RE.match(node.value.value)
            ):
                cat.add(node.value.value, _site(module, node))
        for const in module.nodes(ast.Constant):
            if const.value in _CONTROL_LITERALS:
                literal_sites.setdefault(const.value, _site(module, const))
    for key, site in literal_sites.items():
        cat.add(key, site)
    # The analysis layer's own universe is part of the contract: a key
    # bjx-lint treats as a sidecar/array crossing must be documented
    # even when no scanned module declares it as a constant.
    for key in sorted(SIDECAR_LITERAL_KEYS | NON_SIDECAR_KEYS):
        if key not in cat.names:
            anchor = next(
                (m.relpath for m in modules), "blendjax_torch/analysis/project.py"
            )
            cat.add(key, (anchor, 1, 0))
    return cat


def extract_env_knobs(modules: list[ModuleContext]) -> Catalog:
    cat = Catalog()
    for module in modules:
        for const in module.nodes(ast.Constant):
            if not isinstance(const.value, str):
                continue
            for m in _KNOB_RE.finditer(const.value):
                cat.add(m.group(0), _site(module, const))
    return cat


# -- docs side ----------------------------------------------------------------


def _doc_lines(path: str) -> list[str]:
    try:
        with open(path, encoding="utf-8") as fh:
            return fh.read().splitlines()
    except OSError:
        return []


def documented_metrics(lines: list[str]) -> dict[str, int]:
    """Backticked, metric-shaped names -> first doc line (1-based)."""
    out: dict[str, int] = {}
    for i, line in enumerate(lines, 1):
        for m in _BACKTICK_RE.finditer(line):
            token = m.group(1).strip()
            if token.endswith(_FILEISH_SUFFIXES):
                continue
            if _METRIC_NAME_RE.match(token):
                out.setdefault(token, i)
    return out


def documented_stamp_keys(lines: list[str]) -> dict[str, int]:
    out: dict[str, int] = {}
    for i, line in enumerate(lines, 1):
        for m in _BACKTICK_RE.finditer(line):
            km = _STAMP_DOC_RE.match(m.group(1).strip())
            if km:
                out.setdefault(km.group(1), i)
    return out


def documented_knobs(lines: list[str]) -> dict[str, int]:
    out: dict[str, int] = {}
    for i, line in enumerate(lines, 1):
        for m in _KNOB_RE.finditer(line):
            # "BLENDJAX_BENCH_*" family references leave a trailing
            # underscore once the regex stops at the wildcard — not a
            # knob name.
            if m.group(0).endswith("_"):
                continue
            out.setdefault(m.group(0), i)
    return out


# -- matching -----------------------------------------------------------------


def _metric_documented(name: str, docs: dict[str, int]) -> bool:
    if name in docs:
        return True
    for d in docs:
        if d.endswith(".*") and name.startswith(d[:-1]):
            return True
    return False


def _prefix_documented(prefix: str, docs: dict[str, int]) -> bool:
    for d in docs:
        base = d[:-1] if d.endswith(("*", "N")) else d
        if base.startswith(prefix) or prefix.startswith(base):
            return True
    return False


def _doc_metric_live(d: str, cat: Catalog) -> bool:
    base = d[:-1] if d.endswith(("*", "N")) else d
    if d in cat.names:
        return True
    for name in cat.names:
        if d.endswith(("*", "N")) and name.startswith(base):
            return True
    for prefix in cat.prefixes:
        if base.startswith(prefix) or prefix.startswith(base):
            return True
    return False


def check_contracts(
    modules: list[ModuleContext], root: str, docs_dir: str | None = None
) -> list[Finding]:
    """Cross-check every catalog both ways; returns BJX123 findings."""
    docs_dir = docs_dir or os.path.join(root, DOCS_DIR)
    findings: list[Finding] = []

    def emit(path, line, col, message, identity):
        findings.append(
            Finding(RULE, path, line, col, message, identity=identity)
        )

    def docrel(name: str) -> str:
        return os.path.relpath(os.path.join(docs_dir, name), root)

    # metrics <-> docs/observability.md
    metrics = extract_metrics(modules)
    mdoc_path = os.path.join(docs_dir, METRICS_DOC)
    mdocs = documented_metrics(_doc_lines(mdoc_path))
    for name, (path, line, col) in sorted(metrics.names.items()):
        if not _metric_documented(name, mdocs):
            emit(
                path, line, col,
                f"metric '{name}' is emitted here but not documented in "
                f"{docrel(METRICS_DOC)} — add it to the metric tables or "
                "drop the emission",
                identity=f"metric:{name}",
            )
    for prefix, (path, line, col) in sorted(metrics.prefixes.items()):
        if not _prefix_documented(prefix, mdocs):
            emit(
                path, line, col,
                f"dynamic metric family '{prefix}*' is emitted here but "
                f"no matching entry exists in {docrel(METRICS_DOC)}",
                identity=f"metric:{prefix}*",
            )
    families = {n.split(".", 1)[0] for n in metrics.names}
    families |= {p.split(".", 1)[0] for p in metrics.prefixes}
    for d, line in sorted(mdocs.items()):
        if d.split(".", 1)[0] not in families:
            continue  # prose reference outside the metric namespace
        if not _doc_metric_live(d, metrics):
            emit(
                docrel(METRICS_DOC), line, 0,
                f"documented metric '{d}' is never emitted by the "
                "scanned code — stale docs entry",
                identity=f"stale-metric:{d}",
            )

    # stamp keys <-> docs/wire-protocol.md
    stamps = extract_stamp_keys(modules)
    sdocs = documented_stamp_keys(_doc_lines(os.path.join(docs_dir, WIRE_DOC)))
    for key, (path, line, col) in sorted(stamps.names.items()):
        if key not in sdocs:
            emit(
                path, line, col,
                f"wire sidecar key '{key}' is part of the protocol but "
                f"not documented in {docrel(WIRE_DOC)}",
                identity=f"stamp:{key}",
            )
    for key, line in sorted(sdocs.items()):
        if key not in stamps.names:
            emit(
                docrel(WIRE_DOC), line, 0,
                f"documented wire key '{key}' no longer appears in the "
                "scanned code — stale docs entry",
                identity=f"stale-stamp:{key}",
            )

    # env knobs <-> docs/*.md
    knobs = extract_env_knobs(modules)
    kdocs: dict[str, tuple[str, int]] = {}
    try:
        doc_files = sorted(os.listdir(docs_dir))
    except OSError:
        doc_files = []
    for name in doc_files:
        if not name.endswith(".md"):
            continue
        for knob, line in documented_knobs(
            _doc_lines(os.path.join(docs_dir, name))
        ).items():
            kdocs.setdefault(knob, (docrel(name), line))
    for knob, (path, line, col) in sorted(knobs.names.items()):
        if knob not in kdocs:
            emit(
                path, line, col,
                f"env knob '{knob}' is read here but documented in no "
                f"{DOCS_DIR}/*.md knob table",
                identity=f"knob:{knob}",
            )
    for knob, (doc_path, line) in sorted(kdocs.items()):
        if knob not in knobs.names:
            emit(
                doc_path, line, 0,
                f"documented env knob '{knob}' is read nowhere in the "
                "scanned code — stale docs entry",
                identity=f"stale-knob:{knob}",
            )

    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


__all__ = [
    "Catalog",
    "RULE",
    "check_contracts",
    "documented_knobs",
    "documented_metrics",
    "documented_stamp_keys",
    "extract_env_knobs",
    "extract_metrics",
    "extract_stamp_keys",
]
