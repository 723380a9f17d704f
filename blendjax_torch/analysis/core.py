"""Rule framework: findings, registry, suppressions, baseline.

Design constraints:

- stdlib only (``ast`` + ``json``): the linter must run on the producer
  side (Blender's Python) and in CI with ``JAX_PLATFORMS=cpu`` without
  importing jax, zmq, or numpy.
- line-number independent baseline: entries are fingerprinted by
  (rule, path, normalized source line, occurrence index) so unrelated
  edits above a grandfathered finding don't invalidate the baseline.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from collections import defaultdict
from typing import TYPE_CHECKING, Callable, Iterable, Iterator

if TYPE_CHECKING:  # runtime import would be circular (project -> core)
    from blendjax_torch.analysis.project import ProjectContext

#: The port's committed baseline, beside this module (empty for the
#: rules of this package: every finding is repaired or suppressed with
#: a justification).
BASELINE_DEFAULT = os.path.join(os.path.dirname(__file__), "baseline.json")

FunctionNode = ast.FunctionDef | ast.AsyncFunctionDef

_SUPPRESS_RE = re.compile(
    r"#\s*bjx:\s*ignore(?:\[(?P<rules>[A-Za-z0-9_,\s]+)\])?"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: ``path:line:col RULE message``.

    ``identity`` is the project-level fingerprint key: whole-program
    rules (BJX117+) identify a finding by what it is ABOUT (an
    attribute, a lock pair) rather than by the source line it happens
    to anchor to, so a baselined project finding survives edits that
    move or reword the anchor line. ``None`` = per-file fingerprinting
    (rule, path, message, line text, occurrence)."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    identity: str | None = None

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: {self.rule} {self.message}"


class Rule:
    """Base class: subclasses set ``id``/``name``/``description`` and
    implement ``check(module) -> iterable of Finding``."""

    id: str = ""
    name: str = ""
    description: str = ""
    #: True for whole-program rules (run once over a ProjectContext,
    #: not per module) — see :class:`ProjectRule`.
    project: bool = False

    def check(self, module: "ModuleContext") -> Iterable[Finding]:
        raise NotImplementedError

    def finding(
        self,
        module: "ModuleContext",
        node: ast.AST,
        message: str,
        identity: str | None = None,
    ) -> Finding:
        return Finding(
            rule=self.id,
            path=module.relpath,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
            identity=identity,
        )


class ProjectRule(Rule):
    """Whole-program rule: runs once over a :class:`~blendjax_torch.analysis.
    project.ProjectContext` built from EVERY module in the run (shared
    AST cache — the same parsed ``ModuleContext`` objects the per-file
    rules used). Subclasses implement ``check_project``; ``check`` is
    deliberately unused (a project rule has no meaningful per-module
    answer)."""

    project = True

    def check(self, module: "ModuleContext") -> Iterable[Finding]:
        return ()

    def check_project(self, project: "ProjectContext") -> Iterable[Finding]:
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    """Class decorator: instantiate and add to the rule registry."""
    rule = cls()
    assert rule.id and rule.id not in _REGISTRY, f"bad rule id {rule.id!r}"
    _REGISTRY[rule.id] = rule
    return cls


def all_rules() -> dict[str, Rule]:
    """Registry, importing the built-in rule modules on first use."""
    import blendjax_torch.analysis.rules  # noqa: F401  (registration side effect)

    return dict(_REGISTRY)


def walk_shallow(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's nodes WITHOUT descending into nested function/
    class definitions (those are separate ``iter_functions`` entries, so
    crossing the boundary double-reports their findings). Lambdas are
    NOT a boundary: they have no ``iter_functions`` entry of their own,
    so their bodies belong to the enclosing function's scan."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            stack.extend(ast.iter_child_nodes(node))


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class ModuleContext:
    """Parsed module plus the lookup tables every rule needs."""

    def __init__(self, source: str, relpath: str) -> None:
        self.source = source
        self.relpath = relpath.replace(os.sep, "/")
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self.parents: dict[ast.AST, ast.AST] = {}
        # One walk builds BOTH the parent table and the by-type node
        # index every rule shares (``nodes()``) — rules and the project
        # pass stop re-walking the tree per rule.
        self._by_type: dict[type, list[ast.AST]] = defaultdict(list)
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
                self._by_type[type(child)].append(child)
        self.imports = self._import_table()
        self.suppressions = self._suppression_table()
        self._functions: (
            list[tuple[str, FunctionNode, ast.ClassDef | None]] | None
        ) = None

    @property
    def modname(self) -> str:
        """Dotted module name derived from the relpath
        (``blendjax_torch/fleet/controller.py`` -> ``blendjax_torch.fleet.
        controller``; package ``__init__`` collapses to the package)."""
        name = self.relpath[:-3] if self.relpath.endswith(".py") else self.relpath
        parts = [p for p in name.split("/") if p]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    def nodes(self, *types: type) -> list[ast.AST]:
        """All nodes of the given AST types, from the shared one-walk
        index (use instead of a per-rule ``ast.walk(module.tree)``)."""
        out: list[ast.AST] = []
        for t in types:
            out.extend(self._by_type.get(t, ()))
        return out

    # -- imports ------------------------------------------------------------

    def _import_table(self) -> dict[str, str]:
        table: dict[str, str] = {}
        for node in self.nodes(ast.Import, ast.ImportFrom):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    table[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else alias.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    table[alias.asname or alias.name] = (
                        f"{node.module}.{alias.name}"
                    )
        return table

    def resolve(self, node: ast.AST) -> str | None:
        """Dotted name with the leading alias expanded through the import
        table (``np.random.rand`` -> ``numpy.random.rand``)."""
        name = dotted_name(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        expanded = self.imports.get(head, head)
        return f"{expanded}.{rest}" if rest else expanded

    # -- suppressions -------------------------------------------------------

    def _suppression_table(self) -> dict[int, set[str] | None]:
        """line -> suppressed rule ids (None = all rules)."""
        table: dict[int, set[str] | None] = {}
        for i, text in enumerate(self.lines, start=1):
            for m in _SUPPRESS_RE.finditer(text):
                rules = m.group("rules")
                if rules is None:
                    table[i] = None
                    break
                ids = {r.strip().upper() for r in rules.split(",") if r.strip()}
                prev = table.get(i)
                if prev is not None:
                    ids |= prev
                table[i] = ids
        return table

    def suppressed(self, finding: Finding) -> bool:
        """Inline-suppressed: marker on the finding's line, or on a
        directly preceding comment-only line."""
        for line in (finding.line, finding.line - 1):
            if line not in self.suppressions:
                continue
            if line == finding.line - 1 and not self.lines[
                line - 1
            ].lstrip().startswith("#"):
                continue
            rules = self.suppressions[line]
            if rules is None or finding.rule in rules:
                return True
        return False

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    # -- function table -----------------------------------------------------

    def iter_functions(
        self,
    ) -> Iterator[tuple[str, FunctionNode, ast.ClassDef | None]]:
        """Yield ``(qualname, def-node, enclosing class or None)`` for every
        function/method (nested functions get dotted qualnames). The
        table is computed once per module and shared by every rule."""
        if self._functions is not None:
            yield from self._functions
            return

        def walk(
            node: ast.AST, prefix: str, cls: ast.ClassDef | None
        ) -> Iterator[tuple[str, FunctionNode, ast.ClassDef | None]]:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{child.name}"
                    yield qual, child, cls
                    yield from walk(child, qual + ".", cls)
                elif isinstance(child, ast.ClassDef):
                    yield from walk(child, f"{prefix}{child.name}.", child)
                else:
                    yield from walk(child, prefix, cls)

        self._functions = list(walk(self.tree, "", None))
        yield from self._functions


# -- running ----------------------------------------------------------------


def _syntax_finding(e: SyntaxError, relpath: str) -> Finding:
    return Finding(
        rule="BJX000",
        path=relpath.replace(os.sep, "/"),
        line=e.lineno or 1,
        col=(e.offset or 1) - 1,
        message=f"syntax error: {e.msg}",
    )


def analyze_modules(
    modules: Iterable["ModuleContext"],
    select: set[str] | None = None,
) -> list[Finding]:
    """Per-file findings over already-parsed modules (the shared AST
    cache: one ``ModuleContext`` per file serves every rule AND the
    project pass)."""
    rules = [
        rule
        for rule_id, rule in sorted(all_rules().items())
        if not rule.project and (not select or rule_id in select)
    ]
    findings: list[Finding] = []
    for module in modules:
        for rule in rules:
            for f in rule.check(module):
                if not module.suppressed(f):
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def analyze_project_modules(
    modules: list["ModuleContext"],
    select: set[str] | None = None,
) -> list[Finding]:
    """Whole-program findings over already-parsed modules: build ONE
    ProjectContext (spawn graph, locksets) and run every registered
    :class:`ProjectRule` over it. Inline suppressions apply at the
    finding's anchor line, same as per-file rules."""
    rules = [
        rule
        for rule_id, rule in sorted(all_rules().items())
        if rule.project and (not select or rule_id in select)
    ]
    if not rules:
        return []
    from blendjax_torch.analysis.project import ProjectContext

    project = ProjectContext(modules)
    by_path = {m.relpath: m for m in modules}
    findings: list[Finding] = []
    for rule in rules:
        for f in rule.check_project(project):
            module = by_path.get(f.path)
            if module is None or not module.suppressed(f):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


SUPPRESSION_HYGIENE_RULE = "BJX124"


def check_suppression_hygiene(
    modules: Iterable["ModuleContext"],
) -> list[Finding]:
    """``--strict-suppressions``: every real ``# bjx: ignore[...]``
    comment must say WHY — trailing text after the marker on the same
    line, or a non-empty comment on the line directly above. A bare
    suppression is a permanent mystery to the next reader; the
    justification is what separates a sanctioned shape from a silenced
    rule. Markers inside string literals (rule messages, docstrings)
    are comments ABOUT suppressions, not suppressions — the audit
    walks real COMMENT tokens, not raw lines."""
    import io
    import tokenize

    findings: list[Finding] = []
    for module in modules:
        try:
            tokens = list(
                tokenize.generate_tokens(io.StringIO(module.source).readline)
            )
        except (tokenize.TokenError, IndentationError):  # pragma: no cover
            continue  # module parsed, so this never fires in practice
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m is None:
                continue
            if re.search(r"\w", tok.string[m.end():]):
                continue  # justified inline, after the marker
            line = tok.start[0]
            above = module.lines[line - 2].strip() if line >= 2 else ""
            if (
                above.startswith("#")
                and not _SUPPRESS_RE.search(above)
                and re.search(r"\w", above.lstrip("#"))
            ):
                continue  # justified by the comment line above
            findings.append(
                Finding(
                    SUPPRESSION_HYGIENE_RULE,
                    module.relpath,
                    line,
                    tok.start[1] + m.start(),
                    "suppression without a justification — say why "
                    "after the marker on the same line or on the "
                    "comment line above",
                    identity=(
                        f"suppression:{module.relpath}:"
                        f"{' '.join(tok.string.split())}"
                    ),
                )
            )
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    return findings


def analyze_source(
    source: str,
    relpath: str,
    select: set[str] | None = None,
) -> list[Finding]:
    """All non-inline-suppressed per-file findings for one module."""
    try:
        module = ModuleContext(source, relpath)
    except SyntaxError as e:
        return [_syntax_finding(e, relpath)]
    return analyze_modules([module], select=select)


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for path in paths:
        if os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in {"__pycache__", ".git", ".venv", "node_modules"}
                )
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)
        elif path.endswith(".py"):
            yield path


def parse_paths(
    paths: Iterable[str],
    root: str | None = None,
) -> tuple[list["ModuleContext"], list[Finding]]:
    """Parse every file ONCE into the shared AST cache: returns
    ``(modules, syntax_error_findings)``. Both the per-file rules and
    the project pass consume the same ``ModuleContext`` objects."""
    root = os.path.abspath(root or os.getcwd())
    modules: list[ModuleContext] = []
    errors: list[Finding] = []
    seen: set[str] = set()
    for path in iter_py_files(paths):
        abspath = os.path.abspath(path)
        if abspath in seen:  # overlapping path arguments
            continue
        seen.add(abspath)
        rel = os.path.relpath(abspath, root)
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        try:
            modules.append(ModuleContext(source, rel))
        except SyntaxError as e:
            errors.append(_syntax_finding(e, rel))
    return modules, errors


def analyze_paths(
    paths: Iterable[str],
    select: set[str] | None = None,
    root: str | None = None,
    project: bool = False,
) -> list[Finding]:
    """Findings over files/directories, paths reported relative to ``root``
    (default: cwd) so baselines are machine-independent. With
    ``project=True`` the whole-program pass (BJX117+) runs over the
    same parse."""
    modules, errors = parse_paths(paths, root=root)
    findings = errors + analyze_modules(modules, select=select)
    if project:
        findings.extend(analyze_project_modules(modules, select=select))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# -- baseline ---------------------------------------------------------------


def _fingerprints(
    findings: Iterable[Finding],
    line_text: Callable[[Finding], str],
) -> list[tuple[Finding, str]]:
    """Stable per-finding fingerprints.

    Per-file findings hash (rule, path, message, normalized line text,
    occurrence index) — immune to pure line-number shifts; the message
    embeds the enclosing function's qualname for most rules, so an
    identical violation added in a DIFFERENT function cannot alias a
    grandfathered fingerprint.

    Project findings (``identity`` set) hash (rule, identity) instead:
    a whole-program finding is ABOUT an attribute or a lock pair, whose
    anchor line and message wording legitimately move as code is
    edited — the identity string (e.g. ``pkg.mod.Class.attr``) is the
    stable name of the defect."""
    by_key: dict[tuple[str, ...], int] = defaultdict(int)
    out: list[tuple[Finding, str]] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key: tuple[str, ...]
        if f.identity is not None:
            key = (f.rule, f.identity)
        else:
            key = (f.rule, f.path, f.message, line_text(f))
        k = by_key[key]
        by_key[key] += 1
        digest = hashlib.sha1(
            "|".join([*key, str(k)]).encode("utf-8")
        ).hexdigest()[:16]
        out.append((f, digest))
    return out


def _default_line_text(root: str) -> Callable[[Finding], str]:
    cache: dict[str, list[str]] = {}

    def text(f: Finding) -> str:
        if f.path not in cache:
            try:
                with open(
                    os.path.join(root, f.path), "r", encoding="utf-8"
                ) as fh:
                    cache[f.path] = fh.read().splitlines()
            except OSError:
                cache[f.path] = []
        lines = cache[f.path]
        return lines[f.line - 1].strip() if 1 <= f.line <= len(lines) else ""

    return text


def load_baseline(path: str) -> set[str]:
    """Fingerprints grandfathered by a committed baseline file.

    Versions 1 (per-file entries only) and 2 (entries may carry a
    project ``identity``) are both accepted: per-file fingerprints are
    computed identically under both, so a v1 baseline stays valid
    unchanged — the version bump only ADDS the identity scheme."""
    if not os.path.exists(path):
        return set()
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if data.get("version") not in (1, 2):
        raise ValueError(f"{path}: unsupported baseline version")
    return {e["fingerprint"] for e in data.get("entries", [])}


def write_baseline(path: str, findings: Iterable[Finding], root: str) -> int:
    """Write all current findings as the new baseline; returns count."""
    entries = []
    for f, fp in _fingerprints(findings, _default_line_text(root)):
        entry = {
            "fingerprint": fp,
            "rule": f.rule,
            "path": f.path,
            "line": f.line,
            "message": f.message,
        }
        if f.identity is not None:
            entry["identity"] = f.identity
        entries.append(entry)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 2, "entries": entries}, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return len(entries)


def apply_baseline(
    findings: Iterable[Finding], baseline: set[str], root: str
) -> list[Finding]:
    """Drop findings whose fingerprint the baseline grandfathers."""
    return [
        f
        for f, fp in _fingerprints(findings, _default_line_text(root))
        if fp not in baseline
    ]
