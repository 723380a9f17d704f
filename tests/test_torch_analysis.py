"""The port's static analyzer (``blendjax_torch.analysis``) against the JAX
package's (``blendjax.analysis``), on the CPU.

- Rule parity: every source that ``tests/test_analysis.py`` hands to the
  JAX analyzer in the tests of a rule of this slice (flagged and clean
  alike, read from that file's syntax tree) goes through both analyzers;
  the (rule, line) pairs must agree, and the JAX side must flag the rule
  at least once. Module paths under ``blendjax/`` map to ``blendjax_torch/``
  on the port's side (BJX126 exempts each package's own ``parallel/``).
- The self-gate: the port's tree is clean under its own (empty) baseline,
  with strict suppressions and the contract docs of
  ``blendjax_torch/docs/``, inside the JAX gate's 30 s budget.
- Catalog parity: the metric names, stamp keys and knobs the port's code
  emits are the JAX package's, but for the set below (``ROADMAP.md``,
  "Chosen differences").
- ``--list-rules`` names exactly this slice's rules.
"""

import ast
import os
import subprocess
import sys
import textwrap
import time

import pytest

from blendjax.analysis import core as jax_core
from blendjax.analysis.contracts import check_contracts as jax_contracts
from blendjax_torch.analysis import core
from blendjax_torch.analysis.contracts import check_contracts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TESTS = os.path.join(REPO, "tests", "test_analysis.py")

#: the per-file and project rules of the port's analyzer
SLICE_RULES = ("BJX103", "BJX104", "BJX105", "BJX107", "BJX109", "BJX110",
               "BJX113", "BJX116", "BJX117", "BJX118", "BJX119", "BJX126")
PROJECT_RULES = ("BJX117", "BJX118", "BJX119")
#: the rules of the next slice (the port's sync vocabulary and captured
#: steps): unknown to the port's analyzer until then
LATER_RULES = ("BJX101", "BJX102", "BJX106", "BJX108", "BJX111", "BJX112",
               "BJX114", "BJX115", "BJX120", "BJX121", "BJX122", "BJX125")

#: catalog entries in which the two packages differ, by choice
#: (ROADMAP.md, "Chosen differences")
CATALOG_DIFFERENCES = {
    # the port's mesh ranks end a live stream at a ragged tail
    "metrics": {"feed.mesh_dropped_batches": "port",
                # the JAX package's gauge is set by bench.py
                "train.donation_reuse": "port"},
    "stamps": {},
    # the port's host C++ has no Python fallback to force
    "knobs": {"BLENDJAX_NO_NATIVE": "jax"},
}


# -- harvesting the JAX package's test sources ----------------------------------


def _jax_test_tree():
    with open(JAX_TESTS) as f:
        return ast.parse(f.read(), JAX_TESTS)


def _string(node, env):
    """The string value of ``node``: a constant, a name bound to one, or a
    ``.replace`` chain on one; None otherwise."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "replace" and len(node.args) == 2):
        base = _string(node.func.value, env)
        old, new = (_string(a, env) for a in node.args)
        if None not in (base, old, new):
            return base.replace(old, new)
    return None


def _bindings(body, env):
    env = dict(env)
    for stmt in body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            value = _string(stmt.value, env)
            if value is not None:
                env[stmt.targets[0].id] = value
    return env


def harvest() -> dict:
    """``{test name: [case]}`` of every test of ``tests/test_analysis.py``;
    a case is ``("file", relpath, source)`` (``findings``, ``rule_ids``,
    ``analyze_source``), ``("project", sources)`` (``project_findings``)
    or ``("modules", [(relpath, source)])`` (``_mods``)."""
    tree = _jax_test_tree()
    module_env = _bindings(tree.body, {})
    out = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        env = _bindings(fn.body, module_env)
        cases = []
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)):
                continue
            name = node.func.id
            if name in ("findings", "rule_ids", "analyze_source"):
                src = _string(node.args[0], env) if node.args else None
                rel = "mod.py"
                if len(node.args) > 1:
                    rel = _string(node.args[1], env) or rel
                for kw in node.keywords:
                    if kw.arg == "relpath":
                        rel = _string(kw.value, env) or rel
                if src is not None:
                    if name != "analyze_source":
                        src = textwrap.dedent(src)
                    cases.append(("file", rel, src))
            elif name == "project_findings":
                srcs = [_string(a, env) for a in node.args]
                if srcs and None not in srcs:
                    cases.append(("project", [textwrap.dedent(s)
                                              for s in srcs]))
            elif name == "_mods":
                mods = []
                for arg in node.args:
                    if isinstance(arg, ast.Tuple) and len(arg.elts) == 2:
                        rel, src = (_string(e, env) for e in arg.elts)
                        if None not in (rel, src):
                            mods.append((rel, textwrap.dedent(src)))
                if mods:
                    cases.append(("modules", mods))
        if cases:
            out[fn.name] = cases
    return out


HARVEST = harvest()


def _port_path(relpath: str) -> str:
    return ("blendjax_torch/" + relpath[len("blendjax/"):]
            if relpath.startswith("blendjax/") else relpath)


def _pairs(findings):
    return sorted((f.rule, f.line) for f in findings)


def _cases_for(rule: str) -> list:
    key = rule.lower()
    names = {
        "BJX000": ("syntax_error",),
        "BJX123": ("contracts",),
        "BJX124": ("strict_suppressions",),
    }.get(rule, (key,))
    if rule == "BJX105":
        names += ("inline_ignore",)
    if rule == "BJX117":
        names += ("project_pass", "lock_name", "closures")
    return [(test, case) for test, cases in HARVEST.items()
            if any(n in test for n in names) for case in cases]


def _run_both(rule, case, tmp_path):
    """(JAX pairs, port pairs) of one harvested case for ``rule``."""
    kind = case[0]
    if kind == "file":
        _, rel, src = case
        sel = {rule}
        return (_pairs(jax_core.analyze_source(src, rel, select=sel)),
                _pairs(core.analyze_source(src, _port_path(rel), select=sel)))
    if kind == "project":
        sel = {rule}
        srcs = case[1]
        jm = [jax_core.ModuleContext(s, f"pkg/m{i}.py")
              for i, s in enumerate(srcs)]
        pm = [core.ModuleContext(s, f"pkg/m{i}.py")
              for i, s in enumerate(srcs)]
        return (_pairs(jax_core.analyze_project_modules(jm, select=sel)),
                _pairs(core.analyze_project_modules(pm, select=sel)))
    mods = case[1]
    jm = [jax_core.ModuleContext(s, r) for r, s in mods]
    pm = [core.ModuleContext(s, _port_path(r)) for r, s in mods]
    if rule == "BJX124":
        return (_pairs(jax_core.check_suppression_hygiene(jm)),
                _pairs(core.check_suppression_hygiene(pm)))
    # BJX123: both gates over the same modules and the same docs (a doc
    # set with one stale metric, one documented family, the wire
    # universe and one knob table)
    docs = tmp_path / "docs"
    docs.mkdir(exist_ok=True)
    (docs / "observability.md").write_text(
        "`wire.frames`, the `echo.*` family, `ingest.recv.shardN` and the "
        "stale `wire.bytes`.\n")
    (docs / "wire-protocol.md").write_text("`_seq` and `_trace` only.\n")
    (docs / "knobs.md").write_text("`BLENDJAX_MY_KNOB` toggles it.\n")
    root = str(tmp_path)
    jf = jax_contracts(jm, root, docs_dir=str(docs))
    pf = check_contracts(pm, root, docs_dir=str(docs))
    return (sorted((f.path, f.line, f.identity) for f in jf),
            sorted((f.path, f.line, f.identity) for f in pf))


@pytest.mark.parametrize("rule", ("BJX000", *SLICE_RULES, "BJX123",
                                  "BJX124"))
def test_rules_agree_with_the_jax_analyzer(rule, tmp_path):
    """Every source of the rule's tests in ``tests/test_analysis.py`` gives
    the same (rule, line) pairs under both analyzers (for BJX123 the
    same findings by path, line and identity), and the JAX side flags the
    rule in at least one of them."""
    cases = _cases_for(rule)
    if rule == "BJX123":
        cases = [(t, c) for t, c in cases if c[0] == "modules"]
    assert cases, f"no source of tests/test_analysis.py exercises {rule}"
    flagged = 0
    for test, case in cases:
        want, got = _run_both(rule, case, tmp_path)
        assert got == want, (test, case, want, got)
        flagged += bool(want)
    assert flagged, f"no harvested source is flagged by {rule}"


# -- the self-gate -------------------------------------------------------------


def test_the_port_is_clean_under_its_baseline():
    """The rules (per file and whole program), strict suppressions and the
    contract gate over ``blendjax_torch/`` (``chip_smoke.py`` too for the
    contracts): no finding past the port's baseline, which holds no entry,
    in under 30 s (the JAX gate's budget,
    ``tests/test_analysis.py:test_full_repo_lint_fits_the_ci_wall_time_budget``)."""
    t0 = time.perf_counter()
    modules, errors = core.parse_paths(
        [os.path.join(REPO, "blendjax_torch")], root=REPO)
    assert not errors
    found = (core.analyze_modules(modules)
             + core.analyze_project_modules(modules)
             + core.check_suppression_hygiene(modules))
    baseline = core.load_baseline(core.BASELINE_DEFAULT)
    assert baseline == set()
    left = core.apply_baseline(found, baseline, REPO)
    smoke, errors = core.parse_paths(
        [os.path.join(REPO, "chip_smoke.py")], root=REPO)
    assert not errors
    drift = check_contracts(modules + smoke, REPO)
    elapsed = time.perf_counter() - t0
    assert [f.render() for f in left + drift] == []
    assert elapsed < 30.0, f"self-gate took {elapsed:.1f} s"


def test_the_gate_is_not_vacuous():
    """The gate sees the port's markers: the hot-path modules opt in, the
    thread-shared classes are marked, and every suppression of this
    slice's rules in the port names the JAX package's counterpart line or
    says why there is none."""
    from blendjax_torch.analysis.rules.markers import _is_driver_hot, _is_hot

    modules, _ = core.parse_paths([os.path.join(REPO, "blendjax_torch")],
                                  root=REPO)
    by = {m.relpath: m for m in modules}
    for rel in ("data/shard_ingest.py", "data/stream.py",
                "transport/channels.py", "obs/lineage.py",
                "data/pipeline.py", "data/batcher.py"):
        assert _is_hot(by["blendjax_torch/" + rel]), rel
    for rel in ("train/driver.py", "train/mesh_driver.py", "data/echo.py",
                "rl/replay.py", "rl/learner.py"):
        assert _is_driver_hot(by["blendjax_torch/" + rel]), rel
    for rel in ("launcher/launcher.py", "rl/replay.py", "utils/metrics.py"):
        assert "# bjx: thread-shared" in by["blendjax_torch/" + rel].source
    marks = 0
    for m in modules:
        if m.relpath.startswith("blendjax_torch/analysis/"):
            continue
        for i, text in enumerate(m.lines):
            if "# bjx: ignore[" not in text:
                continue
            marks += 1
            around = " ".join(m.lines[max(0, i - 4):i + 1])
            assert "blendjax/" in around or "counterpart" in around, (
                m.relpath, i + 1, text)
    assert marks >= 15


def test_the_unlocked_ring_fields_are_found_on_the_parent_shape():
    """The two TrajectoryReservoir faults the gate found (ROADMAP Queue C):
    a gather function set after the ring is shared and read without the
    lock, and a rank agreement made outside it. The parent's shape of
    ``rl/replay.py`` is flagged twice by BJX117; the repaired module is
    clean."""
    path = os.path.join(REPO, "blendjax_torch", "rl", "replay.py")
    with open(path) as f:
        fixed = f.read()
    parent = fixed.replace(
        "        self._gather_fn = make_ring_gather(self.capacity, sharding)\n",
        "        self._gather_fn = None\n",
    ).replace(
        "        self._priorities = self._prio_store[:self.capacity]\n",
        "        self._priorities = self._prio_store[:self.capacity]\n"
        "        self._gather_fn = make_ring_gather(self.capacity, "
        "self.sharding)\n",
    ).replace(
        "            if self._agreement is None:\n"
        "                self._agreement = RankAgreement(self.sharding.mesh)\n"
        "            agreement = self._agreement\n",
        "        if self._agreement is None:\n"
        "            self._agreement = RankAgreement(self.sharding.mesh)\n"
        "        agreement = self._agreement\n",
    )
    assert parent != fixed

    def attrs(src):
        mod = core.ModuleContext(src, "blendjax_torch/rl/replay.py")
        return sorted(f.identity for f in core.analyze_project_modules(
            [mod], select={"BJX117"}))

    assert attrs(fixed) == []
    assert attrs(parent) == [
        "blendjax_torch.rl.replay.TrajectoryReservoir._agreement",
        "blendjax_torch.rl.replay.TrajectoryReservoir._gather_fn",
    ]


# -- catalogs ------------------------------------------------------------------


def _catalogs(package: str, mod) -> dict:
    modules, errors = mod.parse_paths([os.path.join(REPO, package)],
                                      root=REPO)
    assert not errors
    modules = [m for m in modules
               if not m.relpath.startswith(f"{package}/analysis/")]
    from importlib import import_module

    c = import_module(f"{mod.__name__.rsplit('.', 1)[0]}.contracts")
    metrics = c.extract_metrics(modules)
    return {
        "metrics": set(metrics.names) | {p + "*" for p in metrics.prefixes},
        "stamps": set(c.extract_stamp_keys(modules).names),
        "knobs": set(c.extract_env_knobs(modules).names),
    }


def test_the_port_emits_the_jax_packages_catalogs():
    """Metric names (and dynamic families), wire stamp keys and
    ``BLENDJAX_*`` knobs extracted from each package's code (its analyzer
    left out) are equal, but for :data:`CATALOG_DIFFERENCES`. A registry
    site the port misses (as C6 and C13 were) fails here."""
    port, ref = _catalogs("blendjax_torch", core), _catalogs("blendjax",
                                                            jax_core)
    for kind in ("metrics", "stamps", "knobs"):
        chosen = CATALOG_DIFFERENCES[kind]
        assert {k: "port" for k in port[kind] - ref[kind]} | {
            k: "jax" for k in ref[kind] - port[kind]} == chosen, kind
        assert len(port[kind] & ref[kind]) > (0 if kind == "knobs" else 10)


# -- the command line ------------------------------------------------------------


def test_list_rules_names_this_slice_and_later_ids_are_unknown():
    """``--list-rules`` prints exactly this slice's rules (project scope
    for BJX117-119); a rule of the next slice is an unknown id (exit 2)."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; from blendjax_torch.analysis.__main__ import main; "
         "print('rc', main(['--list-rules'])); "
         f"print('rc', main(['--select', '{LATER_RULES[0]}']))"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    listed = [ln.split()[0] for ln in lines if ln.startswith("BJX")]
    assert listed == sorted(SLICE_RULES)
    for ln in lines:
        if ln.startswith("BJX"):
            scope = "[project]" if ln.split()[0] in PROJECT_RULES else "[file]"
            assert scope in ln, ln
    assert lines[-2:] == ["rc 0", "rc 2"]
    assert "unknown rule ids" in r.stderr


def test_the_analyzer_imports_the_standard_library_only():
    """In a fresh interpreter the analyzer and all its rules load, and
    nothing outside the standard library, the port's analysis package and
    its parents comes with them."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import blendjax_torch.analysis.__main__ as m\n"
        "m.all_rules()\n"
        "new = sorted(set(sys.modules) - before)\n"
        "bad = [n for n in new if n.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'zmq', 'blendjax') or ("
        "n.startswith('blendjax_torch.') and not n.startswith("
        "'blendjax_torch.analysis'))]\n"
        "print(bad)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
