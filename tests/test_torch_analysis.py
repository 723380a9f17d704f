"""The port's static analyzer (``blendjax_torch.analysis``) against the JAX
package's (``blendjax.analysis``), on the CPU.

- Rule parity, shared sources: every source that ``tests/test_analysis.py``
  hands to the JAX analyzer in the tests of a rule that holds unchanged
  (flagged and clean alike, read from that file's syntax tree) goes
  through both analyzers; the (rule, line) pairs must agree, and the JAX
  side must flag the rule at least once. Module paths under
  ``blendjax/`` map to ``blendjax_torch/`` on the port's side (BJX126
  exempts each package's own ``parallel/``).
- Rule parity, counterpart sources: the rules ported by meaning (host
  syncs and captured steps) take each harvested JAX source to its torch
  twin (:data:`TWINS`); the findings agree per rule and function, or
  the twin records the port's result and the reason (``ROADMAP.md``,
  "Chosen differences"). The fixtures of ``tests/fixtures/`` have twins
  in ``tests/torch_fixtures/``, run end to end; the port's own shapes
  (pinned host buffers, the step counter, ``_traces``, state aliases,
  BJX125, the card's sync census) have tests of their own.
- The self-gate: the port's tree is clean under its own baseline (one
  entry, the JAX baseline's counterpart), with strict suppressions and
  the contract docs of ``blendjax_torch/docs/``, inside the JAX gate's
  30 s budget.
- Catalog parity: the metric names, stamp keys and knobs the port's code
  emits are the JAX package's, but for the set below (``ROADMAP.md``,
  "Chosen differences").
- ``--list-rules`` names exactly the JAX analyzer's rules.
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

#: catalog entries in which the two packages differ, by choice
#: (ROADMAP.md, "Chosen differences")
CATALOG_DIFFERENCES = {
    # the port's mesh ranks end a live stream at a ragged tail
    "metrics": {"feed.mesh_dropped_batches": "port",
                # the JAX package's gauge is set by bench.py
                "train.donation_reuse": "port"},
    # a mesh pipeline's packed group of this rank's own rows (the port runs
    # one process per card; the JAX package places one global batch)
    "stamps": {"_local_rows": "port"},
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


# -- the rules of the port's vocabulary: twins of the JAX package's tests ---------

#: the rules ported by meaning (captured steps and host syncs): their JAX
#: tests' sources do not speak the port's vocabulary, so each harvested
#: source has a torch twin in :data:`TWINS`
TWIN_RULES = ("BJX101", "BJX102", "BJX106", "BJX108", "BJX111", "BJX112",
              "BJX114", "BJX115", "BJX120", "BJX121", "BJX122")


class Twin:
    """The port's counterpart of one harvested case: a ``("file", relpath,
    source)`` or ``("project", sources)`` case in torch vocabulary.
    ``lines``: the twin keeps the JAX source's layout, so the (rule, line)
    pairs agree too. ``expect`` (``{(rule, path, function): count}``) with
    its ``reason``: the port's result where it differs from the JAX
    analyzer's by design (ROADMAP.md, "Chosen differences")."""

    def __init__(self, case, lines=False, expect=None, reason=""):
        self.case, self.lines = case, lines
        self.expect, self.reason = expect, reason
        assert (expect is None) == (not reason)


def _f(source, relpath="mod.py", **kw):
    return Twin(("file", relpath, textwrap.dedent(source)), **kw)


def _p(*sources, **kw):
    return Twin(("project", [textwrap.dedent(s) for s in sources]), **kw)


HOT_SYNC_TWIN = """
    import torch
    import numpy as np

    def feed(batches):
        for b in batches:
            db = b.to("cuda", non_blocking=True)
            torch.cuda.synchronize()
            x = float(db.cpu())
            yield x
"""

DRIVER_SYNC_TWIN = """
    import torch
    import numpy as np

    def run(step, state, batches):
        for b in batches:
            state, m = step(state, b)
            torch.cuda.synchronize()
            v = float(m["loss"].cpu())
        return state
"""

RESERVOIR_FETCH_TWIN = """
    # bjx: driver-hot-path
    import numpy as np

    def draw(reservoir, idx):
        batch = reservoir.sample(idx)
        imgs = batch["image"].cpu()
        loss = float(batch["xy"])
        return imgs, loss
"""

STEP_AND_FEED_TWIN = """
    from blendjax_torch.train import CapturedStep

    def _step(state, batch):
        return state

    step = CapturedStep(_step)

    def feed(state, batch):
        batch["_trace"] = {"t0": 0.0}
        return step(state, batch)
"""

TWINS = {
    # -- BJX101: CapturedStep / build_aot_step / a torch.cuda.graph block
    "test_bjx101_flags_side_effects_in_jit_decorated_function": [_f("""
        import time

        import numpy as np
        from blendjax_torch.train import CapturedStep

        def step(x):
            print("x =", x)
            t = time.time()
            noise = np.random.rand(4)
            return x + noise + t

        captured = CapturedStep(step)
        """)],
    "test_bjx101_reaches_through_call_graph_and_partial_and_lambda": [_f("""
        import functools

        from blendjax_torch.train import CapturedStep

        def helper(x):
            print(x)
            return x

        def outer(state, x, k=1):
            return helper(x) * k

        step = CapturedStep(functools.partial(outer, k=2))

        def wrap(state, x):
            return CapturedStep(lambda s, y: print(y))(state, x)
        """)],
    "test_bjx101_negative_host_side_code_and_jax_random": [_f("""
        import torch
        from blendjax_torch.train import CapturedStep

        def host_loop(batches):
            for b in batches:
                print("host logging is fine outside a capture", b)

        def step(x, gen):
            noise = torch.randn(x.shape, generator=gen, device=x.device)
            return x + noise

        captured = CapturedStep(step)
        """)],
    "test_bjx101_global_mutation_flagged_but_readonly_global_is_not": [_f("""
        import torch

        _step_count = 0
        _config = {}

        def counted(x):
            global _step_count
            _step_count = _step_count + 1
            return x

        def reader(x):
            global _config
            return x * len(_config)

        graphed = torch.cuda.make_graphed_callables(counted, (torch.ones(1),))
        reader_step = torch.cuda.make_graphed_callables(reader, (torch.ones(1),))
        """)],
    # -- BJX102: the hot modules
    "test_bjx102_flags_sync_in_hot_module": [
        _f(HOT_SYNC_TWIN, "blendjax_torch/data/pipeline.py", lines=True)],
    "test_bjx102_negative_outside_hot_path_and_benign_hot_code": [
        _f(HOT_SYNC_TWIN, "blendjax_torch/train/bench_tool.py", lines=True),
        _f("""
            import torch

            def feed(batches):
                for b in batches:
                    yield b.to("cuda", non_blocking=True)
            """, "blendjax_torch/data/pipeline.py", lines=True)],
    "test_bjx102_lambda_body_is_scanned_in_hot_module": [_f("""
        def make_waiter():
            return lambda event: event.synchronize()
        """, "blendjax_torch/data/pipeline.py", lines=True)],
    # -- BJX106: same-iteration syncs in driver hot paths
    "test_bjx106_flags_same_iteration_sync_in_driver_module": [
        _f(DRIVER_SYNC_TWIN, "blendjax_torch/train/driver.py", lines=True)],
    "test_bjx106_negatives_prior_iteration_and_non_driver_modules": [
        _f("""
            import collections

            import torch
            import numpy as np

            def run(step, state, batches, inflight=4):
                pending = collections.deque()
                for b in batches:
                    while len(pending) >= inflight:
                        _wait(pending)
                    state, m = step(state, b)
                    pending.append(m["loss"])
                return state, float(pending.pop())

            def _wait(pending):
                oldest = pending.popleft()
                oldest.cpu()
            """, "blendjax_torch/train/driver.py", lines=True),
        _f(DRIVER_SYNC_TWIN, "blendjax_torch/train/loops.py", lines=True),
        _f("""
            import numpy as np

            def run(step, state, batches):
                m = None
                for b in batches:
                    if m is not None:
                        print(m["loss"].item())
                    state, m = step(state, b)
                return state
            """, "blendjax_torch/train/driver.py", lines=True)],
    "test_bjx106_item_and_attribute_form": [_f("""
        def run(step, state, batches):
            for b in batches:
                state, m = step(state, b)
                x = m["loss"].item()
            return state
        """, "blendjax_torch/train/driver.py", lines=True)],
    # -- BJX108: host fetches of reservoir contents
    "test_bjx108_flags_host_fetch_of_sample_result": [
        _f(RESERVOIR_FETCH_TWIN, lines=True)],
    "test_bjx108_flags_direct_nesting_and_constructed_locals": [_f("""
        # bjx: driver-hot-path
        import numpy as np
        from blendjax_torch.data.echo import SampleReservoir

        def insert_and_peek(batches, idx):
            res = SampleReservoir(64)
            for b in batches:
                res.insert(b)
            return res.sample(idx).cpu()

        def peek_item(self, idx):
            return self.reservoir.gather(idx)["image"].item()
        """, lines=True)],
    "test_bjx108_negatives_host_indices_and_unmarked_modules": [
        _f("""
            # bjx: driver-hot-path
            import numpy as np

            def draw(reservoir, use, rng, b):
                idx = rng.choice(np.flatnonzero(use < 8), size=b)
                batch = reservoir.sample(idx)
                fresh = int((use[idx] == 0).sum())
                np.add.at(use, idx, 1)
                return batch, fresh
            """, lines=True),
        _f("""
            # bjx: driver-hot-path
            import numpy as np

            def draw(reservoir, idx, batch):
                host = batch.cpu()
                batch = reservoir.sample(idx)
                return host, batch
            """, lines=True),
        _f(RESERVOIR_FETCH_TWIN.replace("# bjx: driver-hot-path", ""),
           lines=True)],
    "test_bjx108_inline_suppression": [_f("""
        # bjx: driver-hot-path
        import numpy as np

        def debug_draw(reservoir, idx):
            batch = reservoir.sample(idx)
            return batch["image"].cpu()  # bjx: ignore[BJX108]
        """, lines=True)],
    # -- BJX111: one process per card
    "test_bjx111_flags_per_device_device_put_loops": [_f("""
        # bjx: mesh-hot-path
        import torch

        def place_loop(mesh, batch):
            out = []
            for d in mesh.devices:
                out.append(batch.to(d))
            return out

        def place_comp(batch):
            return [batch.to(f"cuda:{i}") for i in range(torch.cuda.device_count())]

        def place_local(batch):
            for r in range(torch.distributed.get_world_size()):
                batch.to(r)
        """, lines=True)],
    "test_bjx111_flags_global_array_host_materialization": [_f("""
        # bjx: mesh-hot-path
        from blendjax_torch.parallel import all_gather, gather_full
        import numpy as np

        def assemble(s, v):
            g = gather_full(v, s)
            host = g.cpu()
            return host

        def direct(s, v):
            return float(
                gather_full(v, s).sum()
            )

        def shard_walk(g, mesh):
            return [s.sum() for s in all_gather(g, mesh)]
        """, lines=True)],
    "test_bjx111_negatives_single_placement_and_unmarked": [
        _f("""
            # bjx: mesh-hot-path
            import torch

            def place(batch, device):
                return batch.to(device, non_blocking=True)

            def over_fields(batch, device):
                # loops over FIELDS are fine; the loop var is not a device
                return {k: v.to(device, non_blocking=True)
                        for k, v in batch.items()}
            """, lines=True),
        _f("""
            # bjx: mesh-hot-path
            import numpy as np

            def pack(rows):
                return np.asarray(rows)
            """, lines=True),
        _f("""
            def inspect(g, mesh):
                return [s.sum() for s in all_gather(g, mesh)]
            """, lines=True)],
    "test_bjx111_hot_by_basename_and_inline_suppression": [
        _f("""
            def inspect(g, mesh):
                for s in all_gather(g, mesh):
                    print(s)
            """, "mesh_driver.py", lines=True),
        _f("""
            def inspect(g, mesh):
                for s in all_gather(g, mesh):  # bjx: ignore[BJX111]
                    print(s)
            """, "mesh_driver.py", lines=True)],
    # -- BJX112: the in-place check
    "test_bjx112_flags_undonated_step_jit_in_hot_module": [
        _f("""
            # bjx: driver-hot-path
            from blendjax_torch.train import CapturedStep

            def make_step():
                def step(state, batch):
                    state.params = state.params - batch["g"]
                    return {}
                return CapturedStep(step)
            """),
        _f("""
            # bjx: driver-hot-path
            from blendjax_torch.train import build_aot_step

            def build(state, example):
                def evaluate(state, batch):
                    state.metrics = batch["x"].mean()
                    return state.params
                return build_aot_step(evaluate, state, example)
            """)],
    "test_bjx112_donation_keyword_presence_satisfies": [_f("""
        # bjx: driver-hot-path
        from blendjax_torch.train import CapturedStep

        def make_step():
            def step(state, batch):
                state.params.sub_(batch["g"])
                return {}
            return CapturedStep(step)
        """)],
    "test_bjx112_decorator_form_and_step_module_scope": [
        _f("""
            from blendjax_torch.train import CapturedStep

            def train_step(state, batch):
                state["params"] = state["params"] * 0.9
                return state

            captured = CapturedStep(train_step)
            """, "steps.py"),
        _f("""
            from blendjax_torch.train import CapturedStep

            def train_step(state, batch):
                state["params"] = state["params"] * 0.9
                return state

            captured = CapturedStep(train_step)
            """)],
    "test_bjx112_non_step_jits_and_suppressions_pass": [
        _f("""
            # bjx: driver-hot-path
            import torch
            from blendjax_torch.train import CapturedStep

            def build():
                draw = CapturedStep(lambda bufs, i: bufs[i])
                gather = CapturedStep(_gather)
                # segment-anchored name match: 'constrain' must not read
                # as train
                pin = CapturedStep(apply_constraint)
                return draw, gather, pin

            def apply_constraint(sb):
                sb.pinned = True
                return sb
            """),
        _f("""
            # bjx: driver-hot-path
            from blendjax_torch.train import CapturedStep

            def make_eval():
                def eval_step(state, batch):
                    state.last = batch
                    return state.params
                # bjx: ignore[BJX112]
                return CapturedStep(eval_step)
            """)],
}

# BJX114: the checkpoint calls are the same words in both packages; the
# twins are the JAX sources with the port's imports
for _name, _cases in HARVEST.items():
    if "bjx114" in _name:
        TWINS[_name] = [
            _f(c[2].replace("from blendjax.", "from blendjax_torch."),
               _port_path(c[1]), lines=True)
            for c in _cases]

TWINS.update({
    # -- BJX115: actor hot loops
    "test_bjx115_flags_policy_and_reservoir_fetches_in_actor_module": [_f("""
        # bjx: actor-hot-path
        import numpy as np

        def loop(self, obs):
            while True:
                actions = self.policy(self._snapshot, obs)
                a = actions.cpu()
                drawn = self.reservoir.sample(idx)
                v = float(drawn)
        """, lines=True)],
    "test_bjx115_flags_item_and_block_until_ready_anywhere_in_actor": [_f("""
        # bjx: actor-hot-path
        import torch

        def loop(self, q):
            x = q.item()
            torch.cuda.synchronize()
        """, lines=True)],
    "test_bjx115_actor_basename_always_checked_and_nesting_flagged": [_f("""
        import numpy as np

        def loop(self, idx):
            a = self.policy(snap, obs).cpu()
        """, "rl/actor.py", lines=True)],
    "test_bjx115_env_outputs_and_host_math_stay_clean": [_f("""
        # bjx: actor-hot-path
        import numpy as np

        def loop(self):
            while True:
                obs, reward, done, infos = self.env.step(a)
                o = np.asarray(obs)
                r = float(reward[0])
                ret = float(self._ep_ret[0])
        """, lines=True)],
    "test_bjx115_silent_outside_actor_modules_and_suppressible": [
        _f("""
            import numpy as np

            def learner_sync(self):
                snap = self.policy(s, o).cpu()
            """, lines=True),
        _f("""
            # bjx: actor-hot-path
            import numpy as np

            def probe(self):
                # one-off debugging probe, not the loop
                # bjx: ignore[BJX115]
                a = self.policy(s, o).cpu()
            """, lines=True)],
    # -- BJX120: sidecars into captured steps
    "test_bjx120_flags_direct_stamp_into_jit": [_p(STEP_AND_FEED_TWIN)],
    "test_bjx120_pop_and_filtered_rebuild_are_strips": [_p("""
        from blendjax_torch.train import CapturedStep

        step = CapturedStep(lambda state, b: state)

        def feed_pop(state, batch):
            batch["_traces"] = []
            batch.pop("_traces", None)
            return step(state, batch)

        def feed_filter(state, batch):
            batch["_traces"] = []
            clean = {k: v for k, v in batch.items() if not k.startswith("_")}
            return step(state, clean)
        """)],
    "test_bjx120_provenance_through_rebinding_and_dict_copies": [_p("""
        from blendjax_torch.train import CapturedStep

        step = CapturedStep(lambda state, b: state)

        def leak_copy(state, batch):
            batch["_traces"] = [1]
            b2 = batch
            b3 = dict(**b2)
            return step(state, b3)

        def clean_alias_pop(state, batch):
            batch["_traces"] = [1]
            b2 = batch
            b2.pop("_traces", None)
            return step(state, batch)
        """)],
    "test_bjx120_strip_via_helper_one_call_hop": [_p("""
        _STAMPS = ("_trace", "_traces")

        def scrub(msg):
            for k in _STAMPS:
                msg.pop(k, None)
            return msg
        """, """
        from blendjax_torch.train import CapturedStep

        from pkg.m0 import scrub

        step = CapturedStep(lambda state, b: state)

        def feed(state, batch):
            batch["_trace"] = {}
            return step(state, scrub(batch))
        """)],
    "test_bjx120_leak_through_forwarding_helper_anchors_in_origin": [_p("""
        from blendjax_torch.train import CapturedStep

        step = CapturedStep(lambda state, b: state)

        def collate(state, batch):
            return step(state, batch)

        def feed(state, batch):
            batch["_trace"] = {}
            return collate(state, batch)
        """)],
    "test_bjx120_wrapped_callee_summaries_are_stable": [_p("""
        import functools

        from blendjax_torch.train import CapturedStep

        def audited(fn):
            @functools.wraps(fn)
            def inner(*a, **k):
                return fn(*a, **k)
            return inner

        step = CapturedStep(lambda state, b: state)

        @audited
        def scrub(batch):
            batch.pop("_trace", None)
            return batch

        @audited
        def mark(batch):
            batch["_trace"] = {}
            return batch

        def clean(state, batch):
            batch["_trace"] = {}
            return step(state, scrub(batch))

        def leaky(state, batch):
            return step(state, mark(batch))
        """)],
    "test_bjx120_wire_decode_is_a_taint_source": [_p("""
        from blendjax_torch.train import CapturedStep
        from blendjax_torch.transport.wire import decode_message

        step = CapturedStep(lambda state, b: state)

        def replay(state, frames):
            msg = decode_message(frames)
            return step(state, msg)
        """)],
    "test_bjx120_inline_suppression": [_p(STEP_AND_FEED_TWIN.replace(
        "return step(state, batch)",
        "return step(state, batch)  # sanctioned  # bjx: ignore[BJX120]"))],
    # -- BJX121: the state's aliases across a captured call
    "test_bjx121_loop_donation_without_rebind": [_p(
        """
        from blendjax_torch.train import CapturedStep

        def _step(state, batch):
            return state

        step = CapturedStep(_step)

        def run(state, batches):
            for b in batches:
                out = step(state, b)
            return out

        def run_clean(state, batches):
            for b in batches:
                state = step(state, b)
            return state
        """, expect={},
        reason="a captured step writes its state in place: passing the "
               "same state again in a loop is how it is driven, not a "
               "use of a donated buffer")],
    "test_bjx121_tuple_rebind_and_if_merge_are_clean": [_p("""
        from blendjax_torch.train import CapturedStep

        def _step(state, prio, batch):
            return state, prio

        step = CapturedStep(_step)

        def update(state, prio, batch):
            state, prio = step(state, prio, batch)
            return state, prio

        def branched(state, prio, batch, flag):
            if flag:
                state, prio = step(state, prio, batch)
            else:
                state = state
            return state, prio
        """)],
    # -- BJX122: the plan signature
    "test_bjx122_dynamic_keyset_and_bucket_launder": [_p("""
        from blendjax_torch.train import CapturedStep

        step = CapturedStep(lambda state, b: state)

        def feed(state, batch, msg):
            batch[msg["name"]] = msg["value"]
            return step(state, batch)

        def feed_bucketed(state, batch, msg):
            n = pad_to_bucket(msg["count"])
            cfg = {}
            cfg[n] = 1
            return step(state, batch)
        """)],
})


def _functions(source: str) -> list:
    """``(first line, last line, qualname)`` of every def of ``source``."""
    out = []

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = prefix + child.name
                if not isinstance(child, ast.ClassDef):
                    out.append((child.lineno, child.end_lineno, qual))
                walk(child, qual + ".")
            else:
                walk(child, prefix)

    walk(ast.parse(source), "")
    return out


def _by_function(findings, sources: dict) -> dict:
    """``{(rule, path, innermost enclosing function): count}``."""
    import collections

    out = collections.Counter()
    for f in findings:
        spans = [(a, b, q) for a, b, q in _functions(sources[f.path])
                 if a <= f.line <= b]
        qual = max(spans)[2] if spans else "<module>"
        out[(f.rule, f.path, qual)] += 1
    return dict(out)


def _twin_findings(rule: str, case, port: bool) -> tuple:
    """(findings, {path: source}) of one case under one analyzer."""
    mod = core if port else jax_core
    sel = {rule}
    if case[0] == "file":
        _, rel, src = case
        return mod.analyze_source(src, rel, select=sel), {rel: src}
    srcs = {f"pkg/m{i}.py": s for i, s in enumerate(case[1])}
    mods = [mod.ModuleContext(s, p) for p, s in srcs.items()]
    return mod.analyze_project_modules(mods, select=sel), srcs


def _twin_params():
    for rule in TWIN_RULES:
        seen = set()
        for test, case in _cases_for(rule):
            key = (test, repr(case))
            if key in seen or test not in TWINS:
                continue
            seen.add(key)
            index = [repr(c) for c in HARVEST[test]].index(repr(case))
            yield pytest.param(rule, test, index, id=f"{rule}-{test}-{index}")


@pytest.mark.parametrize("rule,test,index", list(_twin_params()))
def test_twins_agree_with_the_jax_analyzer(rule, test, index):
    """Each harvested JAX source of the rule through the JAX analyzer, its
    torch twin through the port's: the same findings per rule and
    function (and per line where the twin keeps the layout), or the
    twin's recorded port result where the two differ by design."""
    jax_case = HARVEST[test][index]
    twin = TWINS[test][index]
    jf, jsrc = _twin_findings(rule, jax_case, port=False)
    pf, psrc = _twin_findings(rule, twin.case, port=True)
    got = _by_function(pf, psrc)
    if twin.expect is not None:
        assert got == twin.expect, (twin.reason, got)
        assert _by_function(jf, jsrc), "the JAX side no longer flags it"
        return
    want = {(r, _port_path(p), q): n
            for (r, p, q), n in _by_function(jf, jsrc).items()}
    assert got == want, (test, index, want, got, [f.render() for f in pf])
    if twin.lines:
        assert _pairs(pf) == _pairs(jf)


def test_every_harvested_test_of_the_ported_rules_has_twins():
    """No harvested JAX test of the rules in :data:`TWIN_RULES` is left
    without a twin per case, and every twin's JAX test still exists."""
    for rule in TWIN_RULES:
        tests = {t for t, _ in _cases_for(rule)}
        assert tests, rule
        for t in tests:
            assert t in TWINS, (rule, t)
            assert len(TWINS[t]) == len(HARVEST[t]), t
    assert set(TWINS) <= set(HARVEST)
    flagged = sum(bool(_twin_findings(r, TWINS[t][i].case, True)[0])
                  for r, t, i in (p.values for p in _twin_params()))
    assert flagged >= 25


# -- the fixtures, end to end ---------------------------------------------------

#: ``tests/torch_fixtures/`` (the twins of ``tests/fixtures/``): the
#: findings each must give, as (rule, a piece of its identity)
TORCH_FIXTURES = {
    "racy_threads.py": [("BJX117", "Racy.counter"),
                        ("BJX118", "Racy.lock_a<>"),
                        ("BJX119", None)],
    "stamp_leak_trace.py": [("BJX120",
                             "feed:_trace->CapturedStep(_train_step)")],
    "stamp_leak_scenario.py": [("BJX120", "EchoSampler.draw:_scenario_rows->")],
    "use_after_donate_sync.py": [("BJX121", "Learner.update:policy")],
    "retrace_unbounded.py": [("BJX122", "feed:CapturedStep(_decode):n=")],
}


@pytest.mark.parametrize("name", sorted(TORCH_FIXTURES))
def test_torch_fixtures_flag_end_to_end(name):
    """Each fixture twin through ``analyze_paths(project=True)`` gives
    exactly its expected findings (its sanctioned twin in the same file
    stays quiet)."""
    path = os.path.join(REPO, "tests", "torch_fixtures", name)
    got = core.analyze_paths([path], root=REPO, project=True)
    assert [f.rule for f in got] == [r for r, _ in TORCH_FIXTURES[name]], [
        f.render() for f in got]
    for f, (_, ident) in zip(got, TORCH_FIXTURES[name]):
        assert ident is None or ident in (f.identity or ""), f.identity


def test_the_cli_flags_every_torch_fixture():
    """The same gate through the CLI in one run (exit 1, JSON output)."""
    import json

    r = subprocess.run(
        [sys.executable, "-m", "blendjax_torch.analysis",
         os.path.join("tests", "torch_fixtures"), "--no-baseline",
         "--format", "json"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stderr
    got = sorted((os.path.basename(f["path"]), f["rule"])
                 for f in json.loads(r.stdout))
    assert got == sorted((n, rule) for n, want in TORCH_FIXTURES.items()
                         for rule, _ in want)


# -- the port's own shapes --------------------------------------------------------


def _port(src, relpath="mod.py", select=None):
    return core.analyze_source(textwrap.dedent(src), relpath,
                               select=set(select) if select else None)


def _project(*srcs, select):
    mods = [core.ModuleContext(textwrap.dedent(s), f"pkg/m{i}.py")
            for i, s in enumerate(srcs)]
    return core.analyze_project_modules(mods, select=set(select))


def test_a_pinned_host_buffer_is_no_sync():
    """``.numpy()`` of a pinned host staging buffer (the feeder's
    ``entry[0].numpy()[...] = v``) and ``.item()`` of one are host reads;
    the same calls on a tensor placed on the card are BJX102 findings."""
    src = """
        import torch

        def stage(self, arr, v):
            buf = self._pinned_buffer(arr)
            buf.numpy()[...] = v
            pinned = torch.empty((4,), pin_memory=True)
            x = pinned.item()
            placed = buf.to("cuda", non_blocking=True)
            return placed.numpy(), float(placed), x
    """
    got = _port(src, "blendjax_torch/data/pipeline.py", select=["BJX102"])
    assert [(f.line, f.message.split()[2]) for f in got] == [
        (10, ".numpy()"), (10, "float()")]
    feeder = os.path.join(REPO, "blendjax_torch", "data", "pipeline.py")
    with open(feeder) as f:
        text = f.read()
    line = text[:text.index("entry[0].numpy()[...] = v")].count("\n") + 1
    found = _port(text, "blendjax_torch/data/pipeline.py", select=["BJX102"])
    assert line not in {f.line for f in found}


def test_the_step_counter_inside_a_captured_step_is_not_flagged():
    """``state.step += 1`` in a captured step (``train/steps.py``) runs at
    capture only, and ``aot.py``'s wrapper advances the counter instead:
    neither BJX101 (module globals only) nor BJX112 (an augmented
    assignment writes in place) flags it; rebinding the counter, or a
    tensor field, is BJX112's bug."""
    src = """
        # bjx: driver-hot-path
        from blendjax_torch.train import CapturedStep

        def make_step():
            def step(state, batch):
                state.params.sub_(batch["g"])
                state.step += 1
                return {}
            return CapturedStep(step)
    """
    assert _port(src, select=["BJX101", "BJX112"]) == []
    rebound = src.replace("state.step += 1", "state.step = state.step + 1")
    assert [f.rule for f in _port(rebound, select=["BJX112"])] == ["BJX112"]
    setattr_form = src.replace("state.step += 1",
                               "setattr(state, 'params', batch['p'])")
    assert [f.rule for f in _port(setattr_form, select=["BJX112"])] == [
        "BJX112"]


def test_a_traces_stamp_reaching_a_captured_step():
    """A ``_traces`` list on a batch handed to a ``CapturedStep`` is a
    BJX120 finding; ``_plan_signature`` (which keys the graphs) raises on
    it, which is the failure the rule names. The keys ``aot._UNKEYED``
    passes through are no leak, and the analyzer's copy of that tuple is
    the module's."""
    torch = pytest.importorskip("torch")
    from blendjax_torch.analysis.project import CAPTURE_UNKEYED_KEYS
    from blendjax_torch.train import aot

    src = """
        from blendjax_torch.train import CapturedStep

        step = CapturedStep(lambda state, b: state)

        def feed(state, batch, traces, rows):
            batch["_traces"] = traces
            return step(state, batch)

        def feed_rows(state, batch, rows):
            batch["_scenario_rows"] = rows
            return step(state, batch)
    """
    got = _project(src, select=["BJX120"])
    assert [(f.rule, f.identity) for f in got] == [
        ("BJX120", "pkg.m0.feed:_traces->CapturedStep(…)")]
    assert CAPTURE_UNKEYED_KEYS == frozenset(aot._UNKEYED)
    batch = {"image": torch.zeros(2, 3), "_traces": [{"id": "a"}]}
    with pytest.raises(TypeError, match="unhashable"):
        aot._plan_signature(batch)
    stamped = {"image": torch.zeros(2, 3), "_seq": 7}
    assert aot._plan_signature(stamped) != aot._plan_signature(
        {**stamped, "_seq": 8})


def test_a_state_alias_shipped_to_actors_after_a_captured_call():
    """BJX121 in torch form: views of the state taken before a captured
    call and read after it (shipped to the actors, returned) are
    findings; a clone, a view taken after the call, a view of another
    object and the state passed again are not."""
    src = """
        from blendjax_torch.train import CapturedStep

        step = CapturedStep(lambda state, b: state)

        def shipped(self, state, batches):
            snap = {k: v.detach() for k, v in state.params.items()}
            weights = list(state.model.parameters())
            for b in batches:
                step(state, b)
            self.actors.update_policy(snap)
            return weights

        def cloned(self, state, b, other):
            snap = {k: v.detach().clone() for k, v in state.params.items()}
            keep = other.params["w"].detach()
            step(state, b)
            after = state.params["w"].detach()
            step(state, b)
            self.actors.update_policy(snap)
            return keep, state
    """
    got = _project(src, select=["BJX121"])
    assert sorted(f.identity for f in got) == [
        "pkg.m0.shipped:snap", "pkg.m0.shipped:weights"]


def test_bjx125_flags_captures_built_inside_a_driver_loop():
    """Constructing a ``CapturedStep``, an AOT set, a ``CUDAGraph`` or a
    step builder inside a driver hot path's loop is a cold capture per
    iteration; building once before the loop, or outside a driver hot
    path, is clean."""
    src = """
        # bjx: driver-hot-path
        import torch
        from blendjax_torch.train import (CapturedStep, build_aot_step,
                                          make_fused_tile_step)

        def run(state, batches, example):
            for b in batches:
                step = CapturedStep(make_fused_tile_step())
                aot = build_aot_step(step, state, example)
                g = torch.cuda.CUDAGraph()
                step(state, b)

        def run_clean(state, batches):
            step = CapturedStep(make_fused_tile_step())
            for b in batches:
                step(state, b)
    """
    got = _port(src, select=["BJX125"])
    assert [(f.rule, f.line) for f in got] == [
        ("BJX125", 9), ("BJX125", 9), ("BJX125", 10), ("BJX125", 11)]
    assert _port(src.replace("# bjx: driver-hot-path", ""),
                 select=["BJX125"]) == []


def test_a_captured_dispatch_is_read_as_a_captured_callable():
    """A ``CapturedDispatch`` is read where the JAX rules read a
    ``jax.jit`` outside a step: its function is captured (BJX101), its
    batch is plan-keyed (BJX122, in position 0) and takes no stamps
    (BJX120), and building one in a driver loop captures again (BJX125).
    It writes no state, so a view of its batch read after the call is no
    BJX121 finding, where the same view around a ``CapturedStep`` is."""
    src = """
        # bjx: driver-hot-path
        from blendjax_torch.train import CapturedDispatch, CapturedStep

        def impure(group):
            print(group)
            return group

        decode = CapturedDispatch(impure, "cuda", "decode")
        step = CapturedStep(lambda state, b: state)

        def feed(batch):
            return decode({"_packed": batch["tiles"],
                           "_n": int(batch["count"])})

        def leak(batch, traces):
            batch["_traces"] = traces
            return decode(batch)

        def held(group):
            view = group["_packed"].view(-1)
            decode(group)
            return view

        def held_step(state, b):
            view = state["w"].view(-1)
            step(state, b)
            return view

        def loop(batches):
            for b in batches:
                d = CapturedDispatch(impure, "cuda", "decode")
                d(b)
    """
    got = _project(src, select=["BJX120", "BJX121", "BJX122"])
    assert sorted((f.rule, f.identity) for f in got) == [
        ("BJX120", "pkg.m0.leak:_traces->CapturedDispatch(impure)"),
        ("BJX121", "pkg.m0.held_step:view"),
        ("BJX122",
         "pkg.m0.feed:CapturedDispatch(impure):_n=int(batch['count'])")]
    assert [(f.rule, f.line) for f in _port(
        src, select=["BJX101", "BJX125"])] == [("BJX101", 6),
                                               ("BJX125", 32)]


def _line_of(relpath, text):
    """The number of the first line of ``relpath`` that holds ``text``."""
    with open(os.path.join(REPO, relpath)) as f:
        return next(n for n, line in enumerate(f, 1) if text in line)


def test_the_census_attributes_recorded_syncs():
    """``chip_smoke.py``'s census bookkeeping on the CPU: syncs reported
    from frames of the port's files (a thread's too) land on their line
    of the innermost ``blendjax_torch/`` frame; a line with a finding or
    a justified suppression of the census rules is ``flagged``, a listed
    qualified name ``sanctioned``, a non-hot module ``outside``, any other
    hot-module line ``unflagged``."""
    import threading
    import warnings

    import chip_smoke

    def frames_in(relpath, line, qual, body):
        """A function compiled under ``relpath`` at ``line`` that warns."""
        cls, _, meth = qual.rpartition(".")
        src = "\n" * (line - 3) + (
            f"class {cls}:\n    def {meth}(self):\n        {body}\n"
            if cls else f"def {meth}():\n\n        {body}\n")
        ns = {"warnings": warnings}
        exec(compile(src, os.path.join(REPO, relpath), "exec"), ns)
        return ns[cls]().__getattribute__(meth) if cls else ns[meth]

    warn = "warnings.warn('called a synchronizing CUDA operation')"
    pipeline, echo = ("blendjax_torch/data/pipeline.py",
                      "blendjax_torch/data/echo.py")
    found, hot = chip_smoke.census_index()
    # the feeder's throttle wait, and a line of EchoingPipeline that no
    # rule flags and no comment suppresses, found by their text
    throttle = _line_of(pipeline, "head.synchronize()")
    with open(os.path.join(REPO, echo)) as f:
        lines = f.read().splitlines()
    start = _line_of(echo, "class EchoingPipeline:")
    plain = next(n for n in range(start + 1, len(lines) + 1)
                 if (echo, n) not in found and "bjx:" not in lines[n - 1])
    loss = frames_in("blendjax_torch/train/driver.py", 270,
                     "TrainDriver._sync_oldest", warn)
    feeder = frames_in(pipeline, throttle, "DeviceFeeder._pinned_slot", warn)
    stray = frames_in(echo, plain, "EchoingPipeline._stray", warn)
    model = frames_in("blendjax_torch/models/cube.py", 50, "Cube.forward",
                      warn)
    with chip_smoke.SyncCensus("cpu", card=False) as census:
        loss()
        loss()
        t = threading.Thread(target=feeder)
        t.start()
        t.join()
        stray()
        model()
        with pytest.warns(UserWarning, match="not a sync"):
            warnings.warn("not a sync")
    assert census.sites == {
        ("blendjax_torch/train/driver.py", 270,
         "blendjax_torch.train.driver.TrainDriver._sync_oldest"): 2,
        (pipeline, throttle,
         "blendjax_torch.data.pipeline.DeviceFeeder._pinned_slot"): 1,
        (echo, plain, "blendjax_torch.data.echo.EchoingPipeline._stray"): 1,
        ("blendjax_torch/models/cube.py", 50,
         "blendjax_torch.models.cube.Cube.forward"): 1,
    }
    assert found[(pipeline, throttle)] == ["BJX102"]
    rows = {r["site"]: (r["verdict"], r["count"]) for r in
            chip_smoke.census_verdicts(census.sites, found, hot)}
    assert rows == {
        "blendjax_torch/train/driver.py:270": ("sanctioned", 2),
        f"{pipeline}:{throttle}": ("flagged", 1),
        f"{echo}:{plain}": ("unflagged", 1),
        "blendjax_torch/models/cube.py:50": ("outside", 1),
    }
    out = census.report(6, 0)
    assert out["per_step"] == 5 / 6
    assert [r["site"] for r in out["unflagged"]] == [f"{echo}:{plain}"]
    chip_smoke.census_gate({**out, "unflagged": []})
    with pytest.raises(SystemExit):
        chip_smoke.census_gate(out)
    assert chip_smoke.census_site([
        ("/usr/lib/python3/warnings.py", 1, "warn"),
        (os.path.join(REPO, "chip_smoke.py"), 9, "main")]) == (
        "chip_smoke.py", 9, "main")
    for qual, (rule, sentence) in chip_smoke.CENSUS_SANCTIONED.items():
        doc = sys.modules[f"blendjax_torch.analysis.rules."
                          f"{RULE_MODULES[rule]}"].__doc__
        assert " ".join(sentence.split()) in " ".join(doc.split()), qual


#: the module of each census rule (the sanctioned sentences live in their
#: docstrings)
RULE_MODULES = {"BJX102": "hotpath", "BJX106": "driver_sync",
                "BJX108": "reservoir_sync", "BJX111": "mesh_placement",
                "BJX115": "actor_loop"}


def test_the_port_exports_what_the_jax_analyzer_exports():
    """``blendjax_torch.analysis`` exports the JAX analyzer's names, and
    ``project.py`` the names of its dataflow layer."""
    import blendjax.analysis as jax_analysis
    import blendjax.analysis.project as jax_project
    import blendjax_torch.analysis as analysis
    from blendjax_torch.analysis import project

    assert sorted(analysis.__all__) == sorted(jax_analysis.__all__)
    for name in jax_project.__all__:
        assert hasattr(project, name), name


# -- the self-gate -------------------------------------------------------------


def test_the_port_is_clean_under_its_baseline():
    """The rules (per file and whole program), strict suppressions and the
    contract gate over ``blendjax_torch/`` (``chip_smoke.py`` too for the
    contracts), the dataflow layer included: no finding past the port's
    baseline, whose one entry is the counterpart of the JAX baseline's
    (BJX102 at the feeder's throttle wait), in under 30 s (the JAX gate's budget,
    ``tests/test_analysis.py:test_full_repo_lint_fits_the_ci_wall_time_budget``)."""
    t0 = time.perf_counter()
    modules, errors = core.parse_paths(
        [os.path.join(REPO, "blendjax_torch")], root=REPO)
    assert not errors
    found = (core.analyze_modules(modules)
             + core.analyze_project_modules(modules)
             + core.check_suppression_hygiene(modules))
    baseline = core.load_baseline(core.BASELINE_DEFAULT)
    assert len(baseline) == 1
    assert [(f.rule, f.path) for f in found] == [
        ("BJX102", "blendjax_torch/data/pipeline.py")]
    assert "head.synchronize()" in open(
        os.path.join(REPO, found[0].path)).read().splitlines()[found[0].line - 1]
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
    from blendjax_torch.analysis.rules.markers import (
        _is_actor_hot,
        _is_driver_hot,
        _is_hot,
        _is_mesh_hot,
    )

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
    assert _is_mesh_hot(by["blendjax_torch/train/mesh_driver.py"])
    assert _is_actor_hot(by["blendjax_torch/rl/actor.py"])
    for rel in ("train/mesh_driver.py", "rl/actor.py"):
        src = by["blendjax_torch/" + rel].source
        assert ("bjx: mesh-hot-path" in src) or ("bjx: actor-hot-path" in src)
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
    assert marks >= 19


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
    """``--list-rules`` prints exactly the JAX analyzer's rule ids, each
    with the JAX rule's scope; ``--select`` accepts every one of them (no
    rule is left for a later slice) and refuses an id neither registers
    (exit 2)."""
    jax_rules = jax_core.all_rules()
    code = (
        "import sys; from blendjax_torch.analysis.__main__ import main; "
        "print('rc', main(['--list-rules'])); "
        f"print('rc', main(['--select', '{','.join(sorted(jax_rules))}', "
        "'--no-project', 'blendjax_torch/analysis/rules/markers.py'])); "
        "print('rc', main(['--select', 'BJX199']))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    listed = [ln.split()[0] for ln in lines if ln.startswith("BJX")]
    assert listed == sorted(jax_rules)
    assert set(SLICE_RULES) | set(TWIN_RULES) | {"BJX125"} == set(listed)
    for ln in lines:
        if ln.startswith("BJX"):
            scope = ("[project]" if jax_rules[ln.split()[0]].project
                     else "[file]")
            assert scope in ln, ln
    assert [ln for ln in lines if ln.startswith("rc")] == [
        "rc 0", "rc 0", "rc 2"]
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
