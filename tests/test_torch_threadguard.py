"""The port's threadguard sanitizer (``blendjax_torch.testing.threadguard``)
and its wiring (``blendjax_torch.utils.tg``).

- The JAX package's thirteen cases of ``tests/test_threadguard.py`` run
  against the port's copy: affinity and lock-discipline violations raise at
  the access site, sanctioned paths stay silent, and the disabled
  indirection is the identity.
- Every guard site of the JAX package has its counterpart in the port, by
  name (the echo reservoir's included), and the echo reservoir is guarded
  with first-use affinity: a second thread's draw raises.
- The threaded port test files pass under ``BLENDJAX_THREADGUARD=1`` (one
  subprocess with its own time limit).
"""

import ast
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from blendjax_torch.testing.threadguard import (
    LockDisciplineError,
    ThreadAffinityError,
    ThreadGuardError,
    guard,
    unguard,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Box:
    def __init__(self):
        self.value = 0

    def bump(self):
        self.value += 1
        return self.value


def run_in_thread(fn):
    """Run fn on a fresh thread; return its result or raise its error."""
    out: dict = {}

    def wrapper():
        try:
            out["result"] = fn()
        except BaseException as e:  # re-raised on the caller's thread
            out["error"] = e

    t = threading.Thread(target=wrapper)
    t.start()
    t.join(5.0)
    assert not t.is_alive()
    if "error" in out:
        raise out["error"]
    return out.get("result")


# -- affinity ----------------------------------------------------------------


def test_creator_affinity_allows_creator_and_rejects_others():
    g = guard(Box(), name="box", affinity="creator")
    assert g.bump() == 1  # creating thread: fine
    with pytest.raises(ThreadAffinityError) as e:
        run_in_thread(g.bump)
    assert "box.bump" in str(e.value)
    assert threading.current_thread().name in str(e.value)


def test_first_use_affinity_binds_to_the_first_toucher():
    g = guard(Box(), name="box", affinity="first-use")
    assert run_in_thread(lambda: g.bump()) == 1  # the binder
    with pytest.raises(ThreadAffinityError):
        g.bump()  # main thread is now the intruder


def test_affinity_error_is_a_threadguard_and_assertion_error():
    g = guard(Box(), affinity="creator")
    try:
        run_in_thread(g.bump)
    except ThreadGuardError as e:
        assert isinstance(e, AssertionError)
    else:
        pytest.fail("expected ThreadAffinityError")


# -- lock discipline ---------------------------------------------------------


def test_lock_mode_requires_holding_an_rlock():
    lock = threading.RLock()
    g = guard(Box(), name="box", lock=lock)
    with pytest.raises(LockDisciplineError) as e:
        g.bump()
    assert "box.bump" in str(e.value)
    with lock:
        assert g.bump() == 1


def test_rlock_ownership_is_exact_not_merely_locked():
    """Another thread holding the RLock must NOT satisfy the check."""
    lock = threading.RLock()
    g = guard(Box(), lock=lock)
    acquired = threading.Event()
    release = threading.Event()

    def holder():
        with lock:
            acquired.set()
            release.wait(5.0)

    t = threading.Thread(target=holder)
    t.start()
    assert acquired.wait(5.0)
    try:
        with pytest.raises(LockDisciplineError):
            g.bump()
    finally:
        release.set()
        t.join(5.0)


def test_plain_lock_degrades_to_locked_check():
    lock = threading.Lock()
    g = guard(Box(), lock=lock)
    with pytest.raises(LockDisciplineError):
        g.bump()
    with lock:
        assert g.bump() == 1


def test_container_dunders_are_checked():
    lock = threading.RLock()
    g = guard({}, name="table", lock=lock)
    with pytest.raises(LockDisciplineError):
        g["k"] = 1
    with lock:
        g["k"] = 1
        assert g["k"] == 1
        assert "k" in g and len(g) == 1 and list(g) == ["k"]
    with pytest.raises(LockDisciplineError):
        len(g)


def test_exempt_attributes_skip_the_checks():
    lock = threading.RLock()
    box = Box()
    box.lock = lock
    g = guard(box, lock=lock, exempt=("lock",))
    assert g.lock is lock  # fetchable BEFORE holding it
    with pytest.raises(LockDisciplineError):
        g.bump()
    with g.lock:
        assert g.bump() == 1


# -- mechanics ----------------------------------------------------------------


def test_guard_is_idempotent_and_unguard_returns_the_raw_object():
    box = Box()
    g = guard(box, affinity="creator")
    assert guard(g, affinity="creator") is g
    assert unguard(g) is box
    assert unguard(box) is box
    # a method fetched through the guard keeps its owner: the guard
    assert g.bump.__self__ is g


def test_guard_requires_a_discipline():
    with pytest.raises(ValueError):
        guard(Box())
    with pytest.raises(ValueError):
        guard(Box(), affinity="psychic")


# -- the production indirection (blendjax_torch.utils.tg) ----------------------


def _tg_probe(env_value):
    """Import blendjax_torch.utils.tg in a fresh interpreter and report
    whether guard() is the identity and whether the sanitizer module was
    imported."""
    env = {k: v for k, v in os.environ.items() if k != "BLENDJAX_THREADGUARD"}
    if env_value is not None:
        env["BLENDJAX_THREADGUARD"] = env_value
    env["PYTHONPATH"] = REPO_ROOT
    code = (
        "import sys, threading\n"
        "from blendjax_torch.utils.tg import guard\n"
        "o = object()\n"
        "print(guard(o, name='x', lock=threading.Lock()) is o,\n"
        "      'blendjax_torch.testing.threadguard' in sys.modules)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=60,
    )
    assert r.returncode == 0, r.stderr
    return r.stdout.strip()


def test_tg_guard_is_identity_when_disabled():
    """The zero-overhead contract: no proxy, no per-access cost, no
    threadguard import unless the environment opts in ("", "0" and
    "false" are off, as in the JAX package)."""
    assert _tg_probe(None) == "True False"
    assert _tg_probe("0") == "True False"
    assert _tg_probe("") == "True False"
    assert _tg_probe("false") == "True False"


def test_tg_guard_wraps_when_enabled():
    assert _tg_probe("1") == "False True"


def test_enabled_env_turns_metrics_lock_discipline_on():
    """End to end through the wiring: an unlocked counter-table write
    inside a guarded registry raises; the public API stays fine."""
    env = {**os.environ, "BLENDJAX_THREADGUARD": "1",
           "PYTHONPATH": REPO_ROOT}
    code = (
        "from blendjax_torch.utils.metrics import Metrics\n"
        "from blendjax_torch.testing.threadguard import LockDisciplineError\n"
        "m = Metrics()\n"
        "m.count('ok')                  # locked path: fine\n"
        "assert m.counter_value('ok') == 1\n"
        "try:\n"
        "    m.counters['raw'] = 1      # unlocked mutation: must raise\n"
        "except LockDisciplineError:\n"
        "    print('raised')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=60,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "raised"


# -- the guard sites ------------------------------------------------------------


def _guard_sites(package: str) -> dict:
    """``{name: "file:line"}`` of every ``guard(..., name=...)`` call in
    ``package`` (an f-string name by its template), the sanitizer itself
    and its indirection left out."""
    sites = {}
    top = os.path.join(REPO_ROOT, package)
    for root, _dirs, names in os.walk(top):
        for n in names:
            if not n.endswith(".py") or os.sep + "testing" in root:
                continue
            path = os.path.join(root, n)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "guard"):
                    continue
                name = next((k.value for k in node.keywords
                             if k.arg == "name"), None)
                if isinstance(name, ast.Constant):
                    key = name.value
                elif isinstance(name, ast.JoinedStr):
                    key = "".join(
                        v.value if isinstance(v, ast.Constant) else "{}"
                        for v in name.values)
                else:
                    continue
                sites[key] = f"{os.path.relpath(path, REPO_ROOT)}:{node.lineno}"
    return sites


def test_the_port_has_every_guard_site_of_the_jax_package():
    """The same guard names in both packages: the four metrics tables,
    the launcher's two, the scenario service's three, the RL reservoir and
    the echo reservoir (13 sites, two of them re-made on teardown)."""
    want, got = _guard_sites("blendjax"), _guard_sites("blendjax_torch")
    assert "echo.reservoir" in want
    assert sorted(got) == sorted(want), (want, got)
    assert got["echo.reservoir"].startswith("blendjax_torch/data/echo.py:")


def _decoded_batches(n=6, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": torch.from_numpy(
                 rng.integers(0, 256, (b, 8, 16, 4), dtype=np.uint8)),
             "xy": torch.from_numpy(rng.random((b, 8, 2)).astype(np.float32))}
            for _ in range(n)]


def test_the_echo_reservoir_is_bound_to_the_iterating_thread(monkeypatch):
    """C9: with the sanitizer on, ``EchoingPipeline.reservoir`` is guarded
    under ``echo.reservoir`` with first-use affinity: the iterating thread
    draws (its drain thread only feeds the queue), and a draw from a second
    thread raises."""
    import blendjax_torch.data.echo as E

    monkeypatch.setattr(E, "guard", guard)
    echo = E.EchoingPipeline(iter(_decoded_batches()), capacity=8,
                             max_echo_factor=2, batch_size=2, augment=None,
                             device="cpu", rng=0)
    assert echo.reservoir._tg_name == "echo.reservoir"
    assert echo.reservoir._tg_mode == "first-use"
    with echo:
        it = iter(echo)
        batches = [next(it) for _ in range(3)]
        assert all(b["image"].shape == (2, 8, 16, 4) for b in batches)
        with pytest.raises(ThreadAffinityError, match="echo.reservoir"):
            run_in_thread(lambda: echo.reservoir.sample(np.array([0, 1])))
        # the iterating thread goes on drawing and snapshots the reservoir
        next(it)
        assert "reservoir" in echo.state_dict()


@pytest.mark.parametrize("package", ["blendjax", "blendjax_torch"])
def test_the_guarded_echo_reservoir_has_the_same_name_in_both(package):
    """Under ``BLENDJAX_THREADGUARD=1`` both packages' echo pipelines hold
    their reservoir behind a guard named ``echo.reservoir`` (a fresh
    interpreter: the switch is read at import)."""
    env = {**os.environ, "BLENDJAX_THREADGUARD": "1",
           "PYTHONPATH": REPO_ROOT, "JAX_PLATFORMS": "cpu"}
    extra = ", device='cpu'" if package == "blendjax_torch" else ""
    code = (
        f"from {package}.data import EchoingPipeline\n"
        f"e = EchoingPipeline(iter([]), capacity=8, batch_size=2{extra})\n"
        "print(type(e.reservoir).__name__, e.reservoir._tg_name,\n"
        "      e.reservoir._tg_mode)\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["_Guarded", "echo.reservoir", "first-use"]


THREADED = ["tests/test_torch_echo.py", "tests/test_torch_fleet.py",
            "tests/test_torch_launcher.py", "tests/test_torch_scenario.py"]
THREADED_K = ("echo_pipeline or echo_accounting or token or elastic or "
              "respawn or dead_producer or membership or scale_up or retire "
              "or admission or service or controller")


def test_threaded_port_tests_pass_under_the_sanitizer():
    """The threaded cases of the port's echo, fleet, launcher and scenario
    tests under ``BLENDJAX_THREADGUARD=1``: every guard site live, no
    ``ThreadGuardError``."""
    env = {**os.environ, "BLENDJAX_THREADGUARD": "1",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", "-k", THREADED_K, *THREADED],
        capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=240,
    )
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert "ThreadGuardError" not in out and "ThreadAffinityError" not in out
    assert " passed" in out and " deselected" in out
