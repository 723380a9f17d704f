"""The port's launcher against the JAX package's, on the CPU, with real
producer processes.

- The handshake: the argv each launcher builds for an instance, and its
  address plan, are byte-equal to the JAX package's; either package's
  ``parse_launch_args`` reads the other's.
- The cases of ``tests/test_launcher.py`` on the port: two instances with
  their seeds, sockets and extra args; a dead producer detected; respawn;
  the producers of a SIGKILLed launcher die with it (the parent-death
  shim); ``wait`` without the membership lock; the CLI app; the elastic
  membership (``add_instance``, ``retire_instance``, ``scale_to``).
- The port's commands in ``pyproject.toml`` resolve, and
  ``blendjax-torch-launch --help`` names itself.
- A ``LaunchInfo`` file written by either package is read by the other.

The producers here are port scripts written into ``tmp_path``; every
receive and every wait has its own time limit.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from blendjax.launcher import LaunchInfo as JLaunchInfo
from blendjax.launcher import arguments as JArgs
from blendjax.launcher import launcher as JL
from blendjax_torch.launcher import LaunchInfo, ProcessLauncher
from blendjax_torch.launcher import arguments as TArgs
from blendjax_torch.launcher import launcher as TL
from blendjax_torch.launcher.launcher import PythonProducerLauncher
from blendjax_torch.transport import DataReceiverSocket

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBE = os.path.join(REPO, "blendjax_torch", "producer", "cube.py")
TIMEOUT = 20_000

ECHO = """\
import sys, time
from blendjax_torch.launcher import parse_launch_args
from blendjax_torch.transport import DataPublisherSocket, term_context

args, remainder = parse_launch_args(sys.argv)
pub = DataPublisherSocket(args.btsockets["DATA"], btid=args.btid,
                          lingerms=5000)
pub.publish(btseed=args.btseed, sockets=args.btsockets, remainder=remainder)
time.sleep(10)  # the consumer connects and drains meanwhile
pub.close()
term_context()
"""


@pytest.fixture
def echo(tmp_path):
    path = tmp_path / "echo_producer.py"
    path.write_text(ECHO)
    return str(path)


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _recv_all(addrs, n):
    recv = DataReceiverSocket(addrs, timeoutms=TIMEOUT)
    try:
        seen = {}
        while len(seen) < n:
            msg, _ = recv.recv()
            seen[msg["btid"]] = msg
        return seen
    finally:
        recv.close()


# -- the handshake --------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--render-every", "10", "scene=a.b"]])
def test_the_handshake_argv_is_the_references(extra):
    sockets = {"DATA": "tcp://127.0.0.1:11000", "CTRL": "ipc:///tmp/x/CTRL-3"}
    port = TArgs.format_launch_args(3, 13, sockets, extra=extra)
    ref = JArgs.format_launch_args(3, 13, sockets, extra=extra)
    assert port == ref
    argv = ["ignored", "--"] + port
    args, remainder = TArgs.parse_launch_args(argv)
    ref_args, ref_rem = JArgs.parse_launch_args(argv)
    assert (args.btid, args.btseed, args.btsockets, remainder) == (
        ref_args.btid, ref_args.btseed, ref_args.btsockets, ref_rem)
    assert args.instance_id == 3 and args.seed == 13 and args.sockets
    with pytest.raises(ValueError, match="btid"):
        TArgs.parse_launch_args(["--", "-btseed", "1"])


@pytest.mark.parametrize("proto", ["tcp", "ipc"])
def test_the_launchers_build_the_references_argv(proto):
    """The full argv of each instance (python, script, script args, the
    handshake, the instance's args) and the deterministic address plan are
    byte-equal to the JAX package's."""
    kw = dict(script="/opt/p.py", script_args=["-u"], num_instances=3,
              named_sockets=["DATA", "GYM"], seed=40, start_port=12000,
              instance_args=[["--a", "1"], [], ["--b"]], proto=proto)
    port, ref = PythonProducerLauncher(**kw), JL.PythonProducerLauncher(**kw)
    if proto == "tcp":
        assert port._allocate_addresses() == ref._allocate_addresses()
        assert port._instance_addresses(3) == ref._instance_addresses(3)
    for i in range(3):
        sockets = {"DATA": f"ipc:///d/DATA-{i}", "GYM": f"ipc:///d/GYM-{i}"}
        assert port._instance_argv(i, sockets) == ref._instance_argv(i, sockets)
        assert port._instance_argv(i, sockets, extra=["--c"]) == \
            ref._instance_argv(i, sockets, extra=["--c"])


# -- launches ---------------------------------------------------------------------


def test_launch_two_instances_handshake(echo):
    with PythonProducerLauncher(
        script=echo, num_instances=2, named_sockets=["DATA"], seed=10,
        instance_args=[["--x", "a"], ["--x", "b"]],
    ) as launcher:
        addrs = launcher.addresses["DATA"]
        assert len(set(addrs)) == 2
        assert all(a.startswith("tcp://127.0.0.1:") for a in addrs)
        seen = _recv_all(addrs, 2)
    assert seen[0]["btseed"] == 10 and seen[1]["btseed"] == 11
    assert seen[0]["remainder"] == ["--x", "a"]
    assert seen[1]["remainder"] == ["--x", "b"]
    assert seen[0]["sockets"]["DATA"] == addrs[0]


def test_assert_alive_and_teardown(echo):
    with PythonProducerLauncher(script=echo, num_instances=1,
                                proto="ipc") as launcher:
        launcher.assert_alive()
        pid = launcher.processes[0].pid
        ipc_dir = launcher._ipc_dir
        registry = launcher._shm_registry
        assert os.path.isdir(ipc_dir) and os.path.isdir(registry)
    with pytest.raises(OSError):
        os.kill(pid, 0)
    assert not os.path.exists(ipc_dir) and not os.path.exists(registry)


def test_dead_producer_detected():
    with PythonProducerLauncher(
        script="-c", script_args=["import sys; sys.exit(3)"], num_instances=1
    ) as launcher:
        launcher.processes[0].wait(timeout=30)
        with pytest.raises(RuntimeError, match="died") as err:
            launcher.assert_alive()
        assert "{0: 3}" in str(err.value)


def test_a_missing_command_raises_before_spawning():
    with pytest.raises(FileNotFoundError):
        ProcessLauncher(lambda i, h: ["/nonexistent/producer"] + h).__enter__()


def test_respawn_brings_producer_back(echo):
    with PythonProducerLauncher(script=echo, num_instances=1,
                                respawn=True) as launcher:
        first = launcher.processes[0]
        first.terminate()
        first.wait(timeout=30)
        launcher.poll()
        launcher.assert_alive()
        assert launcher.processes[0].pid != first.pid
        assert launcher.launch_info.processes[0] == launcher.processes[0].pid
        # the respawned producer speaks the same handshake
        assert _recv_all(launcher.addresses["DATA"], 1)[0]["btseed"] == 0


def test_elastic_membership(echo):
    """add_instance continues the btid and seed ladder and inherits the
    last active instance's args; retire_instance drains and keeps the
    slot; scale_to composes them; a retired slot is never respawned."""
    with PythonProducerLauncher(
        script=echo, num_instances=1, seed=5, respawn=True,
        instance_args=[["--k", "v"]], bind_grace_s=0.5,
    ) as ln:
        i, sockets = ln.add_instance()
        assert i == 1 and ln.active_indices() == [0, 1]
        assert ln.addresses["DATA"][1] == sockets["DATA"]
        msg = _recv_all([sockets["DATA"]], 1)[1]
        assert msg["btseed"] == 6 and msg["remainder"] == ["--k", "v"]
        assert ln.retire_instance(1, drain=False) == sockets
        assert ln.retired == {1} and ln.active_count() == 1
        assert ln.poll()[1] is not None  # retired: not respawned
        ln.assert_alive()
        with pytest.raises(ValueError, match="retired"):
            ln.respawn_instance(1)
        added, removed = ln.scale_to(2, extra_args=[])
        assert [a[0] for a in added] == [2] and removed == []
        added, removed = ln.scale_to(1)
        assert added == [] and [r[0] for r in removed] == [2]
        assert ln.active_indices() == [0]


def _remote_launch(info_path, ready, echo):
    from blendjax_torch.launcher.launcher import PythonProducerLauncher

    with PythonProducerLauncher(script=echo, num_instances=1, seed=5) as ln:
        ln.launch_info.save_json(info_path)
        ready.set()
        ln.wait()


def test_two_machine_workflow_via_launch_info(tmp_path, echo):
    import multiprocessing as mp

    info_path = str(tmp_path / "launch_info.json")
    ctx = mp.get_context("spawn")
    ready = ctx.Event()
    proc = ctx.Process(target=_remote_launch, args=(info_path, ready, echo))
    proc.start()
    try:
        assert ready.wait(timeout=60)
        info = JLaunchInfo.load_json(info_path)  # read by the JAX package
        msg = _recv_all(info.addresses["DATA"], 1)[0]
        assert msg["btseed"] == 5
    finally:
        proc.terminate()
        proc.join(timeout=20)
    assert not proc.is_alive()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_launch_info_is_read_across_packages(tmp_path, writer):
    import io

    kw = dict(addresses={"DATA": ["tcp://1.2.3.4:11000"],
                         "GYM": ["ipc:///tmp/g"]},
              commands=["blender ..."], processes=[123])
    src, dst = (LaunchInfo, JLaunchInfo) if writer == "port" else (
        JLaunchInfo, LaunchInfo)
    path = tmp_path / "li.json"
    src(**kw).save_json(str(path))
    back = dst.load_json(str(path))
    assert (back.addresses, back.commands, back.processes) == (
        kw["addresses"], kw["commands"], kw["processes"])
    buf = io.StringIO()
    src(**kw).save_json(buf)
    assert dst.from_json(buf.getvalue()).addresses == kw["addresses"]
    assert LaunchInfo(**kw).to_json() == JLaunchInfo(**kw).to_json()


def test_cli_app_python_kind(tmp_path, echo):
    cfg = {"kind": "python", "script": echo, "num_instances": 1,
           "named_sockets": ["DATA"], "seed": 2}
    cfg_path = tmp_path / "launch.json"
    cfg_path.write_text(json.dumps(cfg))
    out_path = tmp_path / "info.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "blendjax_torch.launcher.apps", str(cfg_path),
         "--out", str(out_path)],
        cwd=str(tmp_path), env=_child_env(),
    )
    try:
        deadline = time.time() + 60
        while not out_path.exists() and time.time() < deadline:
            time.sleep(0.1)
        assert out_path.exists()
        info = LaunchInfo.load_json(str(out_path))
        assert _recv_all(info.addresses["DATA"], 1)[0]["btseed"] == 2
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    # SIGTERM unwound the launcher: its producer is gone
    for pid in info.processes:
        with pytest.raises(OSError):
            os.kill(pid, 0)


def _port_scripts() -> dict:
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {k: v for k, v in scripts.items() if "blendjax_torch" in v}


def test_every_port_command_resolves_to_a_callable():
    """Each ``[project.scripts]`` entry of ``pyproject.toml`` that names
    the port imports and names a callable; the launcher service's command
    is among them, as the JAX package's ``blendjax-launch`` is."""
    import importlib

    scripts = _port_scripts()
    assert scripts["blendjax-torch-launch"] == (
        "blendjax_torch.launcher.apps:main")
    for name, target in scripts.items():
        module, _, attr = target.partition(":")
        assert callable(getattr(importlib.import_module(module), attr)), name


def test_the_launch_command_prints_its_usage(capsys):
    """``blendjax-torch-launch --help`` exits 0, and its usage line names
    the command."""
    from blendjax_torch.launcher.apps import main

    with pytest.raises(SystemExit) as exc:
        main(["--help"])
    assert exc.value.code == 0
    usage = capsys.readouterr().out.splitlines()[0]
    assert usage.startswith("usage: blendjax-torch-launch "), usage


@pytest.mark.skipif(sys.platform != "linux", reason="PDEATHSIG is Linux-only")
def test_producers_die_with_killed_launcher():
    """SIGKILL the launcher's process (its __exit__ never runs): the
    parent-death signal still ends the producer, the port's cube producer
    that streams until killed."""
    child_src = textwrap.dedent(
        """
        import json, time
        from blendjax_torch.launcher import PythonProducerLauncher
        ln = PythonProducerLauncher(
            script=%r, num_instances=1, named_sockets=["DATA"], seed=0,
            instance_args=[["--shape", "32", "64", "--no-native"]],
        ).__enter__()
        print(json.dumps(ln.launch_info.processes), flush=True)
        time.sleep(60)
        """
        % CUBE
    )
    p = subprocess.Popen([sys.executable, "-c", child_src],
                         stdout=subprocess.PIPE, text=True, env=_child_env())
    try:
        pids = json.loads(p.stdout.readline())
        os.kill(p.pid, signal.SIGKILL)
        p.wait(timeout=10)
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                os.kill(pids[0], 0)
            except ProcessLookupError:
                return
            time.sleep(0.2)
        os.kill(pids[0], signal.SIGKILL)
        pytest.fail("producer outlived its SIGKILLed launcher")
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)


def test_wait_does_not_hold_the_membership_lock():
    def command(i, handshake):
        return [sys.executable, "-c", "import time; time.sleep(30)"] + handshake

    with ProcessLauncher(command, num_instances=1,
                         named_sockets=["DATA"]) as ln:
        done = threading.Event()
        codes = []

        def waiter():
            codes.append(ln.wait())
            done.set()

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        for _ in range(5):
            assert ln.poll_processes() == [None]
            assert ln.active_indices() == [0]
        ln.retire_instance(0, drain=False)
        assert done.wait(10.0), "wait() never returned after the kill"
        assert codes and codes[0][0] is not None


def test_kill_all_spawned_sweeps_every_producer():
    def command(i, handshake):
        return [sys.executable, "-c", "import time; time.sleep(30)"] + handshake

    ln = ProcessLauncher(command, num_instances=2).__enter__()
    try:
        procs = list(ln.processes)
        TL.kill_all_spawned()
        for p in procs:
            assert p.wait(timeout=10) == -signal.SIGKILL
    finally:
        ln.__exit__(None, None, None)
