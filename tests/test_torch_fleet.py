"""The port's elastic producer fleet (blendjax_torch.fleet: controller,
admission, the synthetic producer tier) and the pipeline's membership
calls, against the JAX package's (blendjax.fleet), on the CPU.

The controller's policy arms are the JAX package's clockless cases,
driven by the same scripted verdicts with a fake launcher, connector and
lineage on both packages: every decision, the event log (times left out),
the registry's ``fleet.*`` counters and the instance counts must be
identical. Admission runs across the packages over a real REP socket.
The live cases start real producer processes; every wait has its own
timeout.
"""

import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import zmq

import blendjax.fleet as JF
import blendjax_torch.fleet as PF
from blendjax.utils.metrics import Metrics as JMetrics
from blendjax_torch.obs.lineage import FrameLineage, lineage
from blendjax_torch.utils.metrics import Metrics, metrics

TIMEOUT_S = 15.0


@pytest.fixture(autouse=True)
def _clean_registries():
    metrics.reset()
    lineage.reset()
    yield
    metrics.reset()
    lineage.reset()


class FakeLauncher:
    """The elastic-membership surface of ProcessLauncher."""

    def __init__(self, n: int = 1):
        self.n = n
        self._retired: set = set()
        self.dead: dict = {}
        self.added: list = []
        self.respawned: list = []

    def _addr(self, i):
        return f"tcp://127.0.0.1:{9000 + i}"

    def active_indices(self):
        return [i for i in range(self.n) if i not in self._retired]

    def active_count(self):
        return len(self.active_indices())

    def poll_processes(self):
        return [self.dead.get(i) for i in range(self.n)]

    def add_instance(self, extra_args=None):
        i = self.n
        self.n += 1
        self.added.append((i, extra_args))
        return i, {"DATA": self._addr(i), "CTRL": self._addr(i + 100)}

    def retire_instance(self, i, drain=True):
        self._retired.add(i)
        return {"DATA": self._addr(i), "CTRL": self._addr(i + 100)}

    def respawn_instance(self, i):
        self.dead.pop(i, None)
        self.respawned.append(i)

    def instance_sockets(self, i):
        return {"DATA": self._addr(i)}


class Recorder:
    """Connector, lineage and scenario service at once: one ordered log."""

    def __init__(self):
        self.log: list = []

    def connect(self, addr):
        self.log.append(("connect", addr))

    def disconnect(self, addr):
        self.log.append(("disconnect", addr))

    def register(self, btid):
        self.log.append(("register", btid))

    def retire(self, btid):
        self.log.append(("retire", btid))
        return True

    def attach(self, btid, addr):
        self.log.append(("attach", btid, addr))

    def detach(self, btid):
        self.log.append(("detach", btid))


def _arm(pkg, case):
    """One of the JAX package's controller cases on ``pkg``; returns what
    must match across the packages."""
    F = PF if pkg == "port" else JF
    rec = Recorder()
    registry = Metrics() if pkg == "port" else JMetrics()
    policy, n, kw, script = {
        "scale-up-cooldown": (
            dict(min_instances=1, max_instances=3, up_after=2, down_after=2,
                 cooldown_s=10.0), 1, {},
            [("producer-bound", t) for t in (0.0, 1.0, 2.0, 3.0, 10.5, 12.0)]
            + [("echo-saturated", t) for t in (30.0, 31.0, 32.0)]),
        "scale-down-drain": (
            dict(min_instances=1, max_instances=3, up_after=1, down_after=2,
                 cooldown_s=0.0, drain_grace_s=2.0), 3, {},
            [("step-bound", 0.0), ("step-bound", 1.0), ("balanced", 1.5),
             ("balanced", 3.5)]),
        "interleaved": (
            dict(min_instances=1, max_instances=3, up_after=2, down_after=2,
                 cooldown_s=0.0), 1, {},
            list(zip(["producer-bound", "balanced", "producer-bound",
                      "idle", "producer-bound", "feed-bound"],
                     map(float, range(6))))),
        "breaching": (
            dict(min_instances=1, max_instances=4, up_after=1, down_after=1,
                 cooldown_s=0.0), 3, {"health": lambda: False},
            [("idle", float(t)) for t in range(5)]
            + [("producer-bound", 9.0)]),
        "respawn": (dict(min_instances=1, max_instances=2), 2,
                    {"health": lambda: False}, [("balanced", 0.0)]),
        "event-log": (
            dict(min_instances=1, max_instances=64, up_after=1,
                 cooldown_s=0.0), 1, {"event_log": 4},
            [("producer-bound", float(t)) for t in range(8)]),
        "scenario-attach": (
            dict(min_instances=1, max_instances=3, up_after=1,
                 cooldown_s=0.0), 1, {"scenario_service": rec},
            [("producer-bound", 100.0)]
            + [("step-bound", t) for t in (200.0, 300.0, 400.0, 500.0)]),
        "rl-vocabulary": (
            None, 1, {},
            [("env-bound", 0.0), ("env-bound", 1.0), ("learner-bound", 20.0)]
            + [("learner-bound", float(t)) for t in range(30, 34)]),
    }[case]
    launcher = FakeLauncher(n)
    if case == "respawn":
        launcher.dead[0] = 137
    policy = (F.FleetPolicy.rl(up_after=2, down_after=4, cooldown_s=5.0,
                               max_instances=3)
              if policy is None else F.FleetPolicy(**policy))
    ctrl = F.FleetController(launcher, connector=rec, policy=policy,
                             lineage=rec, registry=registry,
                             respawn_dead=True, **kw)
    decisions = []
    for i, (verdict, t) in enumerate(script):
        if case == "respawn" and i == 0:
            decisions.append(ctrl.tick(verdict=verdict, now=t))
            launcher.retire_instance(1)
            launcher.dead[1] = 1
            verdict, t = "balanced", 1.0
        decisions.append(ctrl.tick(verdict=verdict, now=t))
    events = [{k: v for k, v in e.items() if k != "t"} for e in ctrl.events]
    state = {k: v for k, v in ctrl.state().items() if k != "events"}
    counters = registry.report()["counters"]
    return {
        "decisions": decisions, "events": events, "state": state,
        "counters": {k: v for k, v in counters.items()
                     if k.startswith("fleet.")},
        "log": rec.log, "launcher": (launcher.active_indices(),
                                     launcher.added, launcher.respawned),
        "scale_events": [{k: v for k, v in e.items() if k != "t"}
                         for e in ctrl.scale_events()],
    }


ARMS = ["scale-up-cooldown", "scale-down-drain", "interleaved", "breaching",
        "respawn", "event-log", "scenario-attach", "rl-vocabulary"]


@pytest.mark.parametrize("case", ARMS)
def test_controller_decides_as_the_reference(case):
    got, want = _arm("port", case), _arm("jax", case)
    assert got == want
    actions = [d["action"] for d in got["decisions"]]
    counters = got["counters"]
    if case == "scale-up-cooldown":
        assert actions == ["hold", "scale_up", "hold", "hold", "hold",
                           "scale_up", "hold", "hold", "hold"]
        assert counters["fleet.scale_ups"] == 2
        assert "fleet.scale_downs" not in counters
        assert got["state"]["instances"] == 3
    elif case == "scale-down-drain":
        assert actions[1] == "scale_down"
        # the disconnect lands after the grace window, then the retire
        assert got["log"][-2:] == [("disconnect", "tcp://127.0.0.1:9002"),
                                   ("retire", 2)]
        assert counters["fleet.scale_downs"] == 1
    elif case == "interleaved":
        assert set(actions) == {"hold"}
    elif case == "breaching":
        assert actions[:5] == ["hold"] * 5 and actions[5] == "scale_up"
        assert all(d["healthy"] is False for d in got["decisions"])
    elif case == "respawn":
        assert got["decisions"][0]["respawned"] == [0]
        assert got["decisions"][1]["respawned"] == []
        ev = [e for e in got["events"] if e["action"] == "respawn"]
        assert ev == [{"action": "respawn", "instance": 0, "exit_code": 137,
                       "during_breach": True}]
        assert counters["fleet.respawns"] == 1
    elif case == "event-log":
        assert len(got["events"]) == 4 and len(got["scale_events"]) == 4
        assert got["state"]["instances"] == 9
        assert got["state"]["ticks"] == 8
    elif case == "scenario-attach":
        # scenario before data on the way up, detach at retire
        assert got["log"][:3] == [
            ("register", 1), ("attach", 1, "tcp://127.0.0.1:9101"),
            ("connect", "tcp://127.0.0.1:9001")]
        assert ("detach", 1) in got["log"] and actions[-1] == "scale_down"
    else:  # env-bound scales up, a sustained learner-bound down
        assert actions == ["hold", "scale_up", "hold", "hold", "hold",
                           "scale_down", "hold"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_remote_admission_lifecycle_with_drain_grace(pkg):
    F = PF if pkg == "port" else JF
    rec = Recorder()
    ctrl = F.FleetController(
        FakeLauncher(1), connector=rec, lineage=rec,
        registry=Metrics() if pkg == "port" else JMetrics(),
        policy=F.FleetPolicy(min_instances=1, max_instances=2,
                             drain_grace_s=2.0))
    assert ctrl.admit_remote("boxA", "tcp://10.0.0.7:5555",
                             {"rate": 30}) == {"ok": True}
    assert ctrl.state()["instances"] == 2
    assert ctrl.admit_remote("boxA", "tcp://10.0.0.7:5555")["already"]
    assert ctrl.tick(verdict="idle", now=0.0)["instances"] == 2
    assert ctrl.retire_remote("boxA", now=10.0)["ok"] is True
    ctrl.tick(verdict="balanced", now=11.0)
    ctrl.tick(verdict="balanced", now=12.5)
    assert ctrl.retire_remote("ghost")["ok"] is False
    # re-announce with a new address retires the stale one, keeps lineage
    assert ctrl.admit_remote("boxB", "tcp://10.0.0.8:5555", now=20.0)["ok"]
    assert ctrl.admit_remote("boxB", "tcp://10.0.0.8:6666", now=21.0)["ok"]
    ctrl.tick(verdict="balanced", now=23.5)
    for bad in ("garbage", "tcp://garbage", "tcp://host:notaport", "://x"):
        r = ctrl.admit_remote("boxC", bad)
        assert r["ok"] is False and "malformed" in r["error"]
    assert ctrl.admit_remote("boxD", "ipc:///tmp/feed.sock")["ok"] is True
    assert rec.log == [
        ("connect", "tcp://10.0.0.7:5555"), ("register", "boxA"),
        ("connect", "tcp://10.0.0.7:5555"),
        ("disconnect", "tcp://10.0.0.7:5555"), ("retire", "boxA"),
        ("connect", "tcp://10.0.0.8:5555"), ("register", "boxB"),
        ("connect", "tcp://10.0.0.8:6666"), ("register", "boxB"),
        ("disconnect", "tcp://10.0.0.8:5555"),
        ("connect", "ipc:///tmp/feed.sock"), ("register", "boxD"),
    ]


def test_remote_admission_attaches_the_announced_ctrl_addr():
    rec = Recorder()
    ctrl = PF.FleetController(FakeLauncher(1), connector=rec, lineage=rec,
                              scenario_service=rec, registry=Metrics())
    assert ctrl.admit_remote("box-1", "tcp://10.0.0.5:5555",
                             telemetry={"ctrl_addr": "tcp://10.0.0.5:5556"}
                             )["ok"]
    ctrl.retire_remote("box-1", now=0.0)
    assert rec.log[:2] == [("attach", "box-1", "tcp://10.0.0.5:5556"),
                           ("connect", "tcp://10.0.0.5:5555")]
    assert ("detach", "box-1") in rec.log


def test_the_controllers_snapshot_crosses_the_packages():
    rec = Recorder()
    ctrl = PF.FleetController(FakeLauncher(2), connector=rec, lineage=rec,
                              registry=Metrics())
    ctrl.admit_remote("box", "tcp://10.0.0.2:5555")
    jrec = Recorder()
    jl = FakeLauncher(1)
    jctrl = JF.FleetController(jl, connector=jrec, lineage=jrec,
                               registry=JMetrics(),
                               policy=JF.FleetPolicy(max_instances=4))
    jctrl.load_state_dict(ctrl.state_dict())
    assert jctrl.state_dict() == ctrl.state_dict()
    assert jl.active_count() == 2 and jctrl.remote == ctrl.remote


@pytest.mark.parametrize("bad", [dict(min_instances=0),
                                 dict(min_instances=3, max_instances=2),
                                 dict(up_after=0), dict(down_after=0)])
def test_policy_bounds_raise_value_error(bad):
    with pytest.raises(ValueError):
        PF.FleetPolicy(**bad)
    with pytest.raises(AssertionError):  # the reference asserts
        JF.FleetPolicy(**bad)


def test_the_default_verdict_is_the_pipeline_doctors():
    ctrl = PF.FleetController(FakeLauncher(1), connector=Recorder(),
                              lineage=Recorder(), registry=Metrics())
    assert ctrl.tick(now=0.0)["verdict"] == "idle"  # nothing recorded yet
    with metrics.span("train.dispatch"):
        time.sleep(0.01)
    assert ctrl.tick(now=1.0)["verdict"] != "idle"


def test_the_rl_doctor_drives_the_rl_policy():
    from blendjax_torch.rl import diagnose_rl_current

    ctrl = PF.FleetController(FakeLauncher(1), connector=Recorder(),
                              lineage=Recorder(), registry=Metrics(),
                              diagnose=diagnose_rl_current,
                              policy=PF.FleetPolicy.rl(up_after=1,
                                                       cooldown_s=0.0))
    metrics.count("rl.transitions", 10)
    metrics.count("rl.draws", 4)
    metrics.count("rl.sample_waits", 3)
    with metrics.span("rl.sample_wait"):
        time.sleep(0.01)
    d = ctrl.tick(now=0.0)
    assert d["verdict"] == "env-bound" and d["action"] == "scale_up"


def test_controller_thread_lifecycle():
    ctrl = PF.FleetController(
        FakeLauncher(1), connector=Recorder(), lineage=Recorder(),
        registry=Metrics(), interval_s=0.02, diagnose=lambda: "balanced",
        policy=PF.FleetPolicy(min_instances=1, max_instances=1))
    with ctrl:
        deadline = time.monotonic() + TIMEOUT_S
        while ctrl.state()["ticks"] < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        with pytest.raises(RuntimeError, match="already started"):
            ctrl.start()
    assert ctrl.state()["ticks"] >= 2 and ctrl._thread is None


# -- admission across the packages -----------------------------------------------


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_admission_round_trip_across_the_packages(server_pkg):
    """A port server answering the JAX package's producer calls, and the
    reverse; the protocol's error paths answer without a crash."""
    srv_mod, cli_mod = (PF, JF) if server_pkg == "port" else (JF, PF)
    log: list = []
    with srv_mod.AdmissionServer(
        on_announce=lambda btid, addr, tele: (
            log.append(("announce", btid, addr, tele)) or {"ok": True}),
        on_leave=lambda btid: log.append(("leave", btid)) or {"ok": True},
    ) as srv:
        assert srv.addr and not srv.addr.endswith(":0")
        assert cli_mod.announce(srv.addr, "boxA", "tcp://1.2.3.4:5",
                                {"rate": 30}) == {"ok": True}
        assert cli_mod.leave(srv.addr, "boxA")["ok"] is True
        from blendjax_torch.transport.channels import RpcClient

        client = RpcClient(srv.addr, timeoutms=5000, allow_pickle=False)
        try:
            bad = client.call(op="announce")
            assert bad["ok"] is False and "btid" in bad["error"]
            assert client.call(op="warp")["ok"] is False
        finally:
            client.close()
    assert log == [("announce", "boxA", "tcp://1.2.3.4:5", {"rate": 30}),
                   ("leave", "boxA")]


def test_the_admission_server_refuses_a_pickle():
    """The endpoint faces the network: a JAX client's pickle-codec
    request is refused with an error reply, and the server goes on
    answering (the JAX package's serving thread ends there)."""
    from blendjax.transport.channels import RpcClient as JClient
    from blendjax_torch.transport.channels import RpcClient

    with PF.AdmissionServer(on_announce=lambda *a: {"ok": True}) as srv:
        evil = JClient(srv.addr, timeoutms=5000, codec="pickle")
        try:
            reply = evil.call(op="announce", btid=1, data_addr="tcp://a:1")
            assert reply["ok"] is False and "allow_pickle" in reply["error"]
        finally:
            evil.close()
        client = RpcClient(srv.addr, timeoutms=5000)
        try:
            assert client.call(op="announce", btid=1,
                               data_addr="tcp://a:1") == {"ok": True}
        finally:
            client.close()
        with pytest.raises(RuntimeError, match="already started"):
            srv.start()


def test_announce_addr_rewrites_wildcard_host_only():
    from blendjax_torch.fleet.synthetic import announce_addr

    assert announce_addr("tcp://127.0.0.1:5555") == "tcp://127.0.0.1:5555"
    assert announce_addr("tcp://10.1.2.3:7777") == "tcp://10.1.2.3:7777"
    host, _, port = announce_addr("tcp://0.0.0.0:5555").partition(
        "://")[2].rpartition(":")
    assert port == "5555" and host not in ("0.0.0.0", "*", "::", "[::]")


# -- the pipeline's membership -------------------------------------------------------


class FakeShardStream:
    def __init__(self, addresses):
        self.addresses = list(addresses)

    def connect(self, addr):
        if addr not in self.addresses:
            self.addresses.append(addr)

    def disconnect(self, addr):
        self.addresses.remove(addr)


def test_sharded_ingest_routes_connect_to_least_loaded_shard():
    from blendjax_torch.data.shard_ingest import ShardedHostIngest

    pool = ShardedHostIngest.__new__(ShardedHostIngest)
    pool.streams = [FakeShardStream(["tcp://a", "tcp://b"]),
                    FakeShardStream(["tcp://c"])]
    pool.connect("tcp://d")
    assert pool.streams[1].addresses == ["tcp://c", "tcp://d"]
    pool.connect("tcp://a")
    assert pool.streams[0].addresses == ["tcp://a", "tcp://b"]
    pool.disconnect("tcp://d")
    assert pool.streams[1].addresses == ["tcp://c"]
    pool.disconnect("tcp://ghost")


@pytest.mark.parametrize("source", ["iterable", "recording"])
def test_pipeline_opaque_source_rejects_membership(source, tmp_path):
    from blendjax_torch.data import StreamDataPipeline
    from blendjax_torch.data.replay import ReplayStream

    src = iter([])
    if source == "recording":
        from blendjax_torch.data.replay import FileRecorder

        path = str(tmp_path / "r.bjr")
        with FileRecorder(path):
            pass
        src = ReplayStream(path)
    pipe = StreamDataPipeline(src, batch_size=2, device="cpu")
    with pytest.raises(RuntimeError, match="runtime membership"):
        pipe.connect("tcp://127.0.0.1:5555")


def test_pipeline_membership_goes_to_the_stream_and_the_pool():
    from blendjax_torch.data import StreamDataPipeline

    pipe = StreamDataPipeline(["tcp://127.0.0.1:5555"], batch_size=2,
                              device="cpu", timeoutms=250)
    pipe.connect("tcp://127.0.0.1:5556")
    pipe.connect("tcp://127.0.0.1:5556")
    assert pipe.stream.addresses == ["tcp://127.0.0.1:5555",
                                     "tcp://127.0.0.1:5556"]
    pipe.disconnect("tcp://127.0.0.1:5555")
    assert pipe._addresses == ["tcp://127.0.0.1:5556"]

    class Pool:
        def __init__(self):
            self.ops = []

        def connect(self, a):
            self.ops.append(("c", a))

        def disconnect(self, a):
            self.ops.append(("d", a))

    pipe.ingest = Pool()
    pipe.connect("tcp://127.0.0.1:7")
    pipe.disconnect("tcp://127.0.0.1:7")
    assert pipe.ingest.ops == [("c", "tcp://127.0.0.1:7"),
                               ("d", "tcp://127.0.0.1:7")]


def test_malformed_membership_op_is_skipped_not_fatal():
    from blendjax_torch.data.stream import RemoteStream

    stream = RemoteStream([], timeoutms=250)
    stream.connect("garbage")
    assert "garbage" in stream.addresses

    class ExplodingRecv:
        def connect(self, addr):
            raise zmq.ZMQError(zmq.EINVAL)

    stream._apply_membership(ExplodingRecv())
    assert "garbage" not in stream.addresses


def test_lineage_retire_makes_btid_reuse_fresh_not_a_restart():
    lin = FrameLineage()

    def stamped(seq):
        return {"btid": 7, "_seq": seq, "_pub_wall": time.time(),
                "_pub_mono": time.monotonic()}

    lin.register(7)
    for s in range(3):
        lin.ingest(stamped(s))
    lin.ingest(stamped(0))
    assert lin.report()["7"]["restarts"] == 1
    assert lin.retire(7) is True and lin.retire(7) is False
    lin.ingest(stamped(0))
    rep = lin.report()["7"]
    assert rep["restarts"] == rep["seq_reorders"] == rep["seq_gaps"] == 0


# -- live: the synthetic producers -----------------------------------------------------


def _stream_for(launcher, *indices, **kw):
    from blendjax_torch.data.stream import RemoteStream

    kw.setdefault("timeoutms", 10_000)
    return RemoteStream(
        [launcher.instance_sockets(i)["DATA"] for i in indices], **kw)


def test_synthetic_producer_is_rate_capped_and_gap_free():
    with PF.synthetic_fleet(1, shape=(16, 16), batch=8, frames=96,
                            rate=120.0, bind_grace_s=0.5) as ln:
        it = iter(_stream_for(ln, 0))
        first = next(it)
        n, t0 = int(first["image"].shape[0]), time.monotonic()
        while n < 96:
            n += int(next(it)["image"].shape[0])
        rate = (n - 8) / (time.monotonic() - t0)
        assert first["image"].shape == (8, 16, 16, 4)
        assert first["xy"].shape == (8, 8, 2)
        assert rate <= 180.0, f"{rate:.0f} frames/s at --rate 120"
    assert lineage.total_gaps() == 0


def test_retire_with_drain_delivers_every_in_flight_frame():
    """Every rendered frame sits in a partial batch that never fills: only
    the SIGTERM drain (finish the frame, ship the partial, flush) can
    deliver them, and a contiguous frameid prefix shows none was lost."""
    with PF.synthetic_fleet(1, shape=(16, 16), batch=4096, rate=200.0,
                            bind_grace_s=0.5) as ln:
        stream = _stream_for(ln, 0, timeoutms=int(TIMEOUT_S * 1000))
        got: list = []

        def consume():
            try:
                got.append(next(iter(stream)))
            except Exception as e:  # a receive timeout fails below
                got.append(e)

        consumer = threading.Thread(target=consume, daemon=True)
        consumer.start()
        time.sleep(1.5)  # ~200-300 frames rendered into the open batch
        ln.retire_instance(0, drain=True)
        consumer.join(timeout=TIMEOUT_S)
        stream.request_stop()
    assert got and isinstance(got[0], dict), got
    ids = list(np.asarray(got[0]["frameid"]).ravel())
    assert len(ids) >= 20 and ids == list(range(1, len(ids) + 1))


def test_scale_up_admits_the_newcomer_mid_run_without_gaps():
    """A sustained producer-bound verdict adds an instance whose address
    joins the running stream; both btids arrive and no gap is counted."""
    with PF.synthetic_fleet(1, shape=(16, 16), batch=4, rate=60.0,
                            bind_grace_s=0.5) as ln:
        stream = _stream_for(ln, 0)
        it = iter(stream)
        next(it)
        ctrl = PF.FleetController(
            ln, connector=stream, respawn_dead=False,
            policy=PF.FleetPolicy(min_instances=1, max_instances=2,
                                  up_after=2, cooldown_s=0.0))
        assert ctrl.tick(verdict="producer-bound")["action"] == "hold"
        d = ctrl.tick(verdict="producer-bound")
        assert d["action"] == "scale_up" and d["instances"] == 2
        seen, deadline = set(), time.monotonic() + TIMEOUT_S
        while seen != {0, 1} and time.monotonic() < deadline:
            seen.add(int(next(it)["btid"]))
        stream.request_stop()
        assert seen == {0, 1}
    rep = lineage.report()
    assert {"0", "1"} <= set(rep)
    assert all(v["seq_gaps"] == 0 for v in rep.values())
    assert [e["action"] for e in ctrl.scale_events()] == ["scale_up"]


def test_remote_producer_announces_streams_and_leaves_cleanly():
    """A producer started alone (its own bound socket) announces itself to
    the admission endpoint, joins a running stream, streams gap-free and
    leaves through the drain grace window."""
    from blendjax_torch.data.stream import RemoteStream

    stream = RemoteStream([], timeoutms=250, on_timeout=lambda: True)
    ctrl = PF.FleetController(
        FakeLauncher(0), connector=stream, respawn_dead=False,
        policy=PF.FleetPolicy(min_instances=1, max_instances=1,
                              drain_grace_s=0.5))
    with PF.AdmissionServer(on_announce=ctrl.admit_remote,
                            on_leave=ctrl.retire_remote) as srv:
        proc = subprocess.Popen([
            sys.executable, "-m", "blendjax_torch.fleet.synthetic",
            "--bind", "tcp://127.0.0.1:0", "--btid", "render-box-7",
            "--announce", srv.addr, "--shape", "16", "16", "--batch", "8",
            "--frames", "64"])
        try:
            it = iter(stream)
            n, deadline = 0, time.monotonic() + 30
            while n < 64 and time.monotonic() < deadline:
                n += int(next(it)["image"].shape[0])
            assert n == 64
            deadline = time.monotonic() + TIMEOUT_S
            while ctrl.remote and time.monotonic() < deadline:
                time.sleep(0.05)
            assert ctrl.remote == {}
            assert [e["action"] for e in ctrl.events][:2] == ["admit",
                                                              "leave"]
            time.sleep(0.6)
            ctrl.tick(verdict="balanced")
            assert ctrl.events[-1]["action"] == "disconnect"
            assert "render-box-7" not in lineage.report()
            assert metrics.report()["counters"].get("wire.seq_gaps", 0) == 0
            assert proc.wait(timeout=TIMEOUT_S) == 0
        finally:
            stream.request_stop()
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=5)


def test_mid_run_scale_up_newcomer_holds_the_current_version():
    """A scaled-up newcomer holds the current scenario version before its
    first frame is counted: every frame it sends carries it."""
    from blendjax_torch.scenario import (
        ScenarioAccounting,
        ScenarioService,
        ScenarioSpace,
    )

    sp = ScenarioSpace.parse("a:half_extent=u(0.8,1.2) / b:xy_jitter=4")
    sp.bump()
    svc = ScenarioService(sp, ledger=ScenarioAccounting())
    try:
        with PF.synthetic_fleet(1, shape=(16, 16), batch=4, rate=40,
                                scenario=True, bind_grace_s=0.5) as ln:
            svc.attach(0, ln.addresses["CTRL"][0])
            assert svc.wait_acked(timeout=TIMEOUT_S), svc.state()
            stream = _stream_for(ln, 0, copy_arrays=True)
            it = iter(stream)
            assert next(it)["_scenario"]["ver"] == 2
            ctrl = PF.FleetController(
                ln, connector=stream, scenario_service=svc,
                respawn_dead=False,
                policy=PF.FleetPolicy(min_instances=1, max_instances=2,
                                      up_after=1, cooldown_s=0.0))
            assert ctrl.tick(verdict="producer-bound")["action"] == "scale_up"
            assert svc.wait_acked(version=2, timeout=TIMEOUT_S), svc.state()
            deadline, newcomer = time.monotonic() + TIMEOUT_S, False
            while not newcomer and time.monotonic() < deadline:
                msg = next(it)
                assert msg["_scenario"]["ver"] == 2
                newcomer = msg.get("btid") == 1
            stream.request_stop()
            assert newcomer
    finally:
        svc.stop()
