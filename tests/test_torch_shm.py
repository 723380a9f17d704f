"""The port's shared-memory ring (``blendjax_torch.transport.shm``): either
package reads the other's segments, and the cases of the JAX package's
``tests/test_shm.py`` hold for the port (torn generations, oversize
refused before the generation moves, reclaim after the timeout,
descriptor resolution and its counts, publisher end to end, a producer
killed mid-write, registry reaping exactly once, resource-tracker
silence)."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from blendjax.transport import shm as jshm
from blendjax_torch.transport import (
    DataPublisherSocket,
    WireCounts,
    shm,
)

WILD = "tcp://127.0.0.1:*"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _detach():
    yield
    shm.detach_all()
    jshm.detach_all()


def _fields(i, seed=0):
    rng = np.random.default_rng(seed + i)
    return {
        "image": rng.integers(0, 256, (4, 6, 4), dtype=np.uint8),
        "xy": rng.normal(size=(8, 2)).astype(np.float32),
        "idx": np.arange(i, i + 5, dtype=np.int64),
    }


def _assert_fields(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# -- across packages -----------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_reads_the_others_ring(writer):
    make = jshm.ShmRing if writer == "jax" else shm.ShmRing
    attach = shm.ShmRing.attach if writer == "jax" else jshm.ShmRing.attach
    with make(slots=3, slot_bytes=4096) as ring:
        reader = attach(ring.name)
        try:
            assert (reader.slots, reader.slot_bytes) == (3, ring.slot_bytes)
            for i in range(7):  # more than a lap: the acks free the slots
                desc = ring.write(_fields(i))
                _assert_fields(reader.read(desc), _fields(i))
            assert ring.reclaims == 0
        finally:
            reader.close()


def test_the_rings_have_the_same_layout():
    with jshm.ShmRing(slots=2, slot_bytes=1000) as a, \
            shm.ShmRing(slots=2, slot_bytes=1000) as b:
        assert a._shm.size == b._shm.size
        assert a.slot_bytes == b.slot_bytes
        assert bytes(a._shm.buf[:24]) == bytes(b._shm.buf[:24])
        da, db = a.write(_fields(1)), b.write(_fields(1))
        assert {k: v for k, v in da.items() if k != "n"} == {
            k: v for k, v in db.items() if k != "n"}
    assert shm.REGISTRY_ENV == jshm.REGISTRY_ENV


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_shm_publishers_reach_the_other_packages_stream(publisher):
    from blendjax.data import RemoteStream as JStream
    from blendjax.transport import DataPublisherSocket as JPub
    from blendjax_torch.data import RemoteStream

    pub = (JPub if publisher == "jax" else DataPublisherSocket)(
        WILD, btid=0, shm=4)
    n = 10
    t = threading.Thread(
        target=lambda: [pub.publish(frameid=i, **_fields(i))
                        for i in range(n)], daemon=True)
    t.start()
    stream = (RemoteStream if publisher == "jax" else JStream)(
        [pub.addr], max_items=n, timeoutms=10_000)
    got = list(stream)
    t.join(timeout=10)
    try:
        assert [m["frameid"] for m in got] == list(range(n))
        for i, m in enumerate(got):
            _assert_fields({k: m[k] for k in _fields(i)}, _fields(i))
        if publisher == "jax":
            assert stream.counts.shm_reads == n
            assert stream.counts.shm_torn == 0 and stream.seq_gaps == 0
    finally:
        pub.close()


# -- the ring protocol -----------------------------------------------------------


def test_ring_roundtrip_and_generation_protocol():
    with shm.ShmRing(slots=3, slot_bytes=4096) as ring:
        descs = [ring.write(_fields(i)) for i in range(3)]
        for i, desc in enumerate(descs):
            assert desc["n"] == ring.name and desc["s"] == i
            assert desc["g"] % 2 == 0
            _assert_fields(ring.read(desc), _fields(i))
        for i in range(3):
            _assert_fields(ring.read(ring.write(_fields(10 + i))),
                           _fields(10 + i))
        assert ring.reclaims == 0


def test_oversize_payload_rejected_before_touching_generation():
    with shm.ShmRing(slots=2, slot_bytes=64) as ring:
        with pytest.raises(shm.ShmCapacityError):
            ring.write({"image": np.zeros((64, 64, 4), np.uint8)})
        assert int(ring._gen[0]) == 0 and int(ring._gen[1]) == 0
        out = ring.read(ring.write({"a": np.arange(4, dtype=np.int32)}))
        np.testing.assert_array_equal(out["a"], np.arange(4, dtype=np.int32))


def test_torn_generation_detected_on_read():
    with shm.ShmRing(slots=2, slot_bytes=4096) as ring:
        desc = ring.write(_fields(1))
        ring.begin_write(desc["s"])
        assert ring.read(desc) is None
        ring.end_write(desc["s"])
        assert ring.read(desc) is None  # the generation moved past it
        assert ring.read({"n": ring.name, "s": 99, "g": 2, "f": []}) is None


def test_unacked_slot_reclaimed_after_timeout():
    with shm.ShmRing(slots=1, slot_bytes=4096) as ring:
        stale = ring.write(_fields(0))  # never read, never acked
        fresh = ring.write(_fields(1), timeout_s=0.05)
        assert ring.reclaims == 1
        assert ring.read(stale) is None
        _assert_fields(ring.read(fresh), _fields(1))


# -- descriptor resolution -------------------------------------------------------


def test_resolve_message_merges_fields_and_counts():
    counts = WireCounts()
    with shm.ShmRing(slots=2, slot_bytes=4096) as ring:
        desc = ring.write(_fields(7))
        msg = {"frameid": 7, "_seq": 0, "_shm": desc}
        out = shm.resolve_message(msg, counts)
        assert out is msg and "_shm" not in out
        _assert_fields({k: out[k] for k in _fields(7)}, _fields(7))
        assert counts.shm_reads == 1 and counts.shm_torn == 0
        assert counts.shm_bytes == sum(v.nbytes for v in _fields(7).values())


def test_resolve_message_marks_torn_and_keeps_stamps():
    counts = WireCounts()
    with shm.ShmRing(slots=2, slot_bytes=4096) as ring:
        desc = ring.write(_fields(3))
        ring.begin_write(desc["s"])
        out = shm.resolve_message({"frameid": 3, "_seq": 5, "_shm": desc},
                                  counts)
        assert out.get("_shm_torn") is True and "image" not in out
        assert out["_seq"] == 5
        assert (counts.shm_torn, counts.shm_reads) == (1, 0)


def test_resolve_message_vanished_segment_is_torn():
    counts = WireCounts()
    desc = {"n": "bjx-torch-gone-xyz", "s": 0, "g": 2, "f": []}
    out = shm.resolve_message({"_seq": 0, "_shm": dict(desc)}, counts)
    assert out.get("_shm_torn") is True
    shm.resolve_message({"_seq": 1, "_shm": dict(desc)}, counts)  # cached miss
    assert counts.shm_torn == 2


# -- publisher and stream end to end ---------------------------------------------


def test_publisher_shm_end_to_end():
    from blendjax_torch.data import RemoteStream

    pub = DataPublisherSocket(WILD, btid=0, shm=4)
    n = 12
    t = threading.Thread(
        target=lambda: [pub.publish(frameid=i, **_fields(i))
                        for i in range(n)], daemon=True)
    t.start()
    stream = RemoteStream([pub.addr], max_items=n, timeoutms=10_000)
    got = list(stream)
    t.join(timeout=10)
    try:
        assert [m["frameid"] for m in got] == list(range(n))
        for i, m in enumerate(got):
            _assert_fields({k: m[k] for k in _fields(i)}, _fields(i))
        assert stream.counts.shm_reads == stream.messages == n
        assert stream.counts.shm_torn == 0 and stream.seq_gaps == 0
        assert stream.counts.raw_bytes == 0  # nothing rode the wire codecs
        assert pub.shm_fallbacks == 0 and pub.shm_reclaims == 0
    finally:
        pub.close()


def test_publisher_oversize_goes_on_the_wire_and_is_counted():
    from blendjax_torch.data import RemoteStream

    ring = shm.ShmRing(slots=2, slot_bytes=64)
    pub = DataPublisherSocket(WILD, btid=0, shm=ring)
    big = np.arange(64 * 64 * 4, dtype=np.uint8).reshape(64, 64, 4)
    t = threading.Thread(target=lambda: pub.publish(frameid=0, image=big),
                         daemon=True)
    t.start()
    stream = RemoteStream([pub.addr], max_items=1, timeoutms=10_000)
    got = list(stream)
    t.join(timeout=10)
    try:
        np.testing.assert_array_equal(got[0]["image"], big)
        assert pub.shm_fallbacks == 1
        assert stream.counts.shm_reads == 0
        assert stream.counts.raw_bytes == big.nbytes
    finally:
        pub.close()
        ring.close()
        ring.unlink()


_KILLED_PRODUCER = """\
import json, os, signal, sys
import numpy as np
from blendjax_torch.transport import DataPublisherSocket
from blendjax_torch.transport.shm import ShmRing

ring = ShmRing(slots=4, slot_bytes=1 << 16)
pub = DataPublisherSocket("tcp://127.0.0.1:*", btid=0, shm=ring)
print(json.dumps({"addr": pub.addr, "ring": ring.name}), flush=True)
for i in range(4):
    pub.publish(frameid=i, image=np.full((4, 6, 4), i, np.uint8))
sys.stdin.readline()          # the consumer has connected
ring.begin_write(2)           # die mid-copy of a slot-2 rewrite
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_killed_producer_mid_write_skips_torn_with_exact_accounting():
    from blendjax_torch.data import RemoteStream

    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop(shm.REGISTRY_ENV, None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILLED_PRODUCER],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=REPO, env=env,
    )
    ring_name = None
    try:
        info = json.loads(proc.stdout.readline())
        ring_name = info["ring"]
        stream = RemoteStream([info["addr"]], max_items=3, timeoutms=20_000)
        it = iter(stream)
        first = next(it)  # connected: zmq's io thread takes the rest
        deadline = time.monotonic() + 20
        while stream.messages < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.5)  # messages 1..3 land in the receive queue
        proc.stdin.write(b"go\n")
        proc.stdin.flush()
        proc.wait(timeout=20)
        assert proc.returncode == -signal.SIGKILL
        got = [first] + list(it)
        assert [m["frameid"] for m in got] == [0, 1, 3]
        assert stream.counts.shm_torn == 1
        assert stream.counts.shm_reads == 3
        assert stream.seq_gaps == 0 and stream.messages == 4
    finally:
        if proc.poll() is None:
            proc.kill()
        if ring_name:
            shm.unlink_segment(ring_name)


# -- lifecycle -------------------------------------------------------------------


def test_registry_reap_unlinks_exactly_once(tmp_path, monkeypatch):
    reg = str(tmp_path / "shm-reg")
    monkeypatch.setenv(shm.REGISTRY_ENV, reg)
    r1 = shm.ShmRing(slots=1, slot_bytes=64, btid=1)
    r2 = shm.ShmRing(slots=1, slot_bytes=64, btid=1)
    r3 = shm.ShmRing(slots=1, slot_bytes=64, btid=2)
    names = [r.name for r in (r1, r2, r3)]
    assert sorted(os.listdir(reg)) == sorted(
        [f"1__{names[0]}", f"1__{names[1]}", f"2__{names[2]}"])
    assert shm.reap_registry(reg, btid=1) == 2
    assert shm.attach_ring(names[0]) is None
    assert shm.attach_ring(names[1]) is None
    assert shm.ShmRing.attach(names[2]).name == names[2]
    assert shm.reap_registry(reg, btid=1) == 0
    # the JAX launcher's reaper takes the port's segments (same registry)
    assert jshm.reap_registry(reg) == 1
    assert shm.reap_registry(reg) == 0
    assert os.listdir(reg) == []
    for r in (r1, r2, r3):
        r.close()
        r.unlink()  # idempotent: already reaped


def test_publisher_owned_ring_unlinks_on_close_without_registry(monkeypatch):
    from blendjax_torch.data import RemoteStream

    monkeypatch.delenv(shm.REGISTRY_ENV, raising=False)
    pub = DataPublisherSocket(WILD, btid=0, shm=2)
    t = threading.Thread(target=lambda: pub.publish(frameid=0, **_fields(0)),
                         daemon=True)
    t.start()
    got = list(RemoteStream([pub.addr], max_items=1, timeoutms=10_000))
    t.join(timeout=10)
    name = pub._shm_ring.name
    shm.detach_all()
    pub.close()
    assert got[0]["frameid"] == 0
    with pytest.raises(FileNotFoundError):
        shm.ShmRing.attach(name)


def test_publisher_owned_ring_is_left_to_the_registry(tmp_path, monkeypatch):
    reg = str(tmp_path / "reg")
    monkeypatch.setenv(shm.REGISTRY_ENV, reg)
    pub = DataPublisherSocket(WILD, btid=5, shm=2)
    pub._encode_shm(pub._stamp({"btid": 5, **_fields(0)}))
    name = pub._shm_ring.name
    pub.close()
    assert os.listdir(reg) == [f"5__{name}"]
    assert shm.reap_registry(reg) == 1
    assert shm.reap_registry(reg) == 0


def test_no_resource_tracker_leak_warnings():
    code = (
        "from blendjax_torch.transport.shm import ShmRing, unlink_segment\n"
        "import numpy as np\n"
        "r = ShmRing(slots=2, slot_bytes=4096)\n"
        "d = r.write({'a': np.arange(8, dtype=np.float32)})\n"
        "c = ShmRing.attach(r.name)\n"
        "assert c.read(d) is not None\n"
        "c.close()\n"
        "r.close()\n"
        "r.unlink()\n"
        "r2 = ShmRing(slots=1, slot_bytes=64)\n"
        "r2.close()\n"
        "assert unlink_segment(r2.name)\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop(shm.REGISTRY_ENV, None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "resource_tracker" not in res.stderr
    assert "leaked" not in res.stderr
