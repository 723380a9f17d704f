"""The port's control channels against the JAX package's, on the CPU.

- The frames each channel puts on the wire (``PairChannel.send``,
  ``RpcClient.call``, ``RpcServer.reply``, ``DataPublisherSocket``'s
  ``publish_tracked`` and ``copy=True``) are byte-equal to the JAX
  package's, read off a plain zmq peer; ``os.urandom`` is fixed for the
  comparison, which leaves out nothing else (the random ``btmid``).
- Round trips between the packages in both directions: a port channel
  against a JAX channel, messages with arrays and nested values.
- The port's receivers refuse pickles unless told ``allow_pickle=True``
  (ROADMAP "Chosen differences"): a JAX peer that sends a pickle, whole or
  embedded, fails loudly at the port's receiver.

Every receive in this file has its own timeout.
"""

import os

import numpy as np
import pytest
import zmq

from blendjax.transport import channels as JCh
from blendjax_torch.transport import channels as TCh

TIMEOUT = 10_000


@pytest.fixture
def ctx():
    c = zmq.Context()
    yield c
    c.destroy(linger=0)


@pytest.fixture
def fixed_btmid(monkeypatch):
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(7, 7 + n)))


def _raw(ctx, kind, addr, bind=False):
    sock = ctx.socket(kind)
    sock.setsockopt(zmq.LINGER, 0)
    sock.setsockopt(zmq.RCVTIMEO, TIMEOUT)
    sock.setsockopt(zmq.SNDTIMEO, TIMEOUT)
    if bind:
        sock.bind(addr)
    else:
        sock.connect(addr)
    return sock


def _message():
    rng = np.random.default_rng(0)
    return {
        "obs": rng.normal(size=(4,)).astype(np.float32),
        "img": rng.integers(0, 256, (3, 5, 4), dtype=np.uint8),
        "reward": 1.5, "done": False, "time": 7, "name": "cart",
        "nested": {"a": [1, 2, 3], "b": b"\x00\x01"},
    }


def _pair_frames(mod, ctx):
    ch = mod.PairChannel("tcp://127.0.0.1:*", btid=3, bind=True)
    try:
        peer = _raw(ctx, zmq.PAIR, ch.addr)
        mid = ch.send(**_message())
        frames = peer.recv_multipart()
        peer.close()
    finally:
        ch.close()
    return mid, frames


def _client_frames(mod, ctx):
    rep = _raw(ctx, zmq.REP, "tcp://127.0.0.1:*", bind=True)
    addr = rep.getsockopt_string(zmq.LAST_ENDPOINT)
    client = mod.RpcClient(addr, timeoutms=TIMEOUT)
    try:
        # the REQ send completes before the reply is needed: read the
        # request off the plain REP, answer, then let call() return
        import threading

        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "rep", client.call(cmd="step", action=[0.5, -1.0], seed=7)))
        t.start()
        frames = rep.recv_multipart()
        rep.send_multipart(JCh.encode_message({"ok": 1}))
        t.join(TIMEOUT / 1e3)
        assert not t.is_alive() and out["rep"] == {"ok": 1}
    finally:
        client.close()
        rep.close()
    return frames


def _server_frames(mod, ctx):
    server = mod.RpcServer("tcp://127.0.0.1:*")
    try:
        req = _raw(ctx, zmq.REQ, server.addr)
        req.send_multipart(TCh.encode_message({"cmd": "reset", "seed": 3}))
        got = server.recv(timeoutms=TIMEOUT)
        assert got == {"cmd": "reset", "seed": 3}
        server.reply(**_message())
        frames = req.recv_multipart()
        req.close()
    finally:
        server.close()
    return got, frames


def test_pair_frames_are_the_references(ctx, fixed_btmid):
    port, ref = _pair_frames(TCh, ctx), _pair_frames(JCh, ctx)
    assert port[0] == ref[0] == bytes(range(7, 11))
    assert port[1] == ref[1]


def test_rpc_client_frames_are_the_references(ctx):
    assert _client_frames(TCh, ctx) == _client_frames(JCh, ctx)


def test_rpc_server_frames_are_the_references(ctx):
    assert _server_frames(TCh, ctx) == _server_frames(JCh, ctx)


@pytest.mark.parametrize("tracked", [True, False], ids=["tracked", "copy"])
def test_publisher_frames_are_the_references(ctx, tracked):
    """``publish_tracked`` (its tracker done once the IO thread let go of
    the arrays) and ``copy=True`` put the JAX package's frames on the
    wire (the lineage stamps, which carry clocks, off on both)."""
    msg = _message()
    frames = []
    for mod in (TCh, JCh):
        pub = mod.DataPublisherSocket("tcp://127.0.0.1:*", btid=1,
                                      lineage=False, copy=not tracked)
        try:
            pull = _raw(ctx, zmq.PULL, pub.addr)
            if tracked:
                tracker = pub.publish_tracked(**msg)
                frames.append(pull.recv_multipart())
                tracker.wait(TIMEOUT / 1e3)
                assert tracker.done
            else:
                pub.publish(**msg)
                frames.append(pull.recv_multipart())
            pull.close()
        finally:
            pub.close()
    assert frames[0] == frames[1]


def test_publish_tracked_through_a_ring_is_done_at_once(tmp_path, monkeypatch):
    from blendjax_torch.transport import REGISTRY_ENV

    monkeypatch.setenv(REGISTRY_ENV, str(tmp_path))
    pub = TCh.DataPublisherSocket("tcp://127.0.0.1:*", btid=0, shm=2)
    recv = TCh.DataReceiverSocket(pub.addr, timeoutms=TIMEOUT)
    try:
        img = np.arange(4096, dtype=np.uint8).reshape(64, 64)
        tracker = pub.publish_tracked(image=img)
        assert tracker.done and tracker.wait() is None
        got, _ = recv.recv()
        np.testing.assert_array_equal(got["image"], img)
        assert recv.counts.shm_reads == 1
    finally:
        recv.close()
        pub.close()
        from blendjax_torch.transport import reap_registry

        reap_registry(str(tmp_path))


@pytest.mark.parametrize("direction", ["port_binds", "jax_binds"])
def test_pair_round_trip_between_packages(direction):
    binder, connector = (TCh, JCh) if direction == "port_binds" else (JCh,
                                                                      TCh)
    a = binder.PairChannel("tcp://127.0.0.1:*", btid=0, bind=True)
    b = connector.PairChannel(a.addr, btid=9)
    try:
        msg = _message()
        for src, dst, btid in ((b, a, 9), (a, b, 0)):
            mid = src.send(**msg)
            got = dst.recv(timeoutms=TIMEOUT)
            assert got["btid"] == btid and got["btmid"] == mid
            for k, v in msg.items():
                if isinstance(v, np.ndarray):
                    assert got[k].dtype == v.dtype
                    np.testing.assert_array_equal(got[k], v)
                else:
                    assert got[k] == v, k
        assert a.recv(timeoutms=50) is None  # a timeout is None
    finally:
        b.close()
        a.close()


@pytest.mark.parametrize("direction", ["port_server", "jax_server"])
def test_rpc_round_trip_between_packages(direction):
    server_mod, client_mod = (TCh, JCh) if direction == "port_server" else (
        JCh, TCh)
    server = server_mod.RpcServer("tcp://127.0.0.1:*")
    client = client_mod.RpcClient(server.addr, timeoutms=TIMEOUT)
    try:
        import threading

        replies = []
        t = threading.Thread(target=lambda: replies.extend(
            client.call(cmd="step", action=float(i)) for i in range(3)))
        t.start()
        for i in range(3):
            req = server.recv(timeoutms=TIMEOUT)
            assert req == {"cmd": "step", "action": float(i)}
            server.reply(obs=np.full(4, i, np.float32), reward=1.0,
                         done=i == 2, time=i)
        t.join(TIMEOUT / 1e3)
        assert not t.is_alive()
        assert [r["time"] for r in replies] == [0, 1, 2]
        assert [r["done"] for r in replies] == [False, False, True]
        np.testing.assert_array_equal(replies[2]["obs"], np.full(4, 2.0))
        assert server.recv(timeoutms=0) is None  # a poll
    finally:
        client.close()
        server.close()


def test_an_rpc_without_a_server_times_out():
    client = TCh.RpcClient("tcp://127.0.0.1:9", timeoutms=100)
    try:
        with pytest.raises(TCh.ReceiveTimeoutError, match="timed out"):
            client.call(cmd="reset")
    finally:
        client.close()


def test_pickles_from_a_jax_peer_are_refused_without_allow_pickle():
    """A JAX-package peer's pickles (an embedded one for a value msgpack
    does not carry, and a whole pickled message) fail loudly at the
    port's receivers; ``allow_pickle=True`` admits them."""
    for allow in (False, True):
        a = TCh.PairChannel("tcp://127.0.0.1:*", bind=True,
                            allow_pickle=allow)
        b = JCh.PairChannel(a.addr, btid=2)
        try:
            b.send(tags={"a", "b"})
            if allow:
                assert a.recv(timeoutms=TIMEOUT)["tags"] == {"a", "b"}
            else:
                with pytest.raises(ValueError, match="allow_pickle"):
                    a.recv(timeoutms=TIMEOUT)
        finally:
            b.close()
            a.close()
    server = TCh.RpcServer("tcp://127.0.0.1:*")
    client = JCh.RpcClient(server.addr, timeoutms=TIMEOUT, codec="pickle")
    try:
        # the request half of client.call(), a pickled message
        client.sock.send_multipart(JCh.encode_message({"cmd": "reset"},
                                                      codec="pickle"))
        with pytest.raises(ValueError, match="allow_pickle"):
            server.recv(timeoutms=TIMEOUT)
    finally:
        client.close()
        server.close()


def test_a_pickled_reply_is_refused_by_the_port_client():
    server = JCh.RpcServer("tcp://127.0.0.1:*", codec="pickle")
    client = TCh.RpcClient(server.addr, timeoutms=TIMEOUT)
    try:
        import threading

        errors = []

        def call():
            try:
                client.call(cmd="reset")
            except ValueError as e:
                errors.append(e)

        t = threading.Thread(target=call)
        t.start()
        assert server.recv(timeoutms=TIMEOUT) == {"cmd": "reset"}
        server.reply(obs=[1.0])
        t.join(TIMEOUT / 1e3)
        assert not t.is_alive()
        assert errors and "allow_pickle" in str(errors[0])
    finally:
        client.close()
        server.close()


def test_the_port_channels_default_to_refusing_pickles():
    """The chosen difference: the JAX package's three classes default to
    ``allow_pickle=True``, the port's to False."""
    import inspect

    for name in ("PairChannel", "RpcClient", "RpcServer"):
        port = inspect.signature(getattr(TCh, name)).parameters
        ref = inspect.signature(getattr(JCh, name)).parameters
        assert port["allow_pickle"].default is False, name
        assert ref["allow_pickle"].default is True, name
        assert [p for p in port if p != "allow_pickle"] == [
            p for p in ref if p != "allow_pickle"], name
