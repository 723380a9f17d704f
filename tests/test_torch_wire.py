"""The port's wire (``blendjax_torch.transport.wire``) against the JAX
package's: frames byte-identical for the same message sequence under a
per-publisher compression state, pickle frames across packages (refused
without ``allow_pickle``), ``sizeof_frames``, the inflate pool and the
decoded/wire byte counts."""

import concurrent.futures

import msgpack
import numpy as np
import pytest

from blendjax.transport import wire as jwire
from blendjax.utils.metrics import metrics as jmetrics
from blendjax_torch.transport import wire


def _messages(seed=0, n=12):
    """A message sequence mixing run-heavy planes (ndr), zlib-friendly
    arrays (ndz), incompressible noise (the skip memo) and planes whose
    runs grow over the sequence (the sticky cap ratchets)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        runs = 8 + 12 * i  # more runs per row as the stream goes on
        plane = np.repeat(
            rng.integers(0, 8, (16, runs), dtype=np.uint8),
            -(-2048 // runs), axis=1)[:, :2048]
        out.append({
            "plane": np.ascontiguousarray(plane),
            "zeros": np.zeros((64, 64), np.int32) + (i % 3),
            "noise": rng.integers(0, 256, (32, 1024), dtype=np.uint8),
            "xy": rng.normal(size=(8, 8, 2)).astype(np.float32),
            "frameid": np.int64(i),
            "meta": {"i": i, "tag": "x" * (i % 4)},
            "_prebatched": True,
        })
    return out


CONFIGS = {
    "ndz": dict(compress_level=6, compress_min_bytes=1024),
    "ndr": dict(compress_rle=True, compress_min_bytes=1024),
    "ndr-pinned": dict(compress_rle=True, compress_min_bytes=1024,
                       rle_cap=256),
    "ndr+ndz": dict(compress_rle=True, compress_level=1,
                    compress_min_bytes=1024),
    "f16": dict(compress_level=1, compress_min_bytes=64,
                quantize_f16=("xy",)),
}


def _frames_bytes(frames):
    return [bytes(f) for f in frames]


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("stateful", [True, False],
                         ids=["state", "stateless"])
def test_frames_are_byte_identical_over_a_sequence(config, stateful):
    kw = CONFIGS[config]
    jstate = jwire.WireCompressState() if stateful else None
    state = wire.WireCompressState() if stateful else None
    kinds = set()
    for msg in _messages():
        want = jwire.encode_message(msg, state=jstate, **kw)
        got = wire.encode_message(msg, state=state, **kw)
        assert _frames_bytes(got) == _frames_bytes(want)
        assert wire.sizeof_frames(got) == jwire.sizeof_frames(want)
        kinds |= {e[0] for e in msgpack.unpackb(bytes(got[0])[4:],
                                                raw=False)[1]}
    if stateful:
        assert state._caps == jstate._caps
        assert state._skip == jstate._skip
        assert state.compress_skips > 0  # the noise plane lost and skipped
    assert "nd" in kinds and "obj" in kinds


def test_the_sticky_cap_ratchets_as_in_the_jax_package():
    kw = CONFIGS["ndr"]
    jstate, state = jwire.WireCompressState(), wire.WireCompressState()
    caps = []
    for msg in _messages(seed=3):
        frames = wire.encode_message(msg, state=state, **kw)
        jwire.encode_message(msg, state=jstate, **kw)
        entries = msgpack.unpackb(bytes(frames[0])[4:], raw=False)[1]
        caps += [e[5] for e in entries if e[0] == "ndr" and e[1] == "plane"]
        assert state.rle_cap("plane") == jstate.rle_cap("plane")
    assert caps == sorted(caps) and caps[-1] > caps[0]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("defer", [False, True])
def test_decoded_messages_agree_across_packages(direction, defer):
    kw = CONFIGS["ndr+ndz"]
    for msg in _messages(seed=1, n=4):
        if direction == "jax_to_port":
            frames = jwire.encode_message(msg, **kw)
            got = wire.decode_message(frames, defer_rle=defer)
            want = jwire.decode_message(frames, defer_rle=defer)
        else:
            frames = wire.encode_message(msg, **kw)
            got = jwire.decode_message(frames, defer_rle=defer)
            want = wire.decode_message(frames, defer_rle=defer)
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype
                np.testing.assert_array_equal(got[k], v)
            else:
                assert got[k] == v


def _pickled_message():
    return {"image": np.arange(12, dtype=np.uint8).reshape(3, 4),
            "shape": (480, 640), "obj": {1, 2, 3}, "btid": 7}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_pickle_frames_decode_across_packages(direction):
    msg = _pickled_message()
    if direction == "jax_to_port":
        frames = jwire.encode_message(msg, codec="pickle")
        got = wire.decode_message(frames, allow_pickle=True)
    else:
        frames = wire.encode_message(msg, codec="pickle")
        assert frames == jwire.encode_message(msg, codec="pickle")
        got = jwire.decode_message(frames, allow_pickle=True)
    assert got["shape"] == (480, 640) and got["obj"] == {1, 2, 3}
    np.testing.assert_array_equal(got["image"], msg["image"])
    assert set(wire.CODECS) == set(jwire.CODECS) == {"tensor", "pickle"}


@pytest.mark.parametrize("codec", ["pickle", "tensor"])
def test_pickle_is_refused_without_allow_pickle(codec):
    """A pickled message and a tensor message with an embedded pickle
    entry ("pkl"): the port refuses both unless allow_pickle is set."""
    msg = _pickled_message()
    frames = jwire.encode_message(msg, codec=codec)
    if codec == "tensor":
        kinds = [e[0] for e in msgpack.unpackb(bytes(frames[0])[4:],
                                               raw=False)[1]]
        assert "pkl" in kinds
        assert _frames_bytes(wire.encode_message(msg)) == _frames_bytes(frames)
    with pytest.raises(ValueError, match="allow_pickle"):
        wire.decode_message(frames)
    with pytest.raises(ValueError, match="allow_pickle"):
        jwire.decode_message(frames, allow_pickle=False)
    got = wire.decode_message(frames, allow_pickle=True)
    assert got["obj"] == {1, 2, 3}


@pytest.mark.parametrize("frames", [
    [b"abc", memoryview(np.zeros((4, 5), np.float32)), bytearray(3)],
    [memoryview(b"")],
    [np.zeros(7, np.uint8)],
], ids=["mixed", "empty", "array"])
def test_sizeof_frames_matches(frames):
    assert wire.sizeof_frames(frames) == jwire.sizeof_frames(frames)


def test_inflate_pool_gives_the_same_message():
    msg = {f"z{i}": np.full((128, 128), i, np.int32) for i in range(4)}
    frames = jwire.encode_message(msg, compress_level=6, compress_min_bytes=64)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        got = wire.decode_message(frames, inflate_pool=pool)
        want = jwire.decode_message(frames, inflate_pool=pool)
    for k in msg:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], msg[k])


def test_counts_match_the_jax_wire_counters():
    """The port's WireCounts add the same decoded and wire bytes as the
    JAX package's wire.raw_bytes / wire.compressed_bytes counters."""
    counts = wire.WireCounts()
    jmetrics.reset()
    try:
        for msg in _messages(seed=2, n=5):
            frames = jwire.encode_message(msg, **CONFIGS["ndr+ndz"])
            wire.decode_message(frames, counts=counts, defer_rle=True)
            jwire.decode_message(frames, count_metrics=True, defer_rle=True)
        c = jmetrics.report()["counters"]
        assert counts.raw_bytes == c["wire.raw_bytes"] > 0
        assert counts.compressed_bytes == c["wire.compressed_bytes"]
        assert counts.compressed_bytes < counts.raw_bytes
    finally:
        jmetrics.reset()


def test_copy_arrays_makes_writable_arrays():
    frames = wire.encode_message(
        {"a": np.arange(4096, dtype=np.int32), "b": np.zeros(4096, np.uint8)},
        compress_level=1, compress_min_bytes=64)
    got = wire.decode_message(frames, copy_arrays=True)
    assert got["a"].flags.writeable and got["b"].flags.writeable
    assert not wire.decode_message(frames)["b"].flags.writeable


def test_publisher_codecs_reach_the_receiver():
    """A port publisher with the pickle codec or compression, through a
    port receiver: the same message, and pickle needs allow_pickle."""
    import threading

    from blendjax_torch.transport import DataPublisherSocket, DataReceiverSocket

    msg = {"image": np.tile(np.repeat(np.arange(4, dtype=np.uint8), 64),
                            (64, 1)),
           "frameid": 3}
    for kw, allow in [(dict(codec="pickle"), True),
                      (dict(compress_level=6, compress_min_bytes=1024), False),
                      (dict(compress_rle=True, compress_min_bytes=1024,
                            rle_cap=64), False)]:
        pub = DataPublisherSocket("tcp://127.0.0.1:*", btid=1, **kw)
        recv = DataReceiverSocket([pub.addr], timeoutms=10_000,
                                  allow_pickle=allow)
        t = threading.Thread(target=lambda: pub.publish(**msg))
        t.start()
        got, _ = recv.recv()
        t.join()
        np.testing.assert_array_equal(got["image"], msg["image"])
        assert got["frameid"] == 3 and got["btid"] == 1
        if not allow:
            assert recv.counts.raw_bytes == msg["image"].nbytes
            assert recv.counts.compressed_bytes < recv.counts.raw_bytes
        recv.close()
        pub.close()


def test_pickle_codec_raises_without_allow_pickle_on_the_receiver():
    import threading

    from blendjax_torch.transport import DataPublisherSocket, DataReceiverSocket

    pub = DataPublisherSocket("tcp://127.0.0.1:*", btid=0, codec="pickle")
    recv = DataReceiverSocket([pub.addr], timeoutms=10_000)
    t = threading.Thread(target=lambda: pub.publish(x=1))
    t.start()
    with pytest.raises(ValueError, match="allow_pickle"):
        recv.recv()
    t.join()
    recv.close()
    pub.close()


@pytest.mark.parametrize("pkg", ["port", "jax", "port-from-jax"])
def test_push_pull_stream_and_fan_in(pkg):
    """C7: the JAX package's fan-in case (``tests/test_transport.py``) on
    both packages, and a port receiver under JAX publishers: ``recv``
    returns ``(message, raw frame buffers)``, and the raw buffers decode
    to the same message."""
    import blendjax.transport as J
    import blendjax_torch.transport as P

    pubs = J if pkg == "port-from-jax" else (P if pkg == "port" else J)
    recvs = J if pkg == "jax" else P
    decode = (jwire if pkg == "jax" else wire).decode_message
    wild = "tcp://127.0.0.1:*"
    pub_a = pubs.DataPublisherSocket(wild, btid=0)
    pub_b = pubs.DataPublisherSocket(wild, btid=1)
    recv = recvs.DataReceiverSocket([pub_a.addr, pub_b.addr], timeoutms=5000)
    img = np.random.default_rng(0).integers(0, 255, (8, 8, 4), np.uint8)
    try:
        for i in range(4):
            pub_a.publish(image=img, frameid=i)
            pub_b.publish(image=img, frameid=i)
        seen = set()
        for _ in range(8):
            msg, raw = recv.recv()
            assert msg["image"].shape == (8, 8, 4)
            again = decode([bytes(b) for b in raw])
            np.testing.assert_array_equal(again["image"], msg["image"])
            assert again["frameid"] == msg["frameid"]
            seen.add((msg["btid"], msg["frameid"]))
        assert seen == {(b, i) for b in (0, 1) for i in range(4)}
    finally:
        recv.close()
        pub_a.close()
        pub_b.close()
