"""The synthetic producer tier and its launch helper (port of
``blendjax/fleet/synthetic.py``).

The port's :class:`~blendjax_torch.producer.sim.CubeScene` renders the cube
scene in host C++ at hundreds of frames per second, which gives the fleet
controller both regimes on demand:

- step-bound (scale down): a couple of unthrottled producers outrun a
  consumer;
- producer-bound (scale up): ``--rate N`` caps each instance at N
  frames/s on an absolute schedule, so each added instance buys a known
  supply increment.

Run it three ways:

1. ``synthetic_fleet(n, ...)``: a configured
   :class:`~blendjax_torch.launcher.PythonProducerLauncher`;
2. under any launcher: ``python blendjax_torch/fleet/synthetic.py --
   <handshake>``;
3. alone on a render machine::

       python -m blendjax_torch.fleet.synthetic --bind tcp://0.0.0.0:0 \\
           --btid render-box-7 --announce tcp://consumer:5555

   which binds its own data socket and registers with the consumer's
   :class:`~blendjax_torch.fleet.admission.AdmissionServer`.

``--scenario-wait S`` makes the producer a scenario consumer: it binds the
``CTRL`` duplex channel (``--ctrl-bind`` alone), waits up to S seconds for
the first space, then samples, applies (``scene.apply_scenario``) and
stamps one scenario per batch; the channel refuses pickles. SIGTERM drains:
the current frame finishes, the partial batch ships, and
``term_context()`` flushes the socket, so a scale-down loses no frame.

Run as a file (a launcher's way), the script's directory comes off
``sys.path`` first, as in ``producer/cube.py``, so no module beside it can
shadow the standard library.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    # Run as a file, this directory is sys.path[0]: drop it, so no module
    # here can shadow one of the standard library's
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != _here]

import argparse  # noqa: E402
import signal  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

SYNTHETIC_PRODUCER = os.path.abspath(__file__)

# Default geometry: small enough that one instance saturates a consumer on
# a CPU, big enough that the batch still exercises the real codec.
DEFAULT_SHAPE = (64, 64)
DEFAULT_BATCH = 8


def announce_addr(bound_addr: str) -> str:
    """The address a producer should ANNOUNCE for a socket bound at
    ``bound_addr``. zmq's LAST_ENDPOINT resolves wildcard PORTS but
    keeps a wildcard HOST — announcing ``tcp://0.0.0.0:PORT`` would
    have the remote consumer connect to ITSELF. Substitute the primary
    IP, like the launcher's ``bind_addr='primaryip'`` mode."""
    from blendjax_torch.utils.ipaddr import get_primary_ip

    proto, _, rest = bound_addr.partition("://")
    host, _, port = rest.rpartition(":")
    if host in ("0.0.0.0", "*", "::", "[::]"):
        return f"{proto}://{get_primary_ip()}:{port}"
    return bound_addr


def synthetic_fleet(num_instances: int = 1, shape=DEFAULT_SHAPE,
                    batch: int = DEFAULT_BATCH, rate: float = 0.0,
                    frames: int = -1, trace_every: int = 0,
                    scenario: bool = False,
                    scenario_wait_s: float = 15.0,
                    extra_args=None, **launcher_kwargs):
    """A ready-to-enter
    :class:`~blendjax_torch.launcher.PythonProducerLauncher` over
    ``num_instances`` synthetic producers.
    ``rate`` caps each instance's frames/s (0 = as fast as the
    rasterizer goes); remaining kwargs pass through to the launcher
    (``seed``, ``proto``, ``bind_addr``, ...).

    ``scenario=True`` allocates a ``CTRL`` duplex socket per instance
    and makes each producer a scenario consumer: it binds the duplex
    channel, WAITS up to ``scenario_wait_s`` for the first
    :class:`~blendjax_torch.scenario.ScenarioSpace` from the consumer's
    :class:`~blendjax_torch.scenario.ScenarioService` (so its
    first published frame already carries the current space version),
    then re-samples + applies a scenario per batch and stamps
    ``_scenario`` into every message."""
    from blendjax_torch.launcher import PythonProducerLauncher

    args = [
        "--shape", str(shape[0]), str(shape[1]),
        "--batch", str(batch),
        "--frames", str(frames),
        "--rate", str(rate),
        "--trace-every", str(trace_every),
        *(["--scenario-wait", str(scenario_wait_s)] if scenario else []),
        *[str(a) for a in (extra_args or [])],
    ]
    launcher_kwargs.setdefault(
        "named_sockets", ["DATA", "CTRL"] if scenario else ["DATA"]
    )
    return PythonProducerLauncher(
        script=SYNTHETIC_PRODUCER,
        num_instances=num_instances,
        instance_args=[list(args) for _ in range(num_instances)],
        **launcher_kwargs,
    )


def _parse(argv):
    from blendjax_torch.launcher import parse_launch_args

    try:
        args, remainder = parse_launch_args(argv)
    except ValueError:
        # Standalone mode: no launcher handshake in argv — everything
        # after the program name is ours.
        args, remainder = None, list(argv[1:])
    parser = argparse.ArgumentParser(
        description="blendjax_torch synthetic high-rate producer"
    )
    parser.add_argument("--shape", nargs=2, type=int,
                        default=list(DEFAULT_SHAPE))
    parser.add_argument("--batch", type=int, default=DEFAULT_BATCH)
    parser.add_argument("--frames", type=int, default=-1)
    parser.add_argument(
        "--rate", type=float, default=0.0,
        help="cap frames/s per instance (0 = unthrottled) — the knob "
        "that makes producer-bound regimes reproducible",
    )
    parser.add_argument("--trace-every", type=int, default=0)
    parser.add_argument(
        "--wire", choices=("raw", "ndz", "ndr", "shm"), default="raw",
        help="wire compression: raw frames (default), zlib 'ndz' "
        "(host inflate on the consumer), or run-length 'ndr'. Both "
        "compressed modes publish _prebatched (opaque pass-through) so "
        "the consumer's batch shapes never enter schema assembly. 'shm' "
        "ships arrays through a shared-memory ring for a consumer on "
        "this host (blendjax_torch.transport.shm): only a descriptor "
        "rides the socket.",
    )
    parser.add_argument(
        "--rle-cap", type=int, default=0, metavar="N",
        help="pin the ndr per-row pair capacity (one packed shape for "
        "the fleet, like TileBatchPublisher's capacity); 0 = sticky "
        "per-key capacity",
    )
    parser.add_argument(
        "--quantize-xy", action="store_true",
        help="ship the xy point labels as float16 on the wire "
        "(integer pixel coordinates are exact; the consumer's f32 "
        "input cast dequantizes them)",
    )
    parser.add_argument(
        "--scenario-wait", type=float, default=None, metavar="S",
        help="consume a scenario space over the CTRL duplex socket "
        "(blendjax_torch.scenario): wait up to S seconds for the first "
        "published space before the first frame, then re-sample a "
        "scenario per batch and stamp _scenario into every message",
    )
    parser.add_argument(
        "--bind", default=None, metavar="ADDR",
        help="standalone mode: bind the data socket here (wildcard "
        "port ok) instead of taking it from the launcher handshake",
    )
    parser.add_argument(
        "--ctrl-bind", default=None, metavar="ADDR",
        help="standalone mode: bind the scenario duplex channel here "
        "(wildcard port ok); with --announce, the resolved address is "
        "announced as telemetry ctrl_addr so the consumer's fleet "
        "controller attaches its ScenarioService",
    )
    parser.add_argument(
        "--btid", default=None,
        help="standalone mode: producer id announced to the consumer",
    )
    parser.add_argument(
        "--announce", default=None, metavar="ADDR",
        help="register with a consumer's fleet admission endpoint "
        "(blendjax_torch.fleet.AdmissionServer) after binding",
    )
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args(remainder)
    return args, opts


def main(argv=None) -> int:
    from blendjax_torch.producer import AnimationController, DataPublisher
    from blendjax_torch.producer.sim import CubeScene, SimEngine
    from blendjax_torch.transport import term_context

    args, opts = _parse(sys.argv if argv is None else argv)
    launcher_mode = args is not None and "DATA" in (args.btsockets or {})
    if not launcher_mode and not opts.bind:
        raise SystemExit(
            "synthetic producer needs a launcher handshake (-btsockets "
            "DATA=...) or --bind ADDR for standalone mode"
        )
    btid = args.btid if launcher_mode else (opts.btid or os.getpid())
    seed = args.btseed if launcher_mode else opts.seed
    bind_addr = args.btsockets["DATA"] if launcher_mode else opts.bind

    h, w = opts.shape
    b = opts.batch
    scene = CubeScene(shape=(h, w), seed=seed)
    ctrl = AnimationController(SimEngine(scene))
    pub = DataPublisher(
        bind_addr, btid=btid, lingerms=10_000, send_hwm=2,
        trace_every=opts.trace_every,
        compress_level=6 if opts.wire == "ndz" else 0,
        compress_rle=opts.wire == "ndr",
        rle_cap=opts.rle_cap or None,
        **({"compress_min_bytes": 1024}
           if opts.wire in ("ndz", "ndr") else {}),
        quantize_f16=("xy",) if opts.quantize_xy else (),
        # shm: the publisher writes pool slots into a shared-memory
        # ring and ships descriptors; its trackers are done at once.
        # Under a fleet launcher the segment is registered for
        # retire_instance to unlink.
        shm=4 if opts.wire == "shm" else None,
    )
    # Compressed-wire modes publish opaque prebatched messages (the
    # tile-stream pass-through): deferred "ndr" buffers have content-
    # dependent packed shapes that must never enter schema assembly.
    # shm messages decode to plain arrays on the consumer — same shape
    # contract as raw, so they keep the _batched fast path.
    batch_stamp = (
        {"_prebatched": True} if opts.wire in ("ndz", "ndr")
        else {"_batched": True}
    )

    # Scenario consumer: the duplex channel binds
    # next to the data socket — launcher mode takes the CTRL handshake
    # address, standalone mode --ctrl-bind — and the applicator samples
    # + applies + stamps one scenario per batch.
    applicator = None
    ctrl_addr = (
        (args.btsockets or {}).get("CTRL") if launcher_mode
        else opts.ctrl_bind
    )
    if ctrl_addr:
        from blendjax_torch.producer import DuplexChannel
        from blendjax_torch.producer.scenario import ScenarioApplicator

        # allow_pickle=False: this endpoint's address may be announced
        # off-host (admission telemetry) — a pickled payload must never
        # execute here, same contract as the admission endpoint
        chan = DuplexChannel(ctrl_addr, btid=btid, allow_pickle=False)
        applicator = ScenarioApplicator(
            chan, apply=scene.apply_scenario, rng=seed
        )

    announced = False
    if opts.announce:
        from blendjax_torch.fleet.admission import announce

        data_addr = announce_addr(pub.addr)
        telemetry = (
            {"ctrl_addr": announce_addr(chan.addr)}
            if applicator is not None else None
        )
        # retry briefly — the consumer's endpoint may still be
        # coming up.
        for attempt in range(10):
            try:
                reply = announce(
                    opts.announce, btid, data_addr, telemetry=telemetry
                )
            except Exception:
                reply = None
            if reply and reply.get("ok"):
                announced = True
                break
            time.sleep(0.5 * (attempt + 1))
        if not announced:
            pub.close()
            raise SystemExit(
                f"admission endpoint {opts.announce} refused or "
                "unreachable"
            )

    if applicator is not None and opts.scenario_wait:
        # Hold the first frame until the consumer's current space is
        # held (and acked): a newcomer's first COUNTED frame carries
        # the current version, the fleet-controller contract.
        if not applicator.wait_for_space(timeout_s=opts.scenario_wait):
            import logging

            logging.getLogger("blendjax_torch.producer").warning(
                "no scenario space within %.1fs; publishing unstamped "
                "frames until one arrives", opts.scenario_wait,
            )

    # Zero-copy batch pool (cube_producer's shape): render straight
    # into pooled buffers, publish by reference, re-render a slot only
    # after its MessageTracker reports the IO thread done with it.
    pool = [
        {
            "image": np.empty((b, h, w, 4), np.uint8),
            "xy": np.empty((b, 8, 2), np.float32),
            "frameid": np.empty((b,), np.int64),
        }
        for _ in range(4)
    ]
    trackers = [None] * len(pool)
    cursor = {"slot": 0, "i": 0}
    pace = {"t0": time.monotonic(), "frames": 0}
    stamp = {"fields": {}}

    def publish(frame: int) -> None:
        slot = cursor["slot"]
        if cursor["i"] == 0:
            if trackers[slot] is not None:
                trackers[slot].wait()  # backpressure: slot in flight
                trackers[slot] = None
            if applicator is not None:
                # one scenario per BATCH: every row of the published
                # message shares the draw, so the batch-level _scenario
                # stamp attributes each row exactly
                stamp["fields"] = applicator.next_scenario()
        scene.observation_into(frame, pool[slot], cursor["i"])
        cursor["i"] += 1
        if cursor["i"] == b:
            trackers[slot] = pub.publish_tracked(
                **batch_stamp, **stamp["fields"], **pool[slot]
            )
            cursor["i"] = 0
            cursor["slot"] = (slot + 1) % len(pool)
        pace["frames"] += 1
        if opts.rate > 0:
            # absolute schedule (t0 + n/rate), not per-frame sleeps:
            # sleep jitter can't accumulate into rate drift
            due = pace["t0"] + pace["frames"] / opts.rate
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        if 0 < opts.frames <= frame:
            ctrl.cancel()

    def flush() -> None:
        i = cursor["i"]
        if i > 0:
            buf = pool[cursor["slot"]]
            # partial tail: copy the filled prefix — the pool slot is
            # reused, publish-by-reference would race the IO thread
            pub.publish(
                **batch_stamp, **stamp["fields"],
                **{k: v[:i].copy() for k, v in buf.items()},
            )

    # Graceful drain on SIGTERM (retire_instance's drain contract):
    # finish the current frame, ship the partial batch, flush the
    # socket, exit 0 — in-flight frames survive a scale-down.
    def _term(signum, frame_obj):
        ctrl.cancel()

    signal.signal(signal.SIGTERM, _term)

    ctrl.post_frame.add(publish)
    end = opts.frames if opts.frames > 0 else 2_147_483_647
    try:
        ctrl.play(frame_range=(1, end), num_episodes=-1)
        flush()
    finally:
        if announced:
            from blendjax_torch.fleet.admission import leave

            try:
                leave(opts.announce, btid, timeoutms=2000)
            except Exception:
                pass  # consumer gone: nothing left to drain into
        if applicator is not None:
            applicator.close()
        pub.close()
        term_context()  # block until the tail is flushed (bounded by linger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
