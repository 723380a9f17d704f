"""The readings the limits of ``correct`` are set from, besides the
program's own: the control and the planted faults, at a cell's own size.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed, on the card (the CPU with ``--device cpu``), the cell's
first ``chunk`` messages are made as a run makes them (a live mix: the
first messages of its producers' scenes, in turn; a recording: its first
``chunk`` from the position the seed draws), and the plain reference
repeats the checked call's ``chunk`` updates in float32 with TF32 off.
Against it, as :mod:`portbench.check` compares a run:

- ``control``: the same reference one precision step below the
  configuration's bf16 products, every such product's operands in float8
  e4m3;
- ``half_batch``: the reference on the first half of every batch, the
  mean taken over those rows alone (a step that leaves half the batch
  out).

A step that returns its state unchanged reads ``change_gap`` 1 by the
measure's definition and needs no run. Benchmark runs never run this.
Prints one JSON line per seed, with each kind's verdict under the cell's
limits (:func:`portbench.check.verdict`; both have to read not correct),
and one summary line.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

from portbench.cell import load_cell


def first_batches(cell, seed: int) -> list:
    """``(frames, xy)`` of the ``chunk`` messages a run's checked call
    takes, made as the run's feed makes them."""
    from portbench.feed import render_messages, rotated, stream_messages
    from portbench.reference.wire import StreamFrames

    traffic = cell.traffic
    count = traffic["chunk"]
    if traffic["source"] == "recording":
        msgs = rotated(render_messages(traffic, traffic["scene_seed"],
                                       traffic["messages"]), seed)[:count]
    else:
        streams = [stream_messages(traffic, scene)
                   for scene in traffic["scene_seeds"]]
        msgs = [{**next(stream), "btid": i} for i, stream in itertools.islice(
            itertools.cycle(enumerate(streams)), count)]
    frames = StreamFrames()
    return [frames(m) for m in msgs]


def readings_for(cell, seed: int, device) -> dict:
    from portbench import check, weights

    cfg = cell.config
    shape = tuple(cell.traffic["shape"])
    batches = first_batches(cell, seed)
    ref = check.reference_updates(cfg, shape, seed, batches, device)
    start = weights.seeded_weights(
        {n: tuple(t.shape) for n, t in ref["params"].items()}, seed, device)
    out = {"seed": seed}
    ctrl = check.reference_updates(cfg, shape, seed, batches, device, "fp8")
    out["control"] = check.readings(ctrl, ref, start)
    half = [(f[: len(f) // 2], xy[: len(xy) // 2]) for f, xy in batches]
    half = check.reference_updates(cfg, shape, seed, half, device)
    out["half_batch"] = check.readings(half, ref, start)
    out["verdict"] = {kind: check.verdict(out[kind], cell.limits)[0]
                      for kind in ("control", "half_batch")}
    out["look"] = {"control": check.look(ctrl, ref, start),
                   "half_batch": check.look(half, ref, start)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    import torch

    cell = load_cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    rows = [readings_for(cell, s, torch.device(args.device))
            for s in args.seeds]
    for row in rows:
        print(json.dumps(row), flush=True)
    summary = {kind: {n: min(r[kind][n] for r in rows)
                      for n in rows[0][kind]}
               for kind in ("control", "half_batch")}
    print(json.dumps({"workload": args.workload, "smallest": summary,
                      "limits": cell.limits,
                      "any_correct": {k: any(r["verdict"][k] for r in rows)
                                      for k in ("control", "half_batch")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
