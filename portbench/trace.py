"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over a
stretch of step calls, read back from its Chrome trace.

:class:`TracedWindow` starts the profiler (CPU and CUDA activities) at a
step-call boundary once the card is idle, and stops it after a
synchronisation, so every device operation of the calls it saw lies
inside it. :func:`read_trace` returns the device
operations (kernels, copies, sets) with their times, their union (the
seconds the device was busy), and the idle gaps between them, each named
by the harness's host annotation (``bench.*``) that was open when the gap
began.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_LABEL = "bench."


class TracedWindow:
    def __init__(self, workdir: str, on_card: bool = True):
        self.on_card = on_card
        self.path = os.path.join(workdir, "trace.json")
        self.prof = None
        self.t0 = self.t1 = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.on_card:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if self.on_card:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def read(self) -> dict | None:
        if self.t1 is None:
            return None
        out = read_trace(self.path)
        os.remove(self.path)
        out["window_s"] = self.t1 - self.t0
        return out


def _union(intervals) -> tuple:
    """``(busy seconds, merged [start, end] list)`` of µs intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e6, merged


def read_trace(path: str) -> dict:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ops, labels = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        name = ev.get("name", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((name, ts, dur))
        elif cat == "user_annotation" and name.startswith(HOST_LABEL):
            labels.append((ts, ts + dur, name))
    busy_s, merged = _union((ts, ts + dur) for _n, ts, dur in ops)
    by_name = collections.Counter()
    for name, _ts, dur in ops:
        by_name[name[:160]] += dur / 1e6
    gaps = collections.Counter()
    labels.sort()
    starts = [lab[0] for lab in labels]
    for (_a, end), (start, _b) in zip(merged, merged[1:]):
        # the harness's annotations nest a few deep on one thread: the
        # innermost one open when the device went idle is among the last
        # few that began before
        at = bisect.bisect_right(starts, end)
        open_ = [lab for lab in labels[max(0, at - 16):at] if end < lab[1]]
        label = min(open_, key=lambda lab: lab[1] - lab[0])[2] if open_ \
            else "host outside the harness's annotations"
        gaps[label] += (start - end) / 1e6
    return {"ops": ops, "busy_s": busy_s,
            "device_ops": by_name.most_common(10),
            "idle_gaps": gaps.most_common(10)}
