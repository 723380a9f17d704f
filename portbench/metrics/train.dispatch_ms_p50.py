"""``train.dispatch_ms_p50``: median of the port's ``train.dispatch`` span
(one step call's host time: the graph's input copies, seeds and replay)
over the window."""

import numpy as np


def read(ctx):
    spans = ctx["spans"].get("train.dispatch")
    if not spans:
        return None
    return float(np.median(spans) * 1e3)
