"""``feed.place_ms_p50``: median of the port's ``feed.place`` span (the
host stage's copy of a packed group onto the card) over the window."""

import numpy as np


def read(ctx):
    spans = ctx["spans"].get("feed.place")
    if not spans:
        return None
    return float(np.median(spans) * 1e3)
