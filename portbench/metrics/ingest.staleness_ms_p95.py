"""``ingest.staleness_ms_p95``: receive minus publish wall time of every
message trained in the window that was received in it, read where the
port's frame lineage reads it (``obs/lineage.py``), 95th percentile."""

import numpy as np


def read(ctx):
    stale = ctx["staleness_s"]
    if not stale:
        return None
    return float(np.percentile(np.asarray(stale) * 1e3, 95))
