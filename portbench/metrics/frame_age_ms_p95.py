"""``frame_age_ms_p95``: the 95th percentile, over every message trained
in the window, of the time from its producer's publish stamp to the
completion of the step call that trained it (a CUDA event recorded after
the call, mapped to the host clock through one reference event). None
where the messages carry no publish stamp (a recording)."""

import numpy as np


def read(ctx):
    ages = ctx["frame_ages_s"]
    if not ages:
        return None
    return float(np.percentile(np.asarray(ages) * 1e3, 95))
