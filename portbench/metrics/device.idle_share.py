"""``device.idle_share``: the share of the traced window in which no
device operation (kernel, copy, set) ran, from ``torch.profiler``'s trace
of the card, in %."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not trace["ops"] or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
