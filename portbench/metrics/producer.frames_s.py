"""``producer.frames_s``: the producers' own rate, render and encode only
(the publish, where backpressure blocks, left out), from each cube
producer's last stats line, summed over the producers."""


def read(ctx):
    stats = ctx["producers"]
    if not stats:
        return None
    return float(sum(s["own_frames_s"] for s in stats))
