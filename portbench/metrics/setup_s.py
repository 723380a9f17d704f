"""``setup_s``: process start to the first timed step call (host clock):
imports, the build of the port's kernels where the checkout lacks them,
weights, traffic start, graph captures, the checked updates, warm-up."""


def read(ctx):
    return ctx["setup_s"]
