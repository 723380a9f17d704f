"""``step_mfu``: the whole step's share of the card's bf16 peak, in %:
images trained in the traced window times the family's frozen model
FLOPs per image (``portbench/formulas/<family>.py``), over the traced
window, over the peak."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or ctx["peaks"] is None or not trace["images"]:
        return None
    flops_peak, _bw = ctx["peaks"]
    rate = trace["images"] * ctx["flops_per_image"] / trace["window_s"]
    return 100.0 * rate / flops_peak
