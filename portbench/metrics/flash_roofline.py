"""``flash_roofline``: the flash attention kernels' (K4a forward, K4b
dK/dV, K4c dQ, sm90 or simple) least possible time over their time in the
traced window, in %. Each launch's least time is the larger of its frozen
``attention_work`` FLOPs over the card's bf16 peak and its bytes over the
HBM rate, at the cell's batch, tokens, heads and head dim."""

from portbench.formulas.work import attention_work

KINDS = (("flash_bwd_dkv", "bwd_dkv"), ("flash_bwd_dq", "bwd_dq"),
         ("flash_fwd", "fwd"))


def read(ctx):
    trace = ctx["trace"]
    if trace is None or ctx["peaks"] is None:
        return None
    model = ctx["cell"].config["model"]
    traffic = ctx["cell"].traffic
    tokens = 1
    for s in traffic["shape"]:
        tokens *= -(-s // model["patch"])
    heads = model["num_heads"]
    work = attention_work(traffic["batch"], tokens, tokens, heads,
                          model["dim"] // heads, 2)
    flops_peak, bw = ctx["peaks"]
    least = seconds = 0.0
    for name, _ts, dur in trace["ops"]:
        kind = next((k for key, k in KINDS if key in name), None)
        if kind is None:
            continue
        flops, moved = work[kind]
        least += max(flops / flops_peak, moved / bw)
        seconds += dur / 1e6
    if not seconds:
        return None
    return 100.0 * least / seconds
