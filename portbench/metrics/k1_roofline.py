"""``k1_roofline``: K1's (``decode_spatial``: ``build_inverse`` and
``copy_footprints``) least possible time over its time in the traced
window, in %. The least time is the larger of its bytes over the card's
HBM rate and its FLOPs (none) over its peak; the bytes are the frozen
``decode_work`` of each launch: the reference tiles once per launch, and
per message its index slots, its changed tiles and its decoded frames."""

from portbench.formulas.work import decode_work

KERNELS = ("build_inverse", "copy_footprints")


def read(ctx):
    trace = ctx["trace"]
    if trace is None or ctx["peaks"] is None:
        return None
    ops = [(n, d) for n, _ts, d in trace["ops"]
           if any(k in n for k in KERNELS)]
    launches = sum(1 for n, _d in ops if "copy_footprints" in n)
    seconds = sum(d for _n, d in ops) / 1e6
    recs = [r for r in trace["records"] if "valid" in r]
    if not launches or not seconds or not recs:
        return None
    moved = launches * recs[0]["n_tiles"] * recs[0]["ttc"]
    for r in recs:
        moved += decode_work(0, r["ttc"], r["idx_numel"], r["valid"],
                             r["out_bytes"])[1]
    _flops, bw = ctx["peaks"]
    return 100.0 * (moved / bw) / seconds
