"""Time the K2 (``decode_scatter``), K3 (``gamma_normalize``), K4a
(``flash_attention_fwd``), K4b (``flash_attention_bwd_dkv``) and K4c
(``flash_attention_bwd_dq``) wrappers of checkouts of this repo on one card,
with ``chip_smoke.time_ms``
(card time of windows queued behind a sleep kernel, and the host's enqueue
time per call), so two versions of a kernel compare under one method.

    python3 kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (this one: ``.``). The script builds
the kernels of every distinct tree first (all ``nvcc`` processes started
together, into each tree's own ``build/``), then times each TREE in a
process of its own, in the order given: ``python3 kernel_ab.py PARENT . .
PARENT`` measures parent, change, change, parent in one run. Shapes are
the main path's: K2 at B 32, K 288, 16x16x4 slots of 480x640 frames;
K3 on an echo batch (8, 480, 640, 4) of uniform random uint8, gamma 2.2,
f32 and bf16 out, on one buffer and over ``chip_smoke.L2_ROUNDS`` copies in
turn; K4a-c on bf16 q/k/v views of one qkv buffer at (8, 768, 4, 128) and
(4, 3072, 4, 128), beside SDPA's forward and its autograd backward (K4b and
K4c together). Every result is held against its tree's plain version
first (K2 bit-exact, K3 within 1e-6 f32 / one bf16 ulp, K4a within 2e-2,
K4b/K4c within 2e-2 of the largest plain value). Prints a
line per tree, then the card's name and power limit, and last one JSON
object of every measurement. Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCES = ("decode_scatter", "gamma_normalize", "flash_attention",
                  "flash_fwd_sm90", "flash_bwd_sm90")


def smoke():
    """This checkout's ``chip_smoke`` module (its ``time_ms`` and input
    makers), loaded by path so a TREE's own copy never shadows it."""
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: str) -> dict:
    """Time one tree's wrappers in this process."""
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as F

    import blendjax_torch
    from blendjax_torch.kernels import attention as K
    from blendjax_torch.kernels import decode as D

    where = os.path.dirname(os.path.dirname(os.path.realpath(
        blendjax_torch.__file__)))
    if where != os.path.realpath(tree):
        raise RuntimeError(f"imported blendjax_torch from {where}, not {tree}")
    cs = smoke()
    h, w = cs.SHAPE
    ref, idx, tiles = cs.make_case(cs.BATCH * cs.CHUNK, 288, h, w, 4, 16, 16,
                                   seed=2)
    got = D.decode_scatter(ref, idx, tiles)
    if not torch.equal(got, D.decode_scatter_plain(ref, idx, tiles)):
        raise RuntimeError("decode_scatter != decode_scatter_plain")
    out = {"tree": tree,
           "decode_scatter": cs.time_ms(lambda: D.decode_scatter(ref, idx, tiles))}
    out.update(gamma_runs(cs))
    for name, (b, t) in (("slice", (8, 768)), ("long", cs.LONG_ATTN)):
        q, k, v, do = cs.attn_inputs(b, t, t, 4, 128, torch.bfloat16, 300)
        o, lse = K.flash_attention_fwd(q, k, v)
        o_ref, _ = K.flash_attention_fwd_plain(q, k, v)
        err = float((o.float() - o_ref.float()).abs().max())
        if err > 2e-2:
            raise RuntimeError(f"flash_attention_fwd {name}: max |diff| {err}")
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        out[f"flash_attention_fwd {name}"] = {
            **cs.time_ms(lambda: K.flash_attention_fwd(q, k, v)),
            "max_abs_err": err,
            "variants": dict(getattr(K.flash_attention_fwd,
                                     "launches_by_variant", {})),
        }
        with torch.no_grad():
            out[f"sdpa_fwd {name}"] = cs.time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh))
        bwd = (q, k, v, do, lse, K.attention_delta(o, do))
        for kernel in ("bwd_dkv", "bwd_dq"):
            fn = getattr(K, f"flash_attention_{kernel}")
            got = fn(*bwd)
            want = getattr(K, f"flash_attention_{kernel}_plain")(*bwd)
            err = 0.0
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                e = float((g.float() - w.float()).abs().max())
                if e > 2e-2 * float(w.float().abs().max()):
                    raise RuntimeError(f"flash_attention_{kernel} {name}: "
                                       f"max |diff| {e}")
                err = max(err, e)
            out[f"flash_attention_{kernel} {name}"] = {
                **cs.time_ms(lambda: fn(*bwd)), "max_abs_err": err,
                "variants": dict(getattr(fn, "launches_by_variant", {})),
            }
        for x in (qh, kh, vh):
            x.requires_grad_()
        oh = F.scaled_dot_product_attention(qh, kh, vh)
        doh = do.transpose(1, 2).contiguous()
        out[f"sdpa_bwd {name}"] = cs.time_ms(lambda: torch.autograd.grad(
            oh, (qh, kh, vh), doh, retain_graph=True))
    return out


def gamma_runs(cs) -> dict:
    """K3 of the imported tree on one echo batch of random bytes, f32 and
    bf16 out, each held against the plain version first, then timed on
    that one buffer again and again (L2-resident) and over
    ``cs.L2_ROUNDS`` copies of it in turn (``rotating``: from HBM)."""
    import numpy as np
    import torch

    from blendjax_torch.kernels import image as I

    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (cs.BATCH, *cs.SHAPE, 4), dtype=np.uint8)).cuda()
    xs = [x.clone() for _ in range(cs.L2_ROUNDS)]
    out = {}
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        def fn(t, dt=dt):
            return I.gamma_normalize(t, 2.2, dt)

        err, ok = cs.gamma_close(fn(x), I.gamma_normalize_plain(x, 2.2, dt))
        if not ok:
            raise RuntimeError(f"gamma_normalize {label}: max |diff| {err}")
        out[f"gamma_normalize {label}"] = {
            **cs.time_ms(lambda: fn(x)), "max_abs_err": err}
        out[f"gamma_normalize {label} rotating"] = cs.time_ms(
            cs.rotating(fn, xs))
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    trees = [os.path.abspath(t) for t in argv]
    builds = []
    for tree in dict.fromkeys(trees):
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "from blendjax_torch.kernels.build import SOURCES, build; "
                f"build([n for n in SOURCES if n in {KERNEL_SOURCES!r}])")
        builds.append(subprocess.Popen([sys.executable, "-c", code, tree],
                                       stdout=subprocess.DEVNULL))
    if any(p.wait() for p in builds):
        print("kernel_ab: a build failed", file=sys.stderr)
        return 1
    runs = []
    for tree in trees:
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree],
            capture_output=True, text=True, cwd=tree)
        if done.returncode:
            print(done.stderr, file=sys.stderr)
            return 1
        run = json.loads(done.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(f"kernel_ab {tree}: " + "; ".join(
            f"{key} {m['ms']:.4f} ms [{m['min_ms']:.4f}-{m['max_ms']:.4f}] "
            f"host {m['host_ms']:.4f} ms" for key, m in run.items()
            if key != "tree"), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no reading", flush=True)
    print(json.dumps({"runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
