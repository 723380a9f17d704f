"""The comparison that decides ``correct``.

Set-up drives the program's own training step over the feed's first full
chunk group: one call of the signature the window times (``chunk``
updates of ``batch`` frames, one replay of the captured graph), through
the window's driver, on ``chunk`` different messages. It keeps what the
program produced: each update's loss, AdamW's first moment after the
call (``exp_avg``) and the parameters after it. Once the window has
closed and the program's state is freed, the plain reference
(:mod:`portbench.reference`) decodes the same wire messages itself,
starts from the same seeded weights and repeats the updates in float32
with TF32 off.

The numbers (:func:`readings`), each compared against its limit in the
cell's limits file (``portbench/limits/<workload>.json``):

- ``loss_gap``: the largest relative gap of an update's loss;
- ``moment_gap``: over the leaves, the largest gap between the norms of
  the program's and the reference's first moment after the last update
  (every update's gradient, weighted as AdamW weighs them), over the
  larger of the reference leaf's norm and the median leaf's;
- ``change_gap``: the same of the parameters' change over the updates,
  leaving out the entries whose reference gradient is nought to rounding
  (:func:`_gaps`).

:func:`look` prints what lies behind them.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from portbench import weights
from portbench.cell import family_module
from portbench.reference.common import AdamW, Products, corner_loss, exact_matmuls
from portbench.reference.wire import StreamFrames, decode_frames

#: the numbers :func:`readings` gives, each limited in a cell's limits file
NAMES = ("loss_gap", "moment_gap", "change_gap")


def decoded_messages(raw: list, keys: list) -> list:
    """``(frames, xy)`` of the messages ``keys`` names (``("seq", btid,
    seq)`` of a live stream or ``("index", i)`` of a recording), decoded
    in the stream's order so each meets its producer's reference frame."""
    frames = StreamFrames()
    wanted = {tuple(k): i for i, k in enumerate(keys)}
    out = [None] * len(keys)
    for index, msg_frames in enumerate(raw):
        msg = decode_frames(msg_frames)
        key = (("seq", msg.get("btid"), msg.get("_seq"))
               if "_seq" in msg else ("index", index))
        frames.take_ref(msg)
        if key in wanted:
            out[wanted[key]] = frames(msg)
    missing = [k for k, v in zip(keys, out) if v is None]
    if missing:
        raise RuntimeError(f"messages {missing} are not in the recording")
    return out


def reference_updates(config: dict, shape, seed: int, batches: list,
                      device, precision: str = "f32") -> dict:
    """The plain reference's losses, first gradient, first moment and
    parameters after the updates on ``batches`` (``(frames uint8, xy)``
    each)."""
    module = family_module("reference", config["family"])
    model = module.Model(config["model"], shape, Products(precision))
    model = model.to(device)
    weights.load_into(model, seed)
    params = {n: p for n, p in model.named_parameters()}
    opt = config["optimizer"]
    adamw = AdamW(params, opt["lr"], opt["betas"], opt["eps"],
                  opt["weight_decay"])
    h, w = shape
    losses, grad1 = [], None
    with exact_matmuls():
        for frames, xy in batches:
            x = torch.from_numpy(np.array(frames, np.uint8)).to(device)
            y = torch.from_numpy(np.array(xy, np.float32)).to(device)
            loss = corner_loss(model(x), y, h, w)
            grads = torch.autograd.grad(loss, list(params.values()))
            grads = dict(zip(params, grads))
            if grad1 is None:
                grad1 = {n: g.detach().clone() for n, g in grads.items()}
            adamw.step(grads)
            losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1,
            "moment": {n: m.detach().clone() for n, m in adamw.m.items()},
            "params": {n: p.detach().clone() for n, p in params.items()}}


def _norms(leaves: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in leaves.items()}


def _leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """Per leaf, the gap of the norms over the larger of the reference
    leaf's norm and the median leaf's."""
    names = [n for n in want if keep is None or n in keep]
    if not names:
        return {}
    floor = statistics.median(want[n] for n in names)
    return {n: abs(got[n] - want[n]) / max(want[n], floor, 1e-30)
            for n in names}


def _gaps(program: dict, reference: dict, start: dict) -> tuple:
    """``(per-update loss gaps, per-leaf first-moment gaps, per-leaf
    change gaps)``. The change leaves out every entry whose reference gradient is
    under a thousandth of the median leaf's root-mean-square gradient:
    nought to rounding (the key's third of each qkv bias, which softmax
    makes so), such an entry moves under AdamW by round-off alone; a leaf
    with no entry left goes out."""
    lp, lr = program["losses"], reference["losses"]
    if len(lp) != len(lr) or not all(math.isfinite(v) for v in lp):
        loss = [math.inf] * max(len(lr), 1)
    else:
        loss = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr)]
    m_ref = _norms(reference["moment"])
    m_prog = _norms({n: program["moment"][n] for n in m_ref})
    grads = reference["grad1"]
    rms = statistics.median(
        float(t.double().pow(2).mean().sqrt()) for t in grads.values())
    dev = next(iter(start.values())).device
    masks = {n: (t.abs() >= 1e-3 * rms).to(dev) for n, t in grads.items()}
    keep = [n for n, m in masks.items() if bool(m.any())]
    d_ref = _norms({n: (reference["params"][n].to(dev) - start[n]) * masks[n]
                    for n in keep})
    d_prog = _norms({n: (program["params"][n].to(dev) - start[n]) * masks[n]
                     for n in keep})
    return loss, _leaf_gaps(m_prog, m_ref), _leaf_gaps(d_prog, d_ref)


def readings(program: dict, reference: dict, start: dict) -> dict:
    """The numbers the check compares, between two runs of the updates
    from the same parameters ``start`` (``program`` and ``reference`` as
    :func:`reference_updates` returns them, tensors on any device): the
    worst update's loss gap and the worst leaf's gap of the first moment
    and of the change."""
    loss, moment, change = _gaps(program, reference, start)
    out = {"loss_gap": max(loss),
           "moment_gap": max(moment.values(), default=math.inf),
           "change_gap": max(change.values(), default=math.inf)}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def look(program: dict, reference: dict, start: dict) -> dict:
    """What lies behind the numbers: each update's loss gap, and per
    measure the three worst leaves and the median leaf's gap."""
    loss, moment, change = _gaps(program, reference, start)
    out = {"loss_gaps": [float("%.3g" % v) for v in loss]}
    for name, gaps in (("moment", moment), ("change", change)):
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        out[name] = {"worst": [[n, float("%.3g" % v)] for n, v in worst],
                     "median": float("%.3g" % statistics.median(
                         gaps.values())) if gaps else None}
    return out


def verdict(values: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number the cell's limits name under its
    limit; ``checks`` maps each to ``{"value", "limit"}``."""
    checks = {n: {"value": values[n], "limit": limits[n]} for n in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def program_snapshot(state) -> dict:
    """Host copies of what the program's state holds after the checked
    call: AdamW's first moment (zero for a parameter the optimizer has not
    stepped) and the parameters."""
    named = dict(state.model.named_parameters())
    moment = {}
    for n, p in named.items():
        m = state.optimizer.state.get(p, {}).get("exp_avg")
        moment[n] = (torch.zeros_like(p, device="cpu") if m is None
                     else m.detach().to("cpu", torch.float32, copy=True))
    return {"moment": moment,
            "params": {n: p.detach().to("cpu", copy=True)
                       for n, p in named.items()}}
