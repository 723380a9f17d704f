"""The plain reference against the port, at a tiny size on the CPU. Only
these tests import both: the reference itself imports nothing of the
port."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.cell import HERE
from portbench.feed import render_messages
from portbench.reference import cnn, vit
from portbench.reference.common import Products, corner_loss
from portbench.reference.wire import (
    StreamFrames,
    decode_frames,
    read_recording,
)

TRAFFIC = {"shape": [64, 128], "tile": [16, 32], "tile_capacity": 16,
           "ref_interval": 4, "batch": 8}


def test_the_reference_imports_nothing_of_the_port_or_of_jax():
    ref = os.path.join(HERE, "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for mod in mods:
                top = mod.split(".", 1)[0]
                assert top not in ("blendjax_torch", "blendjax", "jax",
                                   "flax", "jaxlib"), (name, mod)


def test_the_reference_decode_is_the_ports_decode():
    from blendjax_torch.data import StreamDataPipeline

    msgs = render_messages(TRAFFIC, 3, 10)  # keyframes at 0, 4 and 8
    want = [b["image"].numpy() for b in StreamDataPipeline(
        iter([dict(m) for m in msgs]), batch_size=8, device="cpu")]
    frames = StreamFrames()
    got = [frames(m)[0] for m in msgs]
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert any(not np.array_equal(g, frames.refs[0][None]) for g in got)


def test_recorded_wire_messages_read_back(tmp_path):
    from blendjax_torch.data.replay import FileRecorder
    from blendjax_torch.transport.wire import encode_message

    msgs = render_messages(TRAFFIC, 4, 3)
    path = str(tmp_path / "r.bjr")
    with FileRecorder(path) as rec:
        for m in msgs:
            rec.save(encode_message(m))
    back = [decode_frames(f) for f in read_recording(path)]
    assert len(back) == 3
    for m, b in zip(msgs, back):
        assert set(m) == set(b)
        for k, v in m.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, b[k])
            else:
                assert v == b[k]


def _pair(family):
    from blendjax_torch.models import CubeRegressor, StreamFormer

    if family == "vit":
        m = {"patch": 16, "dim": 64, "depth": 2, "num_heads": 2,
             "mlp_ratio": 4, "in_channels": 4, "num_outputs": 16}
        port = StreamFormer(patch=16, dim=64, depth=2, num_heads=2,
                            num_outputs=16, in_channels=4,
                            image_shape=(64, 128), dtype=torch.float32)
        ref = vit.Model(m, (64, 128), Products())
    else:
        m = {"features": [8, 16], "hidden": 32, "num_points": 8,
             "in_channels": 4}
        port = CubeRegressor(features=(8, 16), hidden=32,
                             dtype=torch.float32)
        ref = cnn.Model(m, (64, 128), Products())
    weights.load_into(port, 5)
    weights.load_into(ref, 5)
    return port, ref


@pytest.mark.parametrize("family", ["vit", "cnn"])
def test_the_reference_model_is_the_ports_in_f32(family):
    from blendjax_torch.train import corner_loss as port_loss

    port, ref = _pair(family)
    frames, xy = StreamFrames()(render_messages(TRAFFIC, 6, 1)[0])
    x = torch.from_numpy(frames.copy())
    y = torch.from_numpy(xy.copy())
    lp = port_loss(port(x).reshape(-1, 8, 2), y, image_shape=(64, 128))
    lr = corner_loss(ref(x), y, 64, 128)
    assert float(lp.detach()) == pytest.approx(float(lr.detach()), rel=1e-5)
    lp.backward()
    lr.backward()
    got = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(got[name].grad.numpy(), p.grad.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_the_reference_adamw_is_torchs():
    torch.manual_seed(0)
    p = torch.randn(5, 3)
    q = p.clone().requires_grad_(True)
    from portbench.reference.common import AdamW

    ours = AdamW({"p": p}, 1e-3, (0.9, 0.999), 1e-8, 1e-4)
    theirs = torch.optim.AdamW([q], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=1e-4)
    for _ in range(3):
        g = torch.randn(5, 3)
        ours.step({"p": g})
        q.grad = g.clone()
        theirs.step()
    torch.testing.assert_close(p, q.detach(), rtol=1e-6, atol=1e-7)
