"""The frozen counts against hand counts."""

from __future__ import annotations

import json
import os

import pytest

from portbench.cell import ROOT
from portbench.formulas import cnn, vit
from portbench.formulas.peaks import peaks
from portbench.formulas.work import attention_work, decode_work


def _model(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)["model"]


def test_vit_b16_is_777_gflop_per_image_at_480x640():
    # 1200 tokens; per token 2 x (16^2 x 4 x 768 + 12 x 12 x 768^2), per
    # block 4 x 1200^2 x 768 for attention, the head; x3 for the backward
    tokens = 30 * 40
    dense = 16 * 16 * 4 * 768 + 12 * 12 * 768 * 768
    fwd = 2 * tokens * dense + 12 * 4 * tokens ** 2 * 768 + 2 * 768 * 16
    assert vit.flops_per_image(_model("vit_b16"), (480, 640)) == 3 * fwd
    assert 3 * fwd / 1e9 == pytest.approx(777, rel=0.01)


def test_cube_regressor_is_6_9_gflop_per_image_at_480x640():
    hand = 0
    cin, h, w = 4, 480, 640
    for cout in (32, 64, 128, 256):
        h, w = h // 2, w // 2
        hand += h * w * 2 * 9 * cin * cout
        cin = cout
    hand += 2 * 256 * 256 + 2 * 256 * 16
    assert cnn.flops_per_image(_model("cube_regressor"), (480, 640)) == 3 * hand
    assert 3 * hand / 1e9 == pytest.approx(6.9, rel=0.01)


def test_k1_group_bytes():
    # a K' = 4 group of 8 frames, (16, 32) x 4 tiles of a 480x640 frame
    # (600 tiles), capacity 160, 3000 changed slots: the reference tiles,
    # the int32 indices, the changed tiles and the frames written
    n, ttc = 600, 16 * 32 * 4
    idx = 4 * 8 * 160
    out = 32 * 480 * 640 * 4
    assert decode_work(n, ttc, idx, 3000, out) == (
        0, 600 * 2048 + 5120 * 4 + 3000 * 2048 + 39321600)


def test_flash_work_at_vit_b16():
    work = attention_work(8, 1200, 1200, 12, 64, 2)
    mnk = 8 * 12 * 1200 * 1200 * 64
    assert [work[k][0] for k in ("fwd", "bwd_dkv", "bwd_dq")] == [
        4 * mnk, 8 * mnk, 6 * mnk]
    q = 8 * 1200 * 12 * 64 * 2
    assert work["fwd"][1] == 4 * q + 8 * 12 * 1200 * 4


def test_peaks_are_the_published_h100_sxm_figures():
    assert peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    with pytest.raises(ValueError):
        peaks("some other card")
