"""The control and the fault come out not correct.

The control is the reference in the program's place at a lower precision
(bfloat16 here on the CPU; TF32 and bfloat16 on the card, at a size a test
run holds). The fault is planted in the measured package underneath a run
that skips the look for a card: a viewer answer replaced by the one before
it. Each is judged by the cell's own limits."""

import math

import numpy as np
import pytest
import torch

from benchmark import control as K
from benchmark import harness as H
from benchmark.tests import bench_tiny as B

CPU = torch.device("cpu")


def _judged(numbers, cell):
    return H.judge(numbers, B.limits(cell))[0]


@pytest.mark.parametrize("cell,config,mix", [("garden.view", "garden", "view"),
                                             ("room.view_360", "room", "view_360")])
def test_view_control_and_faults_fail(cell, config, mix):
    cfg = B.tiny_config(config)
    got = K.readings(cfg, B.mix(mix), 12, CPU, precisions=("bf16",))
    for name in ("bf16", "stale_answer"):
        assert not _judged(got[name], cell), (name, got[name])


@pytest.mark.parametrize("cell,config,mix", [("garden.view", "garden", "view"),
                                             ("room.view_360", "room", "view_360")])
def test_bf16_control_reads_finite_numbers(cell, config, mix):
    """Opacities that bfloat16 rounds to 1 and its alpha clamp: the control
    renders, and its numbers are finite."""
    cfg = B.tiny_config(config)
    cfg["scene"]["opacity"].update(high_share=0.9, high_logit=[8.0, 0.5])
    got = K.readings(cfg, B.mix(mix), 14, CPU, precisions=("bf16",))
    assert all(math.isfinite(v) for v in got["bf16"].values()), got["bf16"]
    assert not _judged(got["bf16"], cell), got["bf16"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,config,mix", [("garden.view", "garden", "view"),
                                             ("room.view_360", "room", "view_360")])
def test_control_fails_on_the_card(cell, config, mix):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = B.tiny_config(config, n=200_000, cap=262_144, w=640, h=432)
    got = K.readings(cfg, B.mix(mix), 13, torch.device("cuda"))
    assert all(math.isfinite(v) for v in got["bf16"].values()), got["bf16"]
    assert not _judged(got["bf16"], cell)


def test_an_altered_answer_is_caught(monkeypatch):
    from splat_one_tpu_torch.app import viewer as V

    call = V.Renderer.__call__
    last = {}

    def stale(self, c2w, K, camera_model=None):
        # each answer is the one before it; the first, its rows shifted by one
        frame = call(self, c2w, K, camera_model)
        out = last.get("frame", np.roll(frame, 1, axis=0))
        last["frame"] = frame
        return out

    monkeypatch.setattr(V.Renderer, "__call__", stale)
    cfg = B.tiny_config("garden")
    mix = B.mix("view", expect_requests=4, check_requests=3)
    out = H.load_kind("view").run(cfg, mix, 22, 2.0, False, CPU, lambda: 0.0)
    assert out["attempted"] >= 1
    assert not _judged(out["check"](), "garden.view")
