"""The port's ``utils/profiling.py`` and ``utils/logger.py``, on the CPU.

- ``trace`` writes a TensorBoard-loadable trace file into its directory
  that names the ops run inside it.
- ``device_timer`` returns a positive time a call, after a warm call, at
  least a call's sleep; ``host_roundtrip_s`` above the total gives 0.
- ``memory_stats()`` is ``{}`` without CUDA (as JAX's skips devices
  without stats); ``Trainer.eval`` reports the largest ``*_peak_gib`` as
  ``mem`` (JAX ``train/trainer.py:983-992``), and no ``mem`` without one.
- ``setup_logger`` against JAX's: the same handler types and format, the
  same ``<workdir>/logs/app.log``, one logger per workdir.
"""

import glob
import json
import logging
import os
import time

import pytest
import torch

from splat_one_tpu.utils import logger as jlogger
from splat_one_tpu_torch.utils import logger as tlogger
from splat_one_tpu_torch.utils import profiling


def test_trace_writes_a_trace(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        torch.mm(a, a)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_device_timer_positive():
    a = torch.randn(128, 128)
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    t = profiling.device_timer(fn, a, iters=5)
    assert t > 0 and len(calls) == 6  # one warm call, then 5 timed

    def sleepy(x):
        time.sleep(0.01)
        return x

    assert profiling.device_timer(sleepy, a, iters=3) >= 0.01
    assert profiling.device_timer(sleepy, a, iters=3, host_roundtrip_s=1.0) == 0.0


def test_memory_stats_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only answer")
    assert profiling.memory_stats() == {}


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    from splat_one_tpu_torch.data.synthetic import make_synthetic_scene
    from splat_one_tpu_torch.train.config import Config
    from splat_one_tpu_torch.train.trainer import Trainer

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    scene, _ = make_synthetic_scene(n_gaussians=64, n_cameras=3, width=32, height=32,
                                    device="cpu")
    cfg = Config(max_steps=1, eval_steps=[], save_steps=[], capacity=128, sh_degree=1,
                 camera_model="pinhole", result_dir=str(tmp_path_factory.mktemp("r")))
    yield Trainer(cfg, scene, device="cpu")
    torch.set_num_threads(n)


@pytest.mark.parametrize("stats,mem", [
    ({}, None),
    ({"dev0_gib": 0.5, "dev0_peak_gib": 1.25, "dev1_gib": 0.1, "dev1_peak_gib": 2.5}, 2.5),
])
def test_eval_reports_peak_memory(trainer, monkeypatch, stats, mem):
    from splat_one_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setattr(trainer_mod, "memory_stats", lambda: dict(stats))
    out = trainer.eval(0)
    assert out.get("mem") == mem
    assert "psnr" in out


def _handlers(logger):
    return [(type(h), h.formatter._fmt, getattr(h, "baseFilename", None))
            for h in logger.handlers]


def test_setup_logger_matches_jax(tmp_path):
    wd_j, wd_t = tmp_path / "j", tmp_path / "t"
    lj = jlogger.setup_logger(str(wd_j))
    lt = tlogger.setup_logger(str(wd_t))
    try:
        assert lt.level == lj.level == logging.INFO
        hj, ht = _handlers(lj), _handlers(lt)
        assert [h[:2] for h in ht] == [h[:2] for h in hj]
        assert [h[2] for h in ht] == [None if h[2] is None else str(wd_t / "logs" / "app.log")
                                      for h in hj]
        assert tlogger.setup_logger(str(wd_t)) is lt  # one logger a workdir
        other = tlogger.setup_logger(str(tmp_path / "o"))
        assert other is not lt and other.handlers[0].baseFilename.startswith(
            str(tmp_path / "o"))
        lt.info("hello")
        for h in lt.handlers:
            h.flush()
        line = (wd_t / "logs" / "app.log").read_text().strip()
        assert line.endswith(f"| INFO | {lt.name} | hello")
    finally:
        for lg in (lj, lt, tlogger.setup_logger(str(tmp_path / "o"))):
            for h in list(lg.handlers):
                h.close()
                lg.removeHandler(h)
        assert os.path.exists(wd_j / "logs" / "app.log")
