"""The port's profiling helpers (galaxy_deconv_tpu_torch/utils/profiling.py):
``profile_trace`` writes a Chrome trace of the block, and nothing for None;
``StageTimer`` sums each named stage over its entries."""

import json
import time

import torch

from galaxy_deconv_tpu_torch.utils.profiling import StageTimer, profile_trace


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(tmp_path / "trace") as prof:
        torch.fft.fft2(torch.ones(4, 32, 32)).abs().sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("fft" in e.get("name", "") for e in trace["traceEvents"])
    assert any("fft" in e.key for e in prof.key_averages())


def test_profile_trace_without_a_directory_does_nothing(tmp_path):
    with profile_trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None and not any(tmp_path.iterdir())


def test_stage_timer_sums_its_stages():
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("a"):
            time.sleep(0.01)
    with timer.stage("b"):
        pass
    times = timer.summary()
    assert set(times) == {"a", "b"} and times["a"] >= 0.02 and 0 <= times["b"] < times["a"]
    times["a"] = 0.0  # a copy
    assert timer.summary()["a"] >= 0.02
