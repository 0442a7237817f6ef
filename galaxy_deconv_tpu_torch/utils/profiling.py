"""Profiling helpers (counterpart of ``galaxy_deconv_tpu/utils/profiling.py``):
a ``torch.profiler`` trace around a block and named wall-clock stages."""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str | pathlib.Path | None):
    """Trace the block with ``torch.profiler`` (the CPU, and the card when
    there is one) and write a Chrome trace, viewable in Perfetto or
    ``chrome://tracing``, to ``log_dir/trace.json``; yields the profiler
    (``key_averages()`` for sums by kernel).  A no-op yielding None when
    ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = pathlib.Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "trace.json"))


class StageTimer:
    """Cheap named wall-clock stage timing with a summary dict."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> dict[str, float]:
        return dict(self.times)
