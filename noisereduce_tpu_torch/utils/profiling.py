"""Profiling helpers (counterpart of ``noisereduce_tpu/utils/profiling.py``;
the reference has no tracing or profiling, SURVEY.md §5).

``trace(log_dir)`` records a ``torch.profiler`` trace, the card's kernels
included where there is one, into ``log_dir`` (a Chrome trace, readable by
Perfetto or TensorBoard's profiler plugin); ``measure_rtf(fn, args,
audio_seconds)`` measures a real-time factor whose every call ends on a
checksum of the output read back to the host, so the time waits for the
card.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

__all__ = ["trace", "measure_rtf"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager: profile the block with ``torch.profiler`` (CPU and,
    where CUDA is available, CUDA activities) and write its trace into
    ``log_dir`` as ``trace_<pid>_<ns>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def measure_rtf(fn: Callable, args: tuple, audio_seconds: float, iters: int = 5) -> float:
    """Real-time factor of ``fn(*args)``: audio seconds processed per wall
    second, the best of ``iters`` calls after one warm-up call (which builds
    the kernels). Each call ends on ``.sum().item()`` of the output (a
    tensor or an array), the JAX package's in-graph checksum, so the time
    includes the card's work."""
    def call():
        torch.as_tensor(fn(*args)).sum().item()

    call()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        best = min(best, time.perf_counter() - t0)
    return audio_seconds / best
