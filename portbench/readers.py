"""What the metric readers (``metrics/<metric>.py``) share: each reads one
of these from the run's context (``harness.Context``) and returns None
where the run has nothing to read."""
from __future__ import annotations

import statistics

import numpy as np

from portbench.roofline import FP32_OPS_PER_S, HBM_BYTES_PER_S, gate_ops, kernel_share

__all__ = ["kernel_share", "window_rate", "dispatch_ms", "event_ms", "event_p95_ms",
           "glue_ms", "idle_pct", "gate_roofline", "gate_mfu"]


def window_rate(ctx):
    """Channel-seconds of audio in every call (or step) the window completed,
    over the window's wall seconds (it ends on a synchronize after its last
    call)."""
    return ctx.window.calls * ctx.audio_s_per_call / ctx.window.seconds


def dispatch_ms(ctx):
    """Median host ms a call spends issuing its work, no synchronize, over
    the measured window of the traced run (not its profiled part)."""
    return statistics.median(ctx.window.spans) * 1e3 if ctx.window.spans else None


def event_ms(ctx, name: str):
    """Median ms a call of the device-clock interval ``name`` (CUDA events)."""
    ms = ctx.window.event_ms.get(name)
    return statistics.median(ms) if ms else None


def event_p95_ms(ctx, name: str):
    """95th percentile over all the window's calls of the interval ``name``."""
    ms = ctx.window.event_ms.get(name)
    return float(np.percentile(ms, 95)) if ms else None


def _per_call(ctx, seconds):
    return seconds / ctx.trace_calls


def glue_ms(ctx):
    """Device ms a call of operations that are none of the port's kernels
    (``kernels.json``): torch's own kernels, copies, memsets."""
    return None if ctx.summary is None else _per_call(ctx, ctx.summary.glue_s) * 1e3


def idle_pct(ctx):
    """Share of the traced window in which the card runs no kernel, copy or
    memset (the union of the device's intervals), %."""
    if ctx.summary is None:
        return None
    return 100.0 * (1.0 - ctx.summary.busy_s / ctx.summary.window_s)


def gate_roofline(ctx):
    """The call's signal read once and its output written once over the
    memory rate, over the device time of all the call's operations, %: the
    same work however the port splits or fuses its kernels."""
    if ctx.summary is None or not ctx.summary.device_s:
        return None
    s = ctx.shapes
    least = (s["sb"] * s["samples_in"] + s["ob"] * s["samples_out"]) / HBM_BYTES_PER_S
    return 100.0 * least / _per_call(ctx, ctx.summary.device_s)


def gate_mfu(ctx):
    """The operations of the gate's algorithm (``roofline.gate_ops``) over
    the FP32 peak, over the device time of all the call's operations, %."""
    if ctx.summary is None or not ctx.summary.device_s:
        return None
    return 100.0 * gate_ops(ctx) / FP32_OPS_PER_S / _per_call(ctx, ctx.summary.device_s)
