#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's paths on one CUDA card.

    python3 tools/torch_breakdown.py [--reps 3]

For each path (the 960 s / 48 kHz headline, non-stationary and stationary
with a 10 s noise clip, and a batch of 32 stationary 10 s clips, each under
the scipy-convention engines and under ``use_torch=True``; then one
training step, forward and backward of mean(gate(x)**2), of ``TPUGate``,
``gate_nonstationary`` and ``gate_stationary`` at batch 16 and 256 of 4 s
at 16 kHz), prints the host wall time of the call (numpy in and out for
``reduce_noise`` / ``reduce_noise_batch``; a training step ends in a
synchronize; minimum of ``--reps`` after a warm-up), then one call under
``torch.profiler``: the device's busy share of the profiled wall (the union
of its kernel and copy intervals), the number of device operations, and
the device time of each kernel and copy by name. The inputs are
``chip_smoke.py``'s, made from its seed. Needs one card; imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import noisereduce_tpu_torch as nr  # noqa: E402


def _device_events(prof):
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def breakdown(label: str, fn, reps: int) -> None:
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    busy = _union_us((e.time_range.start, e.time_range.end) for e in events) / 1e3
    by_name = collections.defaultdict(float)
    for e in events:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    print(f"{label}: host wall min {min(walls):.1f} ms (runs {', '.join(f'{w:.1f}' for w in walls)}); "
          f"profiled call {traced:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / traced:.0f}%), {len(events)} device operations", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {ms:8.3f} ms  {name[:90]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs one CUDA card")
    print(cs.card_line(), flush=True)
    x = cs.headline_signal(cs.HEADLINE_SECONDS)
    noise = cs.noise_clip(cs.NOISE_SECONDS)
    clips = [x[i * cs.BATCH_SECONDS * cs.SR : (i + 1) * cs.BATCH_SECONDS * cs.SR]
             for i in range(cs.BATCH_CLIPS)]
    breakdown("headline", lambda: nr.reduce_noise(x, cs.SR), args.reps)
    breakdown("stationary headline",
              lambda: nr.reduce_noise(x, cs.SR, stationary=True, y_noise=noise), args.reps)
    breakdown(f"batch {cs.BATCH_CLIPS} x {cs.BATCH_SECONDS} s stationary",
              lambda: nr.reduce_noise_batch(clips, cs.SR, stationary=True), args.reps)
    breakdown("torch headline", lambda: nr.reduce_noise(x, cs.SR, use_torch=True), args.reps)
    breakdown("torch stationary headline",
              lambda: nr.reduce_noise(x, cs.SR, stationary=True, use_torch=True, y_noise=noise),
              args.reps)
    breakdown(f"torch batch {cs.BATCH_CLIPS} x {cs.BATCH_SECONDS} s stationary",
              lambda: nr.reduce_noise_batch(clips, cs.SR, stationary=True, use_torch=True),
              args.reps)
    training(args.reps)


def training(reps: int) -> None:
    """One training step of each gate family, as ``chip_smoke.py``'s
    gradient phase runs it."""
    from noisereduce_tpu_torch.models.spectral_gate import (
        gate_nonstationary, gate_stationary, stationary_noise_threshold,
    )

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    n = cs.GRAD_SR * cs.GRAD_SECONDS
    gate = nr.TPUGate(sr=cs.GRAD_SR, nonstationary=True)
    ncfg = nr.GateConfig(sr=cs.GRAD_SR)
    scfg = nr.GateConfig(sr=cs.GRAD_SR, stationary=True)
    noise = 0.8 * torch.randn(cs.NOISE_SECONDS * cs.GRAD_SR, generator=gen, device="cuda")
    thr = stationary_noise_threshold(noise, scfg)
    families = (("TPUGate", gate), ("gate_nonstationary", lambda a: gate_nonstationary(a, ncfg)),
                ("gate_stationary", lambda a: gate_stationary(a, thr, scfg)))
    for batch in cs.GRAD_BATCHES:
        x = torch.randn((batch, n), generator=gen, device="cuda").requires_grad_()
        for name, fn in families:
            def step():
                x.grad = None
                (fn(x) ** 2).mean().backward()
                torch.cuda.synchronize()

            breakdown(f"training step {name} (batch {batch} x {cs.GRAD_SECONDS} s)", step, reps)


if __name__ == "__main__":
    main()
