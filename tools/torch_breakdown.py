#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's paths on one CUDA card.

    python3 tools/torch_breakdown.py [--reps 3]

For each path (the 960 s / 48 kHz headline, non-stationary and stationary
with a 10 s noise clip, and a batch of 32 stationary 10 s clips, each under
the scipy-convention engines and under ``use_torch=True``), prints the
host wall time of ``reduce_noise`` / ``reduce_noise_batch`` (numpy in and
out; minimum of ``--reps`` after a warm-up), then one call under
``torch.profiler``: the device's busy share of the profiled wall (the union
of its kernel and copy intervals) and the device time of each kernel and
copy by name. The inputs are ``chip_smoke.py``'s, made from its seed.
Needs one card; imports nothing of JAX.
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
          f"({100 * busy / traced:.0f}%)", flush=True)
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


if __name__ == "__main__":
    main()
