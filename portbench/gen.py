"""The one traffic generator: audio made on the device from the seed.

Every traffic mix (``traffic/<mix>.json``) names its sizes and the
``signal`` parameters read here. A row is speech-band tones over noise
whose level drifts: one tone gated on and off, one steady, and Gaussian
noise whose level follows a slow sine (the case the non-stationary gate is
for). The seed draws only the frequencies, periods, phases and noise, never
a size, so every seed gives the same work.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device, dtype=torch.float64)


def rows(g: torch.Generator, spec: dict, n_rows: int, n: int, sr: int, device):
    """(noisy, clean): two (n_rows, n) float32 tensors; clean is the tones
    alone. ``spec``: the mix's ``signal`` parameters."""
    lo, hi = spec["tone_hz"]
    f = _uniform(g, (n_rows, 2, 1), lo, hi, device)
    period = _uniform(g, (n_rows, 1), *spec["gate_period_s"], device)
    phase = _uniform(g, (n_rows, 3, 1), 0.0, 2 * math.pi, device)
    drift = _uniform(g, (n_rows, 1), *spec["drift_period_s"], device)
    t = torch.arange(n, device=device, dtype=torch.float64)[None] / sr
    on = (torch.floor(t / period) % 2 == 0).to(torch.float64)
    w = 2 * math.pi * t[:, None]
    tones = spec["tone_amp"][0] * on * torch.sin(w[:, 0] * f[:, 0] + phase[:, 0]) \
        + spec["tone_amp"][1] * torch.sin(w[:, 0] * f[:, 1] + phase[:, 1])
    level = spec["noise_level"] + spec["noise_drift"] * torch.sin(
        2 * math.pi * t / drift + phase[:, 2])
    noise = torch.randn((n_rows, n), generator=g, device=device, dtype=torch.float32)
    clean = tones.to(torch.float32)
    return clean + level.to(torch.float32) * noise, clean
