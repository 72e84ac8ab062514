#!/usr/bin/env python3
"""Time kernels A ``spectra`` and D ``istft_ola`` on one CUDA card at the
headline shapes (960 s of 48 kHz audio, n_fft 1024 / hop 256), at
n_fft 1536 / hop 384 (the first 60 s, and all 960 s), n_fft 400 / hop 100
(960 s) and n_fft 1100 / hop 275 (60 s, the product route), chunked as
``reduce_noise`` chunks (600000 / 30000); and A alone on the 10 s noise
row of ``chip_smoke.py`` (n_fft 1024, unchunked: the stationary paths'
threshold spectra, TPU row 3). Two times per kernel: CUDA
events around one call, the minimum of ``--reps`` runs after a warm-up (the
host's launch work included, as ``chip_smoke.py`` times), and the device
time of the kernel alone, the mean over ``--reps`` calls in a
``torch.profiler`` trace. Prints the card's name and power limit, then one
JSON line: per cell, A's and D's times and the route each launch took.

    python3 tools/fft_route_timing.py [--reps 10]

It times the ``noisereduce_tpu_torch`` that Python imports first. To time
another checkout of the package beside this one (a parent commit unpacked
with ``git archive`` into an ignored directory), put that checkout first
on ``PYTHONPATH``; run the two in turns (A, B, B, A) on one card. Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT))  # this tree's package, after PYTHONPATH's

CELLS = (  # name, n_fft, hop, seconds
    ("headline n_fft 1024, 960 s", 1024, 256, 960),
    ("n_fft 1536, 60 s", 1536, 384, 60),
    ("n_fft 1536, 960 s", 1536, 384, 960),
    ("n_fft 400, 960 s", 400, 100, 960),
    ("n_fft 1100, 60 s", 1100, 275, 60),  # the product route
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import noisereduce_tpu_torch
    # this tree's chip_smoke.py for the helpers and inputs, whichever
    # package PYTHONPATH puts first
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    CHUNK, NOISE_SECONDS, PADDING, SR = cs.CHUNK, cs.NOISE_SECONDS, cs.PADDING, cs.SR
    card_line, headline_signal, noise_clip, time_ms = (
        cs.card_line, cs.headline_signal, cs.noise_clip, cs.time_ms)

    def device_ms(fn, reps):  # the device time of one call's kernels, ms
        return sum(cs.device_ms(fn, reps).values())

    from noisereduce_tpu_torch.config import StftConfig
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry

    print(card_line(), flush=True)
    x = torch.as_tensor(headline_signal(960)).cuda()
    out = {"package": str(pathlib.Path(noisereduce_tpu_torch.__file__).parent), "cells": {}}
    for name, n_fft, hop, secs in CELLS:
        xs = x[None, : secs * SR].contiguous()
        geo = gate_geometry(StftConfig(n_fft=n_fft, hop_length=hop), CHUNK + 2 * PADDING)
        a = (xs, geo, CHUNK, PADDING)
        K.reset_launch_counts()
        re, im = K.spectra(*a)
        mask = torch.rand(re.shape, generator=torch.Generator("cuda").manual_seed(0),
                          device=re.device)
        d = (re, im, mask, geo, PADDING, CHUNK)
        K.istft_ola(*d)
        routes = K.route_counts()
        out["cells"][name] = dict(
            frames=re.shape[0] * re.shape[1],
            spectra_ms=time_ms(lambda: K.spectra(*a), args.reps),
            istft_ola_ms=time_ms(lambda: K.istft_ola(*d), args.reps),
            spectra_device_ms=device_ms(lambda: K.spectra(*a), args.reps),
            istft_ola_device_ms=device_ms(lambda: K.istft_ola(*d), args.reps),
            routes={k: max(v, key=v.get) for k, v in routes.items()},
        )
        del re, im, mask
        torch.cuda.empty_cache()
    noise = torch.as_tensor(noise_clip(NOISE_SECONDS)).cuda()[None]
    an = (noise, gate_geometry(StftConfig(n_fft=1024, hop_length=256), noise.shape[-1]))
    out["noise_row"] = dict(spectra_ms=time_ms(lambda: K.spectra(*an), args.reps),
                            spectra_device_ms=device_ms(lambda: K.spectra(*an), args.reps))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
