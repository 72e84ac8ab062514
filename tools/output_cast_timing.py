#!/usr/bin/env python3
"""Kernel H (``output_cast``) alone on one CUDA card, beside
``tensor.to``, the PyTorch call that moves the same bytes.

    python3 tools/output_cast_timing.py [--dtypes int16,uint8,int32,float16]

For each caller dtype: the int16 headline's output shape (46,080,000
float32 outputs, ``chip_smoke.HEADLINE_SECONDS`` at 48 kHz) in its 4
pieces' buffers of 20 chunks, the last cut to the signal's length, as
``parallel/transfer.py::PinnedCores.put`` hands them over
(``chip_smoke.piece_views``), then the whole
output in one launch: CUDA events around the calls (min of 10 after a
warm-up, the host's launch work included), the device time of the 4
launches from a ``torch.profiler`` trace (mean of 5), both beside
``tensor.to(dtype)`` on the same tensors, and the bytes bound (each input
read once, each output written once, over 3.35 TB/s). Then the values of
kernel H, ``tensor.to`` and numpy's ``astype`` at the edges where CUDA's
clamping conversion and numpy's x86 cast part (past int32's range, at
+-inf and NaN). The inputs come from a seed. Needs one card; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from noisereduce_tpu_torch.ops.cuda import build  # noqa: E402
from noisereduce_tpu_torch.ops.cuda import kernels as K  # noqa: E402

EDGES = [40000.5, -40000.7, 3e9, -3e9, float("inf"), float("-inf"), float("nan"), 1e10, 255.5,
         -1.5]


def device_of(fn, reps: int = 5) -> float:
    """Device ms of every kernel ``fn`` launches, a mean over ``reps``
    calls of a ``torch.profiler`` trace after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps / 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtypes", default="int16,uint8,int32,float16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs one CUDA card")
    card = cs.card_line()
    print(card, flush=True)
    build.load()
    n = cs.HEADLINE_SECONDS * cs.SR
    rng = np.random.default_rng(cs.SEED)
    y = torch.as_tensor((rng.standard_normal(n) * 2000).astype(np.float32)).cuda()[None]
    pieces = cs.piece_views(y)
    for name in args.dtypes.split(","):
        dt = getattr(torch, name)
        moved = n * (4 + dt.itemsize)
        bound_ms = moved / cs.HBM_BYTES_PER_S * 1e3
        calls = {
            "kernel H, 4 launches": lambda: [K.output_cast(p, dt) for p in pieces],
            "tensor.to, 4 calls": lambda: [p.to(dt) for p in pieces],
            "kernel H, one launch": lambda: K.output_cast(y, dt),
            "tensor.to, one call": lambda: y.to(dt),
        }
        events = {k: cs.time_ms(fn, 10) for k, fn in calls.items()}
        h_dev = device_of(calls["kernel H, 4 launches"])
        to_dev = device_of(calls["tensor.to, 4 calls"])
        print(f"output_cast to {name}: {n} outputs, {moved / 1e6:.1f} MB moved, bound "
              f"{bound_ms:.4f} ms (bytes); device ms of the 4 launches: kernel H {h_dev:.4f} "
              f"({h_dev / bound_ms:.2f}x the bound), tensor.to {to_dev:.4f}; events ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in events.items()) + f"; on {card}",
              flush=True)
    probe = torch.tensor([EDGES], device="cuda")
    for name in ("int16", "int32", "uint16", "uint8", "int8"):
        dt, n_dt = getattr(torch, name), getattr(np, name)
        got = {way: t.cpu().view(torch.uint8).numpy().view(n_dt)[0].tolist()
               for way, t in (("kernel H", K.output_cast(probe, dt)), ("tensor.to", probe.to(dt)))}
        with np.errstate(invalid="ignore", over="ignore"):
            got["numpy"] = probe.cpu().numpy().astype(n_dt)[0].tolist()
        print(f"{name} at {EDGES}: " + "; ".join(f"{k} {v}" for k, v in got.items()),
              flush=True)


if __name__ == "__main__":
    main()
