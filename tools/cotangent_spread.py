#!/usr/bin/env python3
"""How far the default (bf16) cotangent lands from the uncast one, in the
port and in the JAX package, on the same inputs, on the CPU.

    python3 tools/cotangent_spread.py --batch 4 32

For each batch of 4 s clips at 16 kHz (``np.random.default_rng(0)``
signals and cotangents), the scipy-convention non-stationary twin
(``_gate_nonstationary_staged`` in the port, ``_gate_nonstationary_jnp``
with "matmul" in the JAX package) is pulled back through each package's
``cotangent_vjp`` with the card (the TPU) reported, once in mode ``bf16``
and once uncast (``highest`` / ``high``). Prints, for each package, max|dev|
/ max|ref|, the 99.99th percentile of |dev| / max|ref| and ||dev|| /
||ref||, and the two uncast cotangents against each other. Needs both
packages; JAX runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

SR, SECONDS = 16000, 4


def spread(cast: np.ndarray, ref: np.ndarray) -> str:
    d = np.abs(cast.astype(np.float64) - ref)
    scale = np.abs(ref).max()
    return (f"max|dev|/max|ref| {d.max() / scale:.3e}, p99.99 {np.quantile(d, 0.9999) / scale:.3e}, "
            f"||dev||/||ref|| {np.linalg.norm(d) / np.linalg.norm(ref):.3e}")


def with_mode(mode: str, fn):
    prev = os.environ.get("NRTPU_COTANGENT_PRECISION")
    os.environ["NRTPU_COTANGENT_PRECISION"] = mode
    try:
        return fn()
    finally:
        if prev is None:
            os.environ.pop("NRTPU_COTANGENT_PRECISION", None)
        else:
            os.environ["NRTPU_COTANGENT_PRECISION"] = prev


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[4])
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")

    from noisereduce_tpu.config import GateConfig as JGateConfig
    from noisereduce_tpu.models import spectral_gate as jsg
    from noisereduce_tpu.ops import precision as jprecision

    from noisereduce_tpu_torch.config import GateConfig
    from noisereduce_tpu_torch.models.spectral_gate import _gate_nonstationary_staged
    from noisereduce_tpu_torch.ops import precision

    cfg, jcfg = GateConfig(sr=SR), JGateConfig(sr=SR)
    precision._on_card = lambda primals: True  # the card reported
    jsg._tpu_available = lambda: True  # the TPU reported

    def port(x, g):
        (out,) = precision.cotangent_vjp(lambda a: _gate_nonstationary_staged(a, cfg),
                                         (torch.as_tensor(x),), torch.as_tensor(g))
        return out.numpy()

    def jax_(x, g):
        (out,) = jprecision.cotangent_vjp(
            lambda a: jsg._gate_nonstationary_jnp(a, jcfg, "matmul"), (jnp.asarray(x),),
            jnp.asarray(g))
        return np.asarray(out)

    for batch in args.batch:
        rng = np.random.default_rng(0)
        x = rng.standard_normal((batch, SR * SECONDS)).astype(np.float32)
        g = rng.standard_normal((batch, SR * SECONDS)).astype(np.float32)
        p_ref = with_mode("highest", lambda: port(x, g))
        p_cast = with_mode("bf16", lambda: port(x, g))
        j_ref = with_mode("high", lambda: jax_(x, g))
        j_cast = with_mode("bf16", lambda: jax_(x, g))
        print(f"batch {batch} x {SECONDS} s @ {SR} Hz (CPU):", flush=True)
        print(f"  port bf16 vs highest: {spread(p_cast, p_ref)}", flush=True)
        print(f"  JAX  bf16 vs high:    {spread(j_cast, j_ref)}", flush=True)
        print(f"  uncast, JAX vs port:  {spread(j_ref, p_ref)}", flush=True)


if __name__ == "__main__":
    main()
