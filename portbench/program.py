"""The system under test, as the benchmark builds it: ``noisereduce_tpu_torch``'s
public ``TPUGate``, and the port's launch counters that a traced run checks
its trace against. The timed entries into it are the kinds' own
(``kinds/<kind>.py``), so a test can break the timed path underneath a
whole run by replacing one of them.
"""
from __future__ import annotations

import os


def build(config: dict, device):
    """The configuration's ``TPUGate`` on ``device``, with the port's
    cotangent precision set as the configuration states."""
    os.environ["NRTPU_COTANGENT_PRECISION"] = config["cotangent_precision"]
    from noisereduce_tpu_torch import TPUGate

    return TPUGate(**config["gate"]).to(device)


def launches(wrappers) -> dict:
    """{wrapper: (calls, CUDA launches)} the program counted since
    ``reset_launches``, for each kernel wrapper named in ``wrappers`` (a
    mask kernel runs several CUDA launches a call: ``cuda_launches``)."""
    from noisereduce_tpu_torch.ops.cuda import kernels as K

    out = {}
    for name in wrappers:
        fn = getattr(K, name)
        out[name] = (fn.launches, fn.launches * max(1, getattr(fn, "cuda_launches", 1)))
    return out


def reset_launches() -> None:
    from noisereduce_tpu_torch.ops.cuda import kernels as K

    K.reset_launch_counts()
