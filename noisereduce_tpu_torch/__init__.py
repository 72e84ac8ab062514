"""noisereduce_tpu_torch: the PyTorch / CUDA port of noisereduce_tpu.

Spectral-gating noise reduction with hand-written Hopper kernels
(``ops/cuda``): ``reduce_noise`` with the scipy-convention engines
(non-stationary and stationary) and the torch-convention gate
(``use_torch=True``), ``reduce_noise_batch``, ``TPUGate``, the TorchGate
module, differentiable, and the streaming entry points: ``reduce_noise_file``
(WAV to WAV, chunk by chunk, over the package's own native IO runtime),
``StreamingGate`` (block-fed real-time gate) and the command line
(``python -m noisereduce_tpu_torch in.wav out.wav``). The JAX package
``noisereduce_tpu`` is its reference. Importing this package needs torch
and numpy only: no JAX, no CUDA toolkit, no compiler (the kernels and the
IO library build at first use).
"""
from noisereduce_tpu_torch.api import reduce_noise, reduce_noise_batch
from noisereduce_tpu_torch.config import Convention, GateConfig, StftConfig
from noisereduce_tpu_torch.models.tpu_gate import TPUGate
from noisereduce_tpu_torch.streaming import StreamingGate, reduce_noise_file
from noisereduce_tpu_torch.utils.audio import float32_to_int16, int16_to_float32
from noisereduce_tpu_torch.utils.noise import (
    band_limited_noise,
    band_limited_noise_torch,
    fftnoise,
)

# Single-sourced from the installed distribution's metadata (pyproject.toml).
# The literal fallback covers uninstalled source checkouts and is pinned ==
# pyproject.toml by tests/test_torch_io.py::test_version_single_source.
try:
    from importlib.metadata import PackageNotFoundError as _PkgNotFound
    from importlib.metadata import version as _dist_version

    __version__ = _dist_version("noisereduce-tpu")
except _PkgNotFound:  # running from a source checkout
    __version__ = "0.5.0"

__all__ = [
    "reduce_noise",
    "reduce_noise_batch",
    "reduce_noise_file",
    "StreamingGate",
    "TPUGate",
    "GateConfig",
    "StftConfig",
    "Convention",
    "band_limited_noise",
    "band_limited_noise_torch",
    "fftnoise",
    "int16_to_float32",
    "float32_to_int16",
    "__version__",
]
