"""noisereduce_tpu_torch: the PyTorch / CUDA port of noisereduce_tpu.

Spectral-gating noise reduction with hand-written Hopper kernels
(``ops/cuda``): ``reduce_noise`` with the scipy-convention engines
(non-stationary and stationary) and the torch-convention gate
(``use_torch=True``), ``reduce_noise_batch``, and ``TPUGate``, the
TorchGate module, differentiable. The JAX package
``noisereduce_tpu`` is its reference. Importing this
package needs torch only: no JAX, no CUDA toolkit (kernels build at first
use on a card).
"""
from noisereduce_tpu_torch.api import reduce_noise, reduce_noise_batch
from noisereduce_tpu_torch.config import Convention, GateConfig, StftConfig
from noisereduce_tpu_torch.models.tpu_gate import TPUGate

__all__ = [
    "reduce_noise", "reduce_noise_batch", "TPUGate", "GateConfig", "StftConfig",
    "Convention",
]
