"""noisereduce_tpu_torch: the PyTorch / CUDA port of noisereduce_tpu.

Spectral-gating noise reduction with hand-written Hopper kernels
(``ops/cuda``): ``reduce_noise`` with the scipy-convention engines
(non-stationary and stationary) and ``reduce_noise_batch``. The JAX package
``noisereduce_tpu`` is its reference. Importing this
package needs torch only: no JAX, no CUDA toolkit (kernels build at first
use on a card).
"""
from noisereduce_tpu_torch.api import reduce_noise, reduce_noise_batch
from noisereduce_tpu_torch.config import Convention, GateConfig, StftConfig

__all__ = ["reduce_noise", "reduce_noise_batch", "GateConfig", "StftConfig", "Convention"]
