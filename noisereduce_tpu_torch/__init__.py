"""noisereduce_tpu_torch: the PyTorch / CUDA port of noisereduce_tpu.

Spectral-gating noise reduction with hand-written Hopper kernels
(``ops/cuda``). This slice ports the non-stationary ``reduce_noise`` main
path; the JAX package ``noisereduce_tpu`` is its reference. Importing this
package needs torch only: no JAX, no CUDA toolkit (kernels build at first
use on a card).
"""
from noisereduce_tpu_torch.api import reduce_noise
from noisereduce_tpu_torch.config import Convention, GateConfig, StftConfig

__all__ = ["reduce_noise", "GateConfig", "StftConfig", "Convention"]
