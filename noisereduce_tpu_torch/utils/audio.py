"""WAV dtype conversion utilities (counterpart of
``noisereduce_tpu/utils/audio.py``; reference noisereduce/utils.py:4-15).
NumPy only: a copy, since importing the JAX package's module imports JAX."""
from __future__ import annotations

import numpy as np

__all__ = ["int16_to_float32", "float32_to_int16"]

# int16 full scale: dividing by 2**15 maps the int16 range onto [-1, 1)
# exactly (a power-of-two scale, so the conversion is lossless in float32).
_FULL_SCALE = float(2**15)
_INT16_MAX = float(2**15 - 1)


def int16_to_float32(data):
    """int16-scaled waveform -> float32 in [-1, 1).

    Inputs whose peak magnitude exceeds the int16 full scale are rejected
    rather than silently wrapped/clipped.
    """
    data = np.asarray(data)
    peak = float(np.abs(data).max()) if data.size else 0.0
    if peak > _FULL_SCALE:
        raise ValueError(
            f"expected int16-scaled samples; peak magnitude {peak:g} "
            f"exceeds {int(_FULL_SCALE)}"
        )
    return (data / _FULL_SCALE).astype(np.float32)


def float32_to_int16(data):
    """float waveform -> int16 samples.

    Quirk kept from the reference converter: renormalization triggers on a
    *positive* peak above 1 (a signal whose only excursion past full scale
    is negative is left alone and wraps in the int16 cast), and the
    renormalization divides by the peak *magnitude*.
    """
    data = np.asarray(data)
    if data.size and float(data.max()) > 1.0:
        data = data / np.abs(data).max()
    return (data * _INT16_MAX).astype(np.int16)
