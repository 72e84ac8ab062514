"""Band-limited noise generation (counterpart of
``noisereduce_tpu/utils/noise.py``; reference noisereduce/generate_noise.py).

Two variants:
  - ``band_limited_noise``: NumPy, global-RNG, signature-compatible with
    the reference test utility (generate_noise.py:16-20);
  - ``band_limited_noise_torch``: the counterpart of
    ``band_limited_noise_jax``, its phases drawn from a ``torch.Generator``
    (reproducible, on the generator's device).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["fftnoise", "band_limited_noise", "band_limited_noise_torch"]


def fftnoise(f):
    """Random-phase noise with the given (Hermitian-symmetrized) magnitude
    spectrum.

    The classic spectrum-shaping recipe (https://stackoverflow.com/a/36564667,
    which the reference utility, generate_noise.py:4-13, also credits). The
    positive-frequency bins get unit-modulus phases from ONE
    ``np.random.rand`` draw of (len-1)//2 values on the global NumPy RNG,
    the reference's draw order, so seeded workloads give the same noise.
    """
    spec = np.asarray(f, dtype=complex).copy()
    n_pos = (spec.shape[0] - 1) // 2
    theta = np.random.rand(n_pos) * 2 * np.pi
    spec[1 : n_pos + 1] *= np.cos(theta) + 1j * np.sin(theta)
    # negative-frequency bins mirror the rotated positive bins so the
    # inverse transform is real up to rounding
    spec[-1 : -1 - n_pos : -1] = spec[1 : n_pos + 1].conj()
    return np.fft.ifft(spec).real


def band_limited_noise(min_freq, max_freq, samples=1024, samplerate=1):
    """Flat-spectrum noise limited to [min_freq, max_freq] Hz
    (generate_noise.py:16-20)."""
    freqs = np.abs(np.fft.fftfreq(samples, 1 / samplerate))
    f = np.zeros(samples)
    f[np.logical_and(freqs >= min_freq, freqs <= max_freq)] = 1
    return fftnoise(f)


def band_limited_noise_torch(min_freq, max_freq, samples=1024, samplerate=1,
                             generator=None, dtype=torch.float32):
    """Band-limited noise with ``band_limited_noise_jax``'s spectrum shaping,
    its (samples-1)//2 phases from ``torch.rand`` on ``generator`` (the
    default generator for None), on the generator's device. Returns a real
    (samples,) tensor of ``dtype`` (float32 or float64)."""
    device = generator.device if generator is not None else torch.device("cpu")
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    freqs = torch.fft.fftfreq(samples, 1 / samplerate, dtype=dtype, device=device).abs()
    f = ((freqs >= min_freq) & (freqs <= max_freq)).to(cdtype)
    n_p = (samples - 1) // 2
    phases = torch.rand(n_p, generator=generator, dtype=dtype, device=device) * 2 * np.pi
    f[1 : n_p + 1] *= torch.polar(torch.ones_like(phases), phases)
    f[samples - n_p :] = f[1 : n_p + 1].conj().flip(0)
    return torch.fft.ifft(f).real
