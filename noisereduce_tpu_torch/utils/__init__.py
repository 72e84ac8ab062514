from noisereduce_tpu_torch.utils.audio import float32_to_int16, int16_to_float32
from noisereduce_tpu_torch.utils.noise import (
    band_limited_noise,
    band_limited_noise_torch,
    fftnoise,
)
