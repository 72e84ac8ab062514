"""Plain-torch DSP ops (``stft``, ``dsp``) and the CUDA kernels (``cuda``)."""
