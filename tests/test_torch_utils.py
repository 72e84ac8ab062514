"""PyTorch port: the plotting and profiling utilities
(``noisereduce_tpu_torch/utils/plotting.py`` and ``profiling.py``), the
counterparts of tests/test_utils.py's plotting smoke and ``measure_rtf``
check, and the ``torch.profiler`` trace writing its file (CPU)."""
import numpy as np
import pytest
import torch

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.utils.profiling import measure_rtf, trace

torch.set_num_threads(2)


def test_plotting_smoke():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from noisereduce_tpu_torch.utils.plotting import (
        plot_reduction_steps,
        plot_spectrogram,
        plot_statistics_and_filter,
    )

    rng = np.random.default_rng(0)
    spec = rng.standard_normal((64, 32))
    figs = [
        plot_spectrogram(spec, "test", show=False),
        plot_statistics_and_filter(
            rng.standard_normal(64), rng.standard_normal(64), rng.standard_normal(64),
            rng.uniform(0, 1, (11, 17)), show=False,
        ),
        plot_reduction_steps(
            spec, rng.standard_normal(64), rng.standard_normal(64),
            rng.standard_normal(64), rng.uniform(0, 1, (5, 5)),
            spec, np.abs(spec), spec, show=False,
        ),
    ]
    assert all(isinstance(f, matplotlib.figure.Figure) for f in figs)
    for f in figs:
        plt.close(f)


def test_measure_rtf_sane():
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(8000), dtype=torch.float32)
    assert measure_rtf(lambda a: a * 2.0, (x,), audio_seconds=1.0, iters=2) > 0
    y = np.random.default_rng(1).standard_normal(16000)
    rtf = measure_rtf(lambda a: nrt.reduce_noise(a, 16000, device="cpu"), (y,),
                      audio_seconds=1.0, iters=1)
    assert rtf > 0


def test_trace_writes_a_file(tmp_path):
    with trace(str(tmp_path / "tr")):
        nrt.reduce_noise(np.random.default_rng(2).standard_normal(8000), 16000, device="cpu")
    files = list((tmp_path / "tr").iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0
