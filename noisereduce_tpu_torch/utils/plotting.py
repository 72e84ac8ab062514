"""Matplotlib debug views of the gating pipeline (the port's own copy of
``noisereduce_tpu/utils/plotting.py``: numpy and matplotlib only, the
latter imported at the first plot, so importing this module needs neither
a display nor matplotlib; pass tensors as ``t.cpu().numpy()``).

Same *role and call signatures* as the reference's debug module
(noisereduce/plotting.py:5-61 — the caller passes pipeline intermediates;
nothing is wired into the main path), re-implemented in this project's own
idiom: one shared heatmap helper, labeled axes, diverging-safe symmetric
color scaling, and every function returns its Figure so callers can save or
embed instead of relying on an interactive backend (``show=True`` restores
the reference's blocking behavior).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _heatmap(ax, fig, data: np.ndarray, title: str, cmap: str = "magma"):
    """Time-frequency heatmap with symmetric limits and labeled axes."""
    data = np.asarray(data)
    lim = float(np.max(np.abs(data))) or 1.0
    im = ax.imshow(
        data,
        origin="lower",
        aspect="auto",
        interpolation="nearest",
        cmap=cmap,
        vmin=-lim,
        vmax=lim,
    )
    fig.colorbar(im, ax=ax, fraction=0.046)
    ax.set_xlabel("frame")
    ax.set_ylabel("frequency bin")
    ax.set_title(title)
    return im


def plot_spectrogram(signal, title, show: bool = True):
    """Single spectrogram/mask heatmap. Returns the Figure."""
    import matplotlib.pyplot as plt  # lazy: matplotlib optional at runtime

    fig, ax = plt.subplots(figsize=(12, 3.5), constrained_layout=True)
    _heatmap(ax, fig, signal, title)
    if show:
        plt.show()
    return fig


def plot_statistics_and_filter(
    mean_freq_noise, std_freq_noise, noise_thresh, smoothing_filter,
    show: bool = True,
):
    """Per-frequency noise statistics next to the mask-smoothing kernel.
    Returns the Figure."""
    import matplotlib.pyplot as plt

    fig, (ax_stats, ax_kern) = plt.subplots(
        ncols=2, figsize=(12, 3.5), constrained_layout=True,
        gridspec_kw={"width_ratios": [2, 1]},
    )
    bins = np.arange(len(np.asarray(mean_freq_noise)))
    ax_stats.plot(bins, np.asarray(mean_freq_noise), label="noise mean (dB)")
    ax_stats.plot(bins, np.asarray(std_freq_noise), label="noise std (dB)")
    ax_stats.plot(
        bins, np.asarray(noise_thresh), linestyle="--",
        label="gate threshold",
    )
    ax_stats.set_xlabel("frequency bin")
    ax_stats.set_ylabel("dB")
    ax_stats.set_title("Stationary noise statistics")
    ax_stats.legend(loc="best")

    kern = np.asarray(smoothing_filter)
    im = ax_kern.imshow(kern, origin="lower", interpolation="nearest")
    fig.colorbar(im, ax=ax_kern, fraction=0.046)
    ax_kern.set_xlabel("time taps")
    ax_kern.set_ylabel("frequency taps")
    ax_kern.set_title("Mask smoothing kernel")
    if show:
        plt.show()
    return fig


def plot_reduction_steps(
    noise_stft_db,
    mean_freq_noise,
    std_freq_noise,
    noise_thresh,
    smoothing_filter,
    sig_stft_db,
    sig_mask,
    recovered_spec,
    show: bool = True,
):
    """Every stage of the stationary gate on one multi-panel Figure
    (the reference renders five separate windows). Returns the Figure."""
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(14, 12), constrained_layout=True)
    grid = fig.add_gridspec(4, 2)

    _heatmap(fig.add_subplot(grid[0, 0]), fig, noise_stft_db, "Noise STFT (dB)")
    _heatmap(fig.add_subplot(grid[0, 1]), fig, sig_stft_db, "Signal STFT (dB)")

    ax_stats = fig.add_subplot(grid[1, 0])
    bins = np.arange(len(np.asarray(mean_freq_noise)))
    ax_stats.plot(bins, np.asarray(mean_freq_noise), label="noise mean")
    ax_stats.plot(bins, np.asarray(std_freq_noise), label="noise std")
    ax_stats.plot(bins, np.asarray(noise_thresh), "--", label="threshold")
    ax_stats.set_title("Noise statistics")
    ax_stats.set_xlabel("frequency bin")
    ax_stats.legend(loc="best")

    ax_kern = fig.add_subplot(grid[1, 1])
    im = ax_kern.imshow(
        np.asarray(smoothing_filter), origin="lower", interpolation="nearest"
    )
    fig.colorbar(im, ax=ax_kern, fraction=0.046)
    ax_kern.set_title("Smoothing kernel")

    _heatmap(fig.add_subplot(grid[2, :]), fig, sig_mask, "Gate mask")
    _heatmap(
        fig.add_subplot(grid[3, :]), fig, recovered_spec,
        "Recovered spectrogram (dB)",
    )
    if show:
        plt.show()
    return fig
