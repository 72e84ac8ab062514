"""Plain-PyTorch TorchGate: the yardstick the benchmark holds the port to.

Written from the public ``TorchGate`` of noisereduce
(``noisereduce/torchgate/torchgate.py`` and ``torchgate/utils.py``): STFT
with a periodic Hann window, centred, zero padded; the non-stationary mask
as a sigmoid of the ratio to a 'same' moving average over time; the
stationary mask as dB above mean + n_std * std over time (ddof 1), the dB
floored 40 below each bin's maximum; the prop_decrease blend before the 2-D
triangular smoothing by ``conv2d``; the masked inverse STFT at its natural
length (T - 1) * hop.

It imports torch alone: nothing of the port, and nothing the port made.
Every constant (window, smoothing filter, moving-average kernel) is built
here from the configuration. Run it with TF32 off (``no_tf32``): cuDNN's
``conv2d`` may otherwise round the mask's inputs to 10 bits.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPS = torch.finfo(torch.float64).eps
TOP_DB = 40.0


@contextlib.contextmanager
def no_tf32():
    """Matmuls and convolutions in full float32 inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _linspace(start, stop, num, endpoint=True):
    if endpoint:
        return torch.linspace(start, stop, num, dtype=torch.float32)
    return torch.linspace(start, stop, num + 1, dtype=torch.float32)[:-1]


def smoothing_sizes(cfg: dict):
    """(n_grad_freq, n_grad_time) of the triangular mask smoother, or None."""
    if cfg["freq_mask_smooth_hz"] is None and cfg["time_mask_smooth_ms"] is None:
        return None
    n_grad_freq = (1 if cfg["freq_mask_smooth_hz"] is None
                   else int(cfg["freq_mask_smooth_hz"] / (cfg["sr"] / (cfg["n_fft"] / 2))))
    n_grad_time = (1 if cfg["time_mask_smooth_ms"] is None
                   else int(cfg["time_mask_smooth_ms"] / (cfg["hop_length"] / cfg["sr"] * 1000)))
    if n_grad_freq < 1 or n_grad_time < 1:
        raise ValueError("mask smoothing below one bin or one frame")
    if n_grad_freq == 1 and n_grad_time == 1:
        return None
    return n_grad_freq, n_grad_time


def smoothing_filter(cfg: dict):
    """(1, 1, 2 n_grad_freq + 1, 2 n_grad_time + 1) filter summing to 1, or None."""
    sizes = smoothing_sizes(cfg)
    if sizes is None:
        return None
    nf, nt = sizes
    v_f = torch.cat([_linspace(0, 1, nf + 1, endpoint=False), _linspace(1, 0, nf + 2)])[1:-1]
    v_t = torch.cat([_linspace(0, 1, nt + 1, endpoint=False), _linspace(1, 0, nt + 2)])[1:-1]
    filt = torch.outer(v_f, v_t)[None, None]
    return filt / filt.sum()


def amp_to_db(x):
    x_db = 20 * torch.log10(x.abs() + EPS)
    return torch.max(x_db, (x_db.max(-1).values - TOP_DB).unsqueeze(-1))


def _stft(x, cfg):
    win = torch.hann_window(cfg["win_length"], device=x.device, dtype=x.dtype)
    return torch.stft(x, n_fft=cfg["n_fft"], hop_length=cfg["hop_length"],
                      win_length=cfg["win_length"], window=win, center=True,
                      pad_mode="constant", return_complex=True)


def gate(x: torch.Tensor, cfg: dict, xn=None) -> torch.Tensor:
    """TorchGate(**cfg)(x, xn) for a (batch, samples) float32 ``x``:
    (batch, (T - 1) * hop) out. Differentiable in ``x``."""
    X = _stft(x, cfg)  # (batch, bins, frames)
    if cfg["nonstationary"]:
        X_abs = X.abs()
        n = cfg["n_movemean_nonstationary"]
        ones = torch.ones(n, dtype=X_abs.dtype, device=X_abs.device).view(1, 1, -1)
        smoothed = F.conv1d(X_abs.reshape(-1, 1, X_abs.shape[-1]), ones,
                            padding="same").view(X_abs.shape) / n
        ratio = (X_abs - smoothed) / smoothed
        mask = torch.sigmoid((ratio - cfg["n_thresh_nonstationary"])
                             / cfg["temp_coeff_nonstationary"])
    else:
        X_db = amp_to_db(X)
        XN_db = X_db if xn is None else amp_to_db(_stft(xn, cfg)).to(X_db.dtype)
        std, mean = torch.std_mean(XN_db, dim=-1)
        thresh = mean + std * cfg["n_std_thresh_stationary"]
        mask = X_db > thresh.unsqueeze(-1)
    mask = cfg["prop_decrease"] * (mask * 1.0 - 1.0) + 1.0
    filt = smoothing_filter(cfg)
    if filt is not None:
        mask = F.conv2d(mask.unsqueeze(1), filt.to(mask.device, mask.dtype),
                        padding="same").squeeze(1)
    win = torch.hann_window(cfg["win_length"], device=x.device, dtype=x.dtype)
    return torch.istft(X * mask, n_fft=cfg["n_fft"], hop_length=cfg["hop_length"],
                       win_length=cfg["win_length"], window=win, center=True)


def chunk_core(y2d: torch.Tensor, i: int, cfg: dict, chunk_size: int, padding: int):
    """noisereduce's chunked body for chunk ``i`` of every row of ``y2d``
    (rows, n): the view of samples [i cs - padding, (i + 1) cs + padding),
    zero outside the signal, gated, its natural-length deficit zero
    filled, and its core [padding, padding + cs) returned, cut at the
    signal's end."""
    rows, n = y2d.shape
    lo, hi = i * chunk_size - padding, (i + 1) * chunk_size + padding
    view = y2d.new_zeros(rows, hi - lo)
    a, b = max(lo, 0), min(hi, n)
    view[:, a - lo:b - lo] = y2d[:, a:b]
    out = gate(view, cfg)
    out = F.pad(out, (0, view.shape[-1] - out.shape[-1]))
    return out[:, padding:padding + min(chunk_size, n - i * chunk_size)]
