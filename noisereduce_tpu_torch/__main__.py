"""CLI: denoise WAV files from the command line (counterpart of
``noisereduce_tpu/__main__.py``).

    python -m noisereduce_tpu_torch input.wav output.wav [--stationary] [options]

Drives the streaming file pipeline (``streaming.reduce_noise_file``) over
the package's native IO runtime, on the CUDA card by default; ``--device
cpu`` runs the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="noisereduce_tpu_torch",
        description="Spectral-gating noise reduction for WAV files on a CUDA card",
    )
    p.add_argument("input", help="input WAV file")
    p.add_argument("output", help="output WAV file")
    p.add_argument("--stationary", action="store_true",
                   help="stationary gating (default: non-stationary)")
    p.add_argument("--noise", metavar="WAV",
                   help="noise clip WAV for stationary statistics; implies "
                        "--stationary (the non-stationary gate estimates its "
                        "own floor and ignores a noise clip)")
    p.add_argument("--prop-decrease", type=float, default=1.0)
    p.add_argument("--time-constant-s", type=float, default=2.0)
    p.add_argument("--freq-mask-smooth-hz", type=float, default=500)
    p.add_argument("--time-mask-smooth-ms", type=float, default=50)
    p.add_argument("--thresh-n-mult", type=float, default=2,
                   help="non-stationary threshold multiplier")
    p.add_argument("--sigmoid-slope", type=float, default=10)
    p.add_argument("--n-std-thresh", type=float, default=1.5,
                   help="stationary threshold std multiplier")
    p.add_argument("--chunk-size", type=int, default=600000)
    p.add_argument("--padding", type=int, default=30000)
    p.add_argument("--n-fft", type=int, default=1024)
    p.add_argument("--win-length", type=int, default=None)
    p.add_argument("--hop-length", type=int, default=None)
    p.add_argument("--no-clip-noise", action="store_false",
                   dest="clip_noise_stationary",
                   help="stationary self-noise statistics over the ENTIRE "
                        "recording (two streamed passes) instead of the "
                        "first chunk (clip_noise_stationary=False)")
    p.add_argument("--progress", action="store_true", dest="use_tqdm",
                   help="tqdm progress bar over chunks")
    p.add_argument("--torch-convention", action="store_true", dest="use_torch",
                   help="use the torch-convention gate (TPUGate semantics)")
    p.add_argument("--float", action="store_true", dest="as_float",
                   help="write IEEE-float WAV instead of PCM16")
    p.add_argument("--device", default="cuda",
                   help="torch device to gate on (default cuda, which fails "
                        "where CUDA is absent; cpu runs the plain versions)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from noisereduce_tpu_torch.streaming import reduce_noise_file
    from noisereduce_tpu_torch.utils import io as nrio

    y_noise = None
    if args.noise:
        _, y_noise = nrio.read_wav(args.noise, dtype="float32")
        if y_noise.ndim == 2:
            y_noise = y_noise.T
        if not args.stationary and not args.quiet:
            print(
                "note: --noise implies --stationary (the non-stationary "
                "gate ignores a noise clip)",
                file=sys.stderr,
            )

    t0 = time.perf_counter()
    frames = reduce_noise_file(
        args.input,
        args.output,
        stationary=args.stationary or args.noise is not None,
        y_noise=y_noise,
        prop_decrease=args.prop_decrease,
        time_constant_s=args.time_constant_s,
        freq_mask_smooth_hz=args.freq_mask_smooth_hz,
        time_mask_smooth_ms=args.time_mask_smooth_ms,
        thresh_n_mult_nonstationary=args.thresh_n_mult,
        sigmoid_slope_nonstationary=args.sigmoid_slope,
        n_std_thresh_stationary=args.n_std_thresh,
        chunk_size=args.chunk_size,
        padding=args.padding,
        n_fft=args.n_fft,
        win_length=args.win_length,
        hop_length=args.hop_length,
        clip_noise_stationary=args.clip_noise_stationary,
        as_float=args.as_float,
        use_tqdm=args.use_tqdm,
        use_torch=args.use_torch,
        device=args.device,
    )
    dt = time.perf_counter() - t0
    if not args.quiet:
        sr, _, _ = nrio.wav_info(args.input)
        audio_s = frames / sr
        print(
            f"{args.input} -> {args.output}: {frames} frames "
            f"({audio_s:.1f}s audio) in {dt:.2f}s ({audio_s / dt:.0f}x real-time)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
