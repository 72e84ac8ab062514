#!/usr/bin/env python3
"""Hold the float32 builds of kernels A-G, and the bfloat16 builds of A, B,
D, E and F, to another tree's, bit for bit, on one CUDA card.

    python3 tools/kernel_bitwise.py --save OUT.pt
    python3 tools/kernel_bitwise.py --compare OLD.pt NEW.pt

``--save`` runs each kernel's float32 build on inputs drawn from a seed and
writes every output (torch.save): A and D on each of their routes (n_fft
1024, the power-of-two real-FFT kernel; 1536, the mixed-radix one; 1100,
the complex-frame kernels; 1323, odd, two frames a transform; 1102, the
large radices 19 and 29 (the chirp-z route before them); 1101, the
chirp-z route; 8580, 5005 and 4106, the big block; 16384, 16380, 12000
and 4851, the cluster route on 2 and 3 blocks (the big block before
it); 40, the real-FFT kernels' 204-frame tiles (the DFT products before
them, so a parent's outputs differ there); 40000, 32768 and 19683, the cluster
route; 4803, the cluster chirp route; 441, odd, and 37, the chirp at L =
81; 40005, 65538 and 192000, the global chirp route, one view a row of
reduce_noise's 600,000-sample chunk), in both STFT conventions, over 3
halo'd chunk views of 2 signal rows; B with the headline's 19 time taps,
one unit tap and 801 (its separate smoothing launch); E with a clip's
threshold and with each view's own statistics, each with the 19 taps, one
unit tap and 801; F at n_movemean 375 and 374; C at 11 taps; G on both
of its routes. The bfloat16 builds ("bf16" in the key) on the same
inputs cast to bfloat16: A of the signal and D of A's float32 planes on
every route and convention (the float32 mask), B, E and F on the n_fft
1024 planes, in the same cases. ``--compare`` prints, for each output,
whether the two runs are bitwise equal and their largest difference,
absolute and as a share of the old output's max|value|, and exits 1 if
any differs. The
``noisereduce_tpu_torch`` run is the one Python imports first: put a
parent checkout (``git archive`` into an ignored directory) first on
``PYTHONPATH`` to save the parent's. Calls only wrapper signatures that
the trees share (bfloat16 planes since the bf16 mode). Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT))  # this tree's package, after PYTHONPATH's

SEED = 20261017
SR, CHUNK, PADDING, N = 48000, 120000, 12000, 330000  # 3 views a row
# (label, STFT keywords, sample rate)
GEOMETRIES = (
    ("n_fft 1024", dict(n_fft=1024, hop_length=256), SR),
    ("n_fft 1536", dict(n_fft=1536, hop_length=384), SR),
    ("n_fft 1100", dict(n_fft=1100, hop_length=275), SR),
    ("n_fft 1323", dict(n_fft=1323, hop_length=441), 44100),
    ("n_fft 1102", dict(n_fft=1102, hop_length=551), 44100),
    ("n_fft 1101", dict(n_fft=1101, hop_length=367), 44100),
    # the big block: n = 4290, odd 5005 (two frames a slot), and the chirp
    # length 8192 (4106); n = 8192, 8190, 6000 and odd 4851 on the cluster
    # route's 2 and 3 blocks (the big block before it, so a parent's
    # outputs differ there)
    ("n_fft 8580", dict(n_fft=8580, hop_length=2145), SR),
    ("n_fft 5005", dict(n_fft=5005, hop_length=1001), 44100),
    ("n_fft 4106", dict(n_fft=4106, hop_length=2053), SR),
    ("n_fft 16380", dict(n_fft=16380, hop_length=4095), SR),
    ("n_fft 16384", dict(n_fft=16384, hop_length=4096), SR),
    ("n_fft 12000", dict(n_fft=12000, hop_length=3000), SR),
    ("n_fft 4851", dict(n_fft=4851, hop_length=1617), 44100),
    # frames of 5 ms at 8 kHz: the real-FFT kernels, 204 frames a tile and a
    # group (the DFT products before them, so a parent's outputs differ there)
    ("n_fft 40", dict(n_fft=40, hop_length=10), 8000),
    # the cluster route: 4, 2 and 3 blocks (19683 odd, two frames a slot)
    ("n_fft 40000", dict(n_fft=40000, hop_length=10000), SR),
    ("n_fft 32768", dict(n_fft=32768, hop_length=8192), SR),
    ("n_fft 19683", dict(n_fft=19683, hop_length=6561), 44100),
    # the cluster chirp route: 4803 = 3 x 1601, chirp length 9720 on 2 blocks
    # (the product route before it, so a parent's outputs differ there)
    ("n_fft 4803", dict(n_fft=4803, hop_length=1601), SR),
    # the complex-frame kernels' odd 441 = 3^2 7^2 and the chirp at odd
    # prime 37 (L = 81, hop 1, at 8 kHz)
    ("n_fft 441", dict(n_fft=441, hop_length=147), 44100),
    ("n_fft 37", dict(n_fft=37, hop_length=1), 8000),
    # the global chirp route, each row one view of LONG_CHUNK samples:
    # odd 40005 (L = 81,000), even 65538 (n = 32,769) and 192000 (n =
    # 96,000, L = 192,000)
    ("n_fft 40005", dict(n_fft=40005, hop_length=8001), SR, "long"),
    ("n_fft 65538", dict(n_fft=65538, hop_length=21846), SR, "long"),
    ("n_fft 192000", dict(n_fft=192000, hop_length=48000), SR, "long"),
)
# the global chirp route's views: reduce_noise's chunk and padding
LONG_CHUNK, LONG_PADDING = 600000, 30000


def run() -> dict:
    from noisereduce_tpu_torch.config import GateConfig, StftConfig
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.dsp import tri_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((2, N), generator=gen, device="cuda")
    bf = torch.bfloat16
    out = {}
    for label, kw, sr, *long in GEOMETRIES:
        cs, pad = (LONG_CHUNK, LONG_PADDING) if long else (CHUNK, PADDING)
        for conv, extra in (("scipy", {}), ("torch", dict(convention="torch",
                                                          quantize_window_f32=True))):
            geo = gate_geometry(StftConfig(**kw, **extra), cs + 2 * pad)
            re, im = K.spectra(x, geo, cs, pad)
            mask = torch.rand(re.shape, generator=gen, device="cuda")
            out[f"A {label} {conv}"] = torch.stack([re, im])
            out[f"D {label} {conv}"] = K.istft_ola(re, im, mask, geo, pad, cs)
            out[f"A bf16 {label} {conv}"] = torch.stack(K.spectra(x.to(bf), geo, cs, pad))
            out[f"D bf16 {label} {conv}"] = K.istft_ola(re.to(bf), im.to(bf), mask, geo, pad, cs)

    cfg = GateConfig(sr=SR)
    geo = gate_geometry(cfg.stft, CHUNK + 2 * PADDING)
    re, im = K.spectra(x, geo, CHUNK, PADDING)
    b = (cfg.iir_b, cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary)
    thr = torch.randn(geo.n_bins, generator=gen, device="cuda") * 10 - 40
    for kind, (zr, zi) in (("", (re, im)), ("bf16 ", (re.to(bf), im.to(bf)))):
        for taps in (9, 0, 400):
            tt = tri_norm(taps)
            n = 2 * taps + 1
            out[f"B {kind}{n} taps"] = K.nonstationary_mask(zr, zi, *b, tt)
            out[f"E {kind}threshold, {n} taps"] = K.stationary_mask(zr, zi, thr, 1, 0.8, tt)
            out[f"E {kind}own statistics, {n} taps"] = K.stationary_mask(
                zr, zi, None, 1, 0.8, tt, top_db=40.0, n_std=1.5)
        for n in (375, 374):
            out[f"F {kind}n_movemean {n}"] = K.torch_nonstationary_mask(zr, zi, n, 1.3, 0.1,
                                                                        0.8, tri_norm(9))
    out["C 11 taps"] = K.freq_smooth_blend(out["B 19 taps"], tri_norm(5), 0.8)
    z = torch.complex(re, im).transpose(1, 2).contiguous()
    out["G resident"] = K.fm_nonstationary_mask(z, *b)
    out["G tiled"] = K._fm_mask_on("tiled", z, *b)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def compare(old: dict, new: dict) -> bool:
    same_all = set(old) == set(new)
    for k in sorted(set(old) | set(new)):
        if k not in old or k not in new:
            print(f"{k}: only in {'new' if k in new else 'old'}")
            continue
        same = old[k].dtype == new[k].dtype and torch.equal(old[k], new[k])
        dev = float((old[k].double() - new[k].double()).abs().max())
        scale = float(old[k].double().abs().max()) or 1.0
        print(f"{k}: bitwise {same}, max|difference| {dev:.3e} ({dev / scale:.3e} x max|old|)")
        same_all &= same
    print(f"all outputs bitwise equal: {same_all}")
    return same_all


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save", metavar="OUT")
    ap.add_argument("--compare", nargs=2, metavar=("OLD", "NEW"))
    args = ap.parse_args()
    if args.compare:
        sys.exit(0 if compare(*(torch.load(p) for p in args.compare)) else 1)
    if not torch.cuda.is_available():
        sys.exit("tools/kernel_bitwise.py needs a CUDA card")
    import noisereduce_tpu_torch

    print(f"package {pathlib.Path(noisereduce_tpu_torch.__file__).parent}", flush=True)
    outs = run()
    torch.save(outs, args.save)
    print(f"{len(outs)} outputs ({sum(v.numel() for v in outs.values()) / 1e6:.1f} M "
          f"values) to {args.save}", flush=True)


if __name__ == "__main__":
    main()
