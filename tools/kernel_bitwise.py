#!/usr/bin/env python3
"""Hold the float32 builds of kernels A-G to another tree's, bit for bit, on
one CUDA card.

    python3 tools/kernel_bitwise.py --save OUT.pt
    python3 tools/kernel_bitwise.py --compare OLD.pt NEW.pt

``--save`` runs each kernel's float32 build on inputs drawn from a seed and
writes every output (torch.save): A and D on each of their routes (n_fft
1024, the power-of-two real-FFT kernel; 1536, the mixed-radix one; 1100,
the complex-frame kernels; 1323, odd, two frames a transform; 1102, the
chirp-z route; 40, the DFT products), in both STFT conventions, over 3
halo'd chunk views of 2 signal rows; B with the headline's 19 time taps,
one unit tap and 801 (its separate smoothing launch); E with a clip's
threshold and with each view's own statistics; F at n_movemean 375 and
374; C at 11 taps; G on both of its routes. ``--compare`` prints, for
each output, whether the two runs are bitwise equal, and exits 1 if any
differs. The ``noisereduce_tpu_torch`` run is the one Python imports first:
put a parent checkout (``git archive`` into an ignored directory) first on
``PYTHONPATH`` to save the parent's. Calls only the wrappers' float32
signatures, which the trees share. Imports nothing of JAX.
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
    ("n_fft 40", dict(n_fft=40, hop_length=10), 8000),
)


def run() -> dict:
    from noisereduce_tpu_torch.config import GateConfig, StftConfig
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.dsp import tri_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((2, N), generator=gen, device="cuda")
    out = {}
    for label, kw, sr in GEOMETRIES:
        for conv, extra in (("scipy", {}), ("torch", dict(convention="torch",
                                                          quantize_window_f32=True))):
            geo = gate_geometry(StftConfig(**kw, **extra), CHUNK + 2 * PADDING)
            re, im = K.spectra(x, geo, CHUNK, PADDING)
            mask = torch.rand(re.shape, generator=gen, device="cuda")
            out[f"A {label} {conv}"] = torch.stack([re, im])
            out[f"D {label} {conv}"] = K.istft_ola(re, im, mask, geo, PADDING, CHUNK)

    cfg = GateConfig(sr=SR)
    geo = gate_geometry(cfg.stft, CHUNK + 2 * PADDING)
    re, im = K.spectra(x, geo, CHUNK, PADDING)
    b = (cfg.iir_b, cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary)
    for taps in (9, 0, 400):
        out[f"B {2 * taps + 1} taps"] = K.nonstationary_mask(re, im, *b, tri_norm(taps))
    out["C 11 taps"] = K.freq_smooth_blend(out["B 19 taps"], tri_norm(5), 0.8)
    thr = torch.randn(geo.n_bins, generator=gen, device="cuda") * 10 - 40
    out["E threshold"] = K.stationary_mask(re, im, thr, 1, 0.8, tri_norm(9))
    out["E own statistics"] = K.stationary_mask(re, im, None, 1, 0.8, tri_norm(9),
                                                top_db=40.0, n_std=1.5)
    for n in (375, 374):
        out[f"F n_movemean {n}"] = K.torch_nonstationary_mask(re, im, n, 1.3, 0.1, 0.8,
                                                              tri_norm(9))
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
        print(f"{k}: bitwise {same}, max|difference| {dev:.3e}")
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
