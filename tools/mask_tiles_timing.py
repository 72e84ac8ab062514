#!/usr/bin/env python3
"""Time the mask kernels B ``nonstationary_mask``, E ``stationary_mask``, F
``torch_nonstationary_mask`` and G ``fm_nonstationary_mask``, and kernel C
``freq_smooth_blend``, on one CUDA card at the headline shapes (960
s of 48 kHz audio, n_fft 1024 / hop 256, chunked as ``reduce_noise``
chunks: 77 views x 2,579 frames x 513 bins), in twelve cases: B with the
headline's 19 time taps, B with one unit tap (the staged geometry's mask),
E with a 10 s noise clip's threshold, E with each view's own statistics
(top_db 40, TorchGate's n_std), and F with the torch headline's gate
(n_movemean 375, its 19 SVD time taps), G on the same spectra laid out
frequency-major (77 x 513 x 2,579 complex64, TPU row 6) on its plan's
route and on its tiled route forced (a package without ``_fm_mask_on``
skips that one), C on B's mask with the headline's frequency taps, and G
on short columns: the training batch of 256 clips of 4 s, here taken at
16 kHz (n_fft 512 / hop 128: 256 x 257 x 501 complex64); and C at
``chip_smoke.py``'s ``C_SHAPES`` (cases 9-11: the 32 x 10 s batch's
plane, the split geometry's 129 taps, 641 taps on 257 bins). The spectra are
kernel A's of
``chip_smoke.py``'s headline signal (the scipy table; E's own statistics
and F on the torch table's, as the torch paths give them). Per case: CUDA
events around one call, the minimum of ``--reps`` after a warm-up (the
host's launch work included); the device
time of the call's kernels, the mean over ``--reps`` calls in a
``torch.profiler`` trace, by kernel name; the CUDA launches of one call
(``cuda_launches``, where the package records it); the bytes bound (re, im
or Z read once, the mask written once, over 3.35 TB/s; C: the mask read
once and one written). Prints the card's name
and power limit first and one JSON line last.

``--dtype bfloat16`` times B, E and F (cases 0-4) on the same spectra cast
to bfloat16: their bf16 builds, the bytes bound from the bf16 planes (re
and im 2 B a cell, the float32 mask 4 B); C and G take float32 only and
are skipped.

    python3 tools/mask_tiles_timing.py [--reps 10] [--save PATH] [--cases 5,6,7,8]
    python3 tools/mask_tiles_timing.py --dtype bfloat16 --cases 0,1,2,3,4
    python3 tools/mask_tiles_timing.py --compare OLD.pt NEW.pt

``--cases`` picks cases by their number in that order, from 0;
``--save`` writes the masks to PATH (torch.save); ``--compare``
prints, per case, whether two saved runs are bitwise equal and their
largest |difference|. The ``noisereduce_tpu_torch`` timed is the one
Python imports first: to time a parent checkout (``git archive`` into an
ignored directory), put it first on ``PYTHONPATH``, and run the two in
turns (parent, change, change, parent) in one call. Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT))  # this tree's package, after PYTHONPATH's

CASES = ("nonstationary_mask", "nonstationary_mask (unit tap)", "stationary_mask",
         "stationary_mask (self statistics)", "torch_nonstationary_mask",
         "fm_nonstationary_mask", "fm_nonstationary_mask (tiled route)", "freq_smooth_blend",
         "fm_nonstationary_mask (short columns)", "freq_smooth_blend (batch 32 x 10 s)",
         "freq_smooth_blend (129 taps, split geometry)", "freq_smooth_blend (641 taps on 257 bins)")
BF16_CASES = CASES[:5]  # the kernels with a bfloat16 build
# case 8: a training batch of 256 clips of 4 s at 16 kHz, n_fft 512 / hop 128
SHORT_SR, SHORT_CLIPS, SHORT_SECONDS, SHORT_N_FFT = 16000, 256, 4, 512


def compare(old_path: str, new_path: str) -> None:
    old, new = torch.load(old_path), torch.load(new_path)
    out = {}
    for case in (c for c in old if c in new):
        a, b = old[case].double(), new[case].double()
        out[case] = dict(bitwise=bool(torch.equal(old[case], new[case])),
                         max_abs_diff=float((a - b).abs().max()),
                         cells_differing=int((a != b).sum()))
        print(f"{case}: {out[case]}", flush=True)
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    ap.add_argument("--cases", default=None)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the re/im planes' type of cases 0-4")
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import noisereduce_tpu_torch as nr
    # this tree's chip_smoke.py for the helpers and inputs, whichever
    # package PYTHONPATH puts first
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    CHUNK, HBM_BYTES_PER_S, NOISE_SECONDS, PADDING, SR = (
        cs.CHUNK, cs.HBM_BYTES_PER_S, cs.NOISE_SECONDS, cs.PADDING, cs.SR)
    card_line, device_ms, headline_signal, noise_clip, time_ms = (
        cs.card_line, cs.device_ms, cs.headline_signal, cs.noise_clip, cs.time_ms)
    from noisereduce_tpu_torch.models.spectral_gate import stationary_noise_threshold
    from noisereduce_tpu_torch.ops.cuda import kernels as K
    from noisereduce_tpu_torch.ops.cuda.geometry import gate_geometry
    from noisereduce_tpu_torch.ops.cuda.torch_dispatch import _rank1_taps
    from noisereduce_tpu_torch.ops.dsp import tri_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    x = torch.as_tensor(headline_signal(960)).cuda()[None]
    noise = torch.as_tensor(noise_clip(NOISE_SECONDS)).cuda()
    cfg, scfg = nr.GateConfig(sr=SR), nr.GateConfig(sr=SR, stationary=True)
    tgate = nr.api.torch_gate_for(SR, stationary=True)
    fgate = nr.api.torch_gate_for(SR)  # the gate of the torch headline
    re, im = K.spectra(x, gate_geometry(cfg.stft, CHUNK + 2 * PADDING), CHUNK, PADDING)
    tre, tim = K.spectra(x, gate_geometry(tgate.stft_config, CHUNK + 2 * PADDING), CHUNK,
                         PADDING)
    tt = tri_norm(cfg.smoothing[1])
    nb = (cfg.iir_b, cfg.thresh_n_mult_nonstationary, cfg.sigmoid_slope_nonstationary)
    thr = stationary_noise_threshold(noise, scfg)
    f = (fgate.n_movemean_nonstationary, fgate.n_thresh_nonstationary,
         fgate.temp_coeff_nonstationary, fgate.prop_decrease, _rank1_taps(fgate.smoothing)[1])
    zf = torch.complex(re, im).transpose(1, 2).contiguous()  # TPU row 6's layout
    m = K.nonstationary_mask(re, im, *nb, tt)
    # the headline signal's first samples read as SHORT_CLIPS clips at SHORT_SR
    n16 = SHORT_SECONDS * SHORT_SR
    c16 = nr.GateConfig(sr=SHORT_SR, n_fft=SHORT_N_FFT)
    zs = torch.complex(*K.spectra(x[0, : SHORT_CLIPS * n16].reshape(SHORT_CLIPS, n16),
                                  gate_geometry(c16.stft, n16))).transpose(1, 2).contiguous()
    ns = (c16.iir_b, c16.thresh_n_mult_nonstationary, c16.sigmoid_slope_nonstationary)
    tf = tri_norm(cfg.smoothing[0])
    bf16 = args.dtype == "bfloat16"
    if bf16:  # B, E and F read the same spectra rounded to bfloat16
        re, im, tre, tim = (t.to(torch.bfloat16) for t in (re, im, tre, tim))
    calls = {
        CASES[0]: (K.nonstationary_mask, lambda: K.nonstationary_mask(re, im, *nb, tt)),
        CASES[1]: (K.nonstationary_mask, lambda: K.nonstationary_mask(re, im, *nb, (1.0,))),
        CASES[2]: (K.stationary_mask,
                   lambda: K.stationary_mask(re, im, thr, 1, scfg.prop_decrease, tt)),
        CASES[3]: (K.stationary_mask,
                   lambda: K.stationary_mask(tre, tim, None, 1, tgate.prop_decrease, tt,
                                             top_db=40.0, n_std=tgate.n_std_thresh_stationary)),
        CASES[4]: (K.torch_nonstationary_mask,
                   lambda: K.torch_nonstationary_mask(tre, tim, *f)),
        CASES[5]: (K.fm_nonstationary_mask, lambda: K.fm_nonstationary_mask(zf, *nb)),
        CASES[6]: (K.fm_nonstationary_mask, lambda: K._fm_mask_on("tiled", zf, *nb)),
        CASES[7]: (K.freq_smooth_blend, lambda: K.freq_smooth_blend(m, tf, cfg.prop_decrease)),
        CASES[8]: (K.fm_nonstationary_mask, lambda: K.fm_nonstationary_mask(zs, *ns)),
    }
    # C's other shapes (chip_smoke.py's C_SHAPES), on B's mask
    planes = {}
    for case, (label, mc, taps, prop) in zip(CASES[9:], cs.c_planes(K, x[0])):
        assert case.endswith(f"({label})")
        planes[case] = mc
        calls[case] = (K.freq_smooth_blend,
                       lambda mc=mc, taps=taps, prop=prop: K.freq_smooth_blend(mc, taps, prop))
    picked = [CASES[int(i)] for i in args.cases.split(",")] if args.cases else CASES
    mask_bytes = re.numel() * 4  # a float32 plane of the headline's shape
    out, saved = {}, {}
    print(f"F: n_movemean {f[0]}, {len(f[-1])} time taps; planes {args.dtype}", flush=True)
    for case in picked:
        wrapper, fn = calls[case]
        if case == CASES[6] and not hasattr(K, "_fm_mask_on"):
            print(f"{case}: not in this package", flush=True)
            continue
        if bf16 and case not in BF16_CASES:
            print(f"{case}: float32 only", flush=True)
            continue
        # re and im (or Z) read once, the mask written once; C: one plane in, one out
        moved = 2 * mask_bytes if case == CASES[7] else (
            2 * re.numel() * re.element_size() + mask_bytes)
        if case == CASES[8]:
            moved = zs.numel() * 12  # complex64 in, the float32 mask out
        if case in planes:
            moved = 2 * planes[case].numel() * 4
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        saved[case + (" (bf16 planes)" if bf16 else "")] = fn()
        ms = time_ms(fn, args.reps)
        dev = device_ms(fn, args.reps)
        out[case] = dict(ms=ms, device_ms=sum(dev.values()) or None, device_by_kernel=dev,
                         cuda_launches=getattr(wrapper, "cuda_launches", 1),
                         bound_ms=bound_ms, bound_by="bytes",
                         shape=list((planes[case] if case in planes else zs if case == CASES[8]
                                     else zf if case in CASES[5:7] else re).shape))
        print(f"{case}: {ms:.3f} ms (device {sum(dev.values()):.3f} ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in dev.items())
              + f"), {out[case]['cuda_launches']} CUDA launches, bound {bound_ms:.3f} ms "
              f"({ms / bound_ms:.2f}x), input {out[case]['shape']}", flush=True)
    if args.save:
        torch.save({k: v.cpu() for k, v in saved.items()}, args.save)
    print(json.dumps({"package": str(pathlib.Path(nr.__file__).parent), "dtype": args.dtype,
                      "shape": list(re.shape), "cases": out}), flush=True)


if __name__ == "__main__":
    main()
