"""PyTorch port: the cotangent-precision setting ``NRTPU_COTANGENT_PRECISION``
(``ops/precision.py``), the counterpart of tests/test_cotangent_precision.py.

The gate-level entries take their cotangent from the staged twin through
``cotangent_vjp``. The default mode ``bf16`` casts float32 primals and the
cotangent to bfloat16 where the primals are on the card; here, on the CPU,
the port's card predicate is patched as the JAX tests patch
``_tpu_available``. Pinned:

- on the CPU the cotangent is the uncast twin's, bitwise, in every mode;
- with the card reported the cast engages: the gradients keep float32,
  change, and stay within 5e-2 x max|ref| (the JAX envelope) at every
  gate-level site with a soft mask, within 1.5e-1 (the bf16 mode's
  stationary envelope, tests/test_bfloat16_mode.py) at the stationary
  gates, whose binary decisions flip on bf16 spectra; ``high`` and
  ``highest`` restore the uncast cotangent bitwise (the twin has no
  operation whose precision PyTorch lowers, so ``default``, ``high`` and
  ``highest`` are bitwise one another);
- the row 6 and row 7 masks (``ops/cuda_mask.py``) never cast, as their
  JAX VJPs are a plain ``jax.vjp``, nor does the stationary threshold,
  which has no ``cotangent_vjp`` in JAX;
- invalid names raise ``ValueError`` naming the variable.

Inputs come from ``np.random.default_rng`` seeds.
"""
import numpy as np
import pytest
import torch

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.config import GateConfig
from noisereduce_tpu_torch.models.spectral_gate import _gate_nonstationary_staged
from noisereduce_tpu_torch.ops import precision
from noisereduce_tpu_torch.ops.cuda.dispatch import (
    fused_gate_chunked,
    fused_gate_nonstationary,
    fused_gate_stationary,
    fused_stationary_threshold,
)
from noisereduce_tpu_torch.ops.cuda.torch_dispatch import (
    fused_tpugate,
    fused_tpugate_chunked,
    staged_tpugate,
)
from noisereduce_tpu_torch.ops.cuda_mask import (
    fused_nonstationary_mask,
    fused_nonstationary_mask_tm,
)

torch.set_num_threads(2)

RNG = np.random.default_rng(17)
CFG = GateConfig(sr=8000, stationary=False)
X = torch.as_tensor(RNG.standard_normal(9000), dtype=torch.float32)
# a fixed incoming cotangent, the twin's output's shape
G = torch.as_tensor(RNG.standard_normal(9000), dtype=torch.float32)
ENVELOPE = 5e-2
STATIONARY_ENVELOPE = 1.5e-1


def _twin(a):
    return _gate_nonstationary_staged(a, CFG)


def _direct_vjp():
    x = X.clone().requires_grad_()
    (g,) = torch.autograd.grad(_twin(x), x, G)
    return g


def test_default_mode_is_bf16(monkeypatch):
    monkeypatch.delenv("NRTPU_COTANGENT_PRECISION", raising=False)
    assert precision._cotangent_mode() == "bf16"


def test_invalid_mode_raises(monkeypatch):
    monkeypatch.setenv("NRTPU_COTANGENT_PRECISION", "fp8")
    with pytest.raises(ValueError, match="NRTPU_COTANGENT_PRECISION"):
        precision._cotangent_mode()


@pytest.mark.parametrize("mode", ["bf16", "default", "high", "highest"])
def test_cpu_cotangent_bit_exact_across_modes(monkeypatch, mode):
    monkeypatch.setenv("NRTPU_COTANGENT_PRECISION", mode)
    (got,) = precision.cotangent_vjp(_twin, (X,), G)
    assert torch.equal(got, _direct_vjp())


def test_bf16_cast_engages_on_the_card(monkeypatch):
    """With the card reported, the default mode casts primal and cotangent
    to bf16: the gradient keeps float32 but changes, within the envelope;
    ``high`` restores the uncast twin bit for bit."""
    monkeypatch.setattr(precision, "_on_card", lambda primals: True)
    ref = _direct_vjp()
    monkeypatch.setenv("NRTPU_COTANGENT_PRECISION", "bf16")
    (gb,) = precision.cotangent_vjp(_twin, (X,), G)
    assert gb.dtype == torch.float32
    assert not torch.equal(gb, ref), "bf16 cast did not engage"
    assert (gb - ref).abs().max() <= ENVELOPE * ref.abs().max()
    monkeypatch.setenv("NRTPU_COTANGENT_PRECISION", "high")
    (gh,) = precision.cotangent_vjp(_twin, (X,), G)
    assert torch.equal(gh, ref)


def test_default_high_and_highest_are_bitwise_one_another(monkeypatch):
    """The counterpart of the JAX scope test: the port's twin has no
    precision-lowered operation, so the three modes are the uncast
    cotangent, also with the card reported."""
    monkeypatch.setattr(precision, "_on_card", lambda primals: True)
    got = {}
    for mode in ("default", "high", "highest"):
        monkeypatch.setenv("NRTPU_COTANGENT_PRECISION", mode)
        (got[mode],) = precision.cotangent_vjp(_twin, (X,), G)
    assert torch.equal(got["default"], got["high"])
    assert torch.equal(got["high"], got["highest"])
    assert torch.equal(got["highest"], _direct_vjp())


# ---------------------------------------------------------------------------
# the sites: every gate-level entry casts; the row 6 and 7 masks and the
# stationary threshold do not
# ---------------------------------------------------------------------------
def _gate_sites():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((2, 9000)), dtype=torch.float32)
    xl = torch.as_tensor(rng.standard_normal((1, 21000)), dtype=torch.float32)
    noise = torch.as_tensor(rng.standard_normal(6000), dtype=torch.float32)
    scfg = GateConfig(sr=8000, stationary=True)
    thr = fused_stationary_threshold(noise, scfg)
    ns_gate = nrt.TPUGate(sr=8000, nonstationary=True)
    st_gate = nrt.TPUGate(sr=8000, nonstationary=False)
    odd_gate = nrt.TPUGate(sr=8000, nonstationary=True, n_fft=512, hop_length=100)
    return {
        "fused_gate_nonstationary": (lambda a: fused_gate_nonstationary(a, CFG), x),
        "fused_gate_stationary": (lambda a: fused_gate_stationary(a, thr, scfg), x),
        "fused_gate_chunked": (lambda a: fused_gate_chunked(a, CFG, 6000, 1000), xl),
        "fused_tpugate": (lambda a: fused_tpugate(a, None, ns_gate), x),
        "fused_tpugate_chunked": (
            lambda a: fused_tpugate_chunked(a, st_gate, 6000, 1000, noise[None]), xl),
        "staged_tpugate": (lambda a: staged_tpugate(a, None, odd_gate), x),
    }


SITES = list(_gate_sites())
BINARY = ("fused_gate_stationary", "fused_tpugate_chunked")  # stationary gates


def _grad(fn, x, seed=9):
    a = x.clone().requires_grad_()
    out = fn(a)
    cot = torch.as_tensor(np.random.default_rng(seed).standard_normal(tuple(out.shape)),
                          dtype=out.dtype)
    (g,) = torch.autograd.grad(out, a, cot)
    return out.detach(), g


@pytest.mark.parametrize("site", SITES)
def test_gate_level_sites_take_the_cast(monkeypatch, site):
    """Each gate-level entry, card reported: the value is the serving
    value (the setting touches only the cotangent), the gradient float32,
    changed by the cast and within the envelope of ``highest``'s, which
    is the CPU gradient bitwise."""
    fn, x = _gate_sites()[site]
    monkeypatch.setenv("NRTPU_COTANGENT_PRECISION", "highest")
    value, cpu = _grad(fn, x)
    monkeypatch.setattr(precision, "_on_card", lambda primals: True)
    _, highest = _grad(fn, x)
    assert torch.equal(highest, cpu)
    monkeypatch.setenv("NRTPU_COTANGENT_PRECISION", "bf16")
    cast_value, cast = _grad(fn, x)
    assert torch.equal(cast_value, value)
    assert cast.dtype == torch.float32
    assert not torch.equal(cast, highest), "bf16 cast did not engage"
    lim = STATIONARY_ENVELOPE if site in BINARY else ENVELOPE
    assert (cast - highest).abs().max() <= lim * highest.abs().max()


@pytest.mark.parametrize("row", ["row 6", "row 7", "threshold"])
def test_sites_without_cotangent_vjp_never_cast(monkeypatch, row):
    """The masks of ``ops/cuda_mask.py``, and the stationary threshold,
    keep the uncast cotangent with the card reported in mode ``bf16``."""
    rng = np.random.default_rng(11)
    mk = (CFG.iir_b, CFG.thresh_n_mult_nonstationary, CFG.sigmoid_slope_nonstationary)
    shape = (2, 60, 129)
    if row == "threshold":
        shape = (CFG.stft.n_bins,)
        args = [torch.as_tensor(rng.standard_normal(6000), dtype=torch.float32)]
        scfg = GateConfig(sr=8000, stationary=True)
        fn = lambda a: fused_stationary_threshold(a, scfg)  # noqa: E731
    elif row == "row 6":
        shape = (2, 129, 60)
        z = torch.complex(*(torch.as_tensor(rng.standard_normal((2, 129, 60)),
                                            dtype=torch.float32) for _ in range(2)))
        args, fn = [z], lambda a: fused_nonstationary_mask(a, *mk)
    else:
        args = [torch.as_tensor(rng.standard_normal((2, 60, 129)), dtype=torch.float32)
                for _ in range(2)]
        fn = lambda r, i: fused_nonstationary_mask_tm(r, i, *mk)  # noqa: E731
    cot = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    def grads():
        a = [t.clone().requires_grad_() for t in args]
        return torch.autograd.grad(fn(*a), a, cot)

    monkeypatch.setenv("NRTPU_COTANGENT_PRECISION", "highest")
    want = grads()
    monkeypatch.setattr(precision, "_on_card", lambda primals: True)
    monkeypatch.setenv("NRTPU_COTANGENT_PRECISION", "bf16")
    for g, w in zip(grads(), want):
        assert torch.equal(g, w)
