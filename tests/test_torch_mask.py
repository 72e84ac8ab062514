"""PyTorch port: the fused non-stationary masks (TPU rows 6 and 7,
``noisereduce_tpu/ops/pallas_mask.py``) against the JAX package (CPU).

Row 6 is kernel G on a frequency-major spectrogram, row 7 kernel B with one
unit tap on time-major re/im planes; here their plain versions run. Inputs
come from ``np.random.default_rng(seed)``. Bounds:

- row 6 forward, float32: 2e-5 against the Pallas kernel in interpret mode
  (tests/test_pallas_mask.py:37), finite where a column is silent;
- the VJPs in float64 (complex128 for row 6): 1e-9 x max|g_jax| against
  ``jax.vjp`` of the same function. A complex input's torch gradient is the
  conjugate of JAX's;
- under grad the value is the no-grad value, bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisereduce_tpu.config import iir_b_coefficient
from noisereduce_tpu.ops.pallas_mask import (
    fused_nonstationary_mask as j_mask,
    fused_nonstationary_mask_tm as j_mask_tm,
)

from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda_mask import (
    fused_nonstationary_mask,
    fused_nonstationary_mask_tm,
)

torch.set_num_threads(2)

B = iir_b_coefficient(2.0, 44100, 256)
THRESH, SLOPE = 2.0, 10.0
F64_TOL = 1e-9


def _complex(shape, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("shape", [(1, 513, 300), (2, 2, 257, 130), (1, 129, 128)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("magnitude", [False, True], ids=["complex64", "magnitude"])
def test_row6_matches_the_tpu_kernel(shape, magnitude):
    Z = _complex(shape, sum(shape))
    if magnitude:  # a real float32 magnitude plane, as JAX accepts too
        Z = np.abs(Z).astype(np.float32)
    got = fused_nonstationary_mask(torch.as_tensor(Z), B, THRESH, SLOPE).numpy()
    want = np.asarray(j_mask(jnp.asarray(Z), B, THRESH, SLOPE, interpret=True))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_row6_zero_rows_stay_finite():
    """A silent frequency row: the twin (and the reference) give NaN there,
    the kernel and its plain version finite values (tests/test_pallas_mask.py:40)."""
    Z = _complex((1, 64, 200), 40)
    Z[0, 10] = 0.0
    got = fused_nonstationary_mask(torch.as_tensor(Z), B, THRESH, SLOPE).numpy()
    assert np.all(np.isfinite(got))
    want = np.asarray(j_mask(jnp.asarray(Z), B, THRESH, SLOPE, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-5)


def _row6(z):
    return fused_nonstationary_mask(z, B, THRESH, SLOPE)


def _row7(re, im):
    return fused_nonstationary_mask_tm(re, im, B, THRESH, SLOPE)


@pytest.mark.parametrize("row", [6, 7])
def test_vjp_matches_jax(row):
    """Row 6 in complex128 (the port's gradient is conj of JAX's), row 7 in
    float64 with respect to both planes."""
    rng = np.random.default_rng(41 + row)
    if row == 6:
        inputs = (_complex((2, 65, 140), 43, np.complex128),)
        fn, jfn = _row6, lambda z: j_mask(z, B, THRESH, SLOPE, True)
    else:
        inputs = (rng.standard_normal((2, 140, 65)), rng.standard_normal((2, 140, 65)))
        fn, jfn = _row7, lambda r, i: j_mask_tm(r, i, B, THRESH, SLOPE, True)
    cot = rng.standard_normal(inputs[0].shape)
    _, vjp_fn = jax.vjp(jfn, *map(jnp.asarray, inputs))
    jgrads = vjp_fn(jnp.asarray(cot))
    args = [torch.tensor(a, requires_grad=True) for a in inputs]
    grads = torch.autograd.grad(fn(*args), args, torch.as_tensor(cot))
    for g, jg in zip(grads, jgrads):
        g, jg = g.numpy(), np.asarray(jg)
        if row == 6:
            assert g.dtype == np.complex128
            jg = np.conj(jg)
        dev, scale = np.abs(g - jg).max(), np.abs(jg).max()
        assert scale > 0 and dev <= F64_TOL * scale, f"row {row}: {dev:.3e} vs {scale:.3e}"


@pytest.mark.parametrize("row", [6, 7])
def test_value_under_grad_is_the_no_grad_value(row):
    rng = np.random.default_rng(50 + row)
    if row == 6:
        inputs, fn, name = (torch.as_tensor(_complex((2, 65, 140), 52)),), _row6, "fm_nonstationary_mask"
    else:
        inputs = tuple(torch.as_tensor(rng.standard_normal((2, 140, 65)), dtype=torch.float32)
                       for _ in range(2))
        fn, name = _row7, "nonstationary_mask"
    with torch.no_grad():
        serving = fn(*inputs)
    K.reset_launch_counts()
    args = [a.clone().requires_grad_() for a in inputs]
    out = fn(*args)
    assert out.grad_fn is not None and torch.equal(out, serving)
    grads = torch.autograd.grad(out.sum(), args)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert K.launch_counts()[name] == 0  # the plain version on the CPU


def test_plain_version_matches_the_time_major_one():
    """G's plain version is B's with one unit tap, transposed."""
    rng = np.random.default_rng(60)
    re, im = (torch.as_tensor(rng.standard_normal((3, 90, 33)), dtype=torch.float32)
              for _ in range(2))
    tm = K.nonstationary_mask_ref(re, im, B, THRESH, SLOPE, (1.0,))
    fm = K.fm_nonstationary_mask_ref(torch.complex(re, im).transpose(1, 2), B, THRESH, SLOPE)
    assert torch.equal(fm.transpose(1, 2), tm)
