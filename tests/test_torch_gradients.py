"""PyTorch port: gradients through the gates against the JAX package (CPU).

Every fused entry point of the port is differentiable as the JAX package's
``custom_vjp`` wrappers are: the value under grad is the kernels' output
(here their plain versions), bitwise the serving value with the same
launch counts, and the cotangent comes from the staged twin. Inputs come
from ``np.random.default_rng(seed)`` in float64 and go to both packages as
numpy arrays. Bounds:

- gradients: 1e-9 x max|g_jax| against ``jax.grad`` of the same function,
  the fused JAX functions run with ``interpret=True`` as
  tests/test_fused_pipeline.py runs them (their value comes from the
  Pallas kernel, their cotangent from the staged jnp twin); a zero JAX
  gradient (a stationary threshold, a noise clip behind a binary mask) must
  be zero here too;
- the training loop (the twin of tests/test_gradients.py:58): the first
  step's parameter gradients at 1e-9 x scale; 8 Adam steps lower the loss,
  each loss within 1e-9 x of optax's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from noisereduce_tpu.config import GateConfig as JGateConfig
from noisereduce_tpu.models.spectral_gate import gate_nonstationary as j_gate_nonstationary
from noisereduce_tpu.models.spectral_gate import (
    stationary_noise_threshold as j_threshold,
)
from noisereduce_tpu.models.tpu_gate import TPUGate as JTPUGate
from noisereduce_tpu.ops.pallas_pipeline import (
    fused_gate_chunked as j_fused_chunked,
    fused_gate_nonstationary as j_fused_nonstationary,
    fused_gate_stationary as j_fused_stationary,
    fused_tpugate as j_fused_tpugate,
)

import noisereduce_tpu_torch as nrt
from noisereduce_tpu_torch.config import GateConfig
from noisereduce_tpu_torch.models.spectral_gate import (
    gate_nonstationary,
    stationary_noise_threshold,
)
from noisereduce_tpu_torch.ops.cuda import kernels as K
from noisereduce_tpu_torch.ops.cuda.dispatch import (
    fused_gate_chunked,
    fused_gate_nonstationary,
    fused_gate_stationary,
)
from noisereduce_tpu_torch.ops.cuda.torch_dispatch import fused_tpugate

torch.set_num_threads(2)

F64_TOL = 1e-9


def _rng(seed):
    return np.random.default_rng(seed)


def _thr(cfg_kw, seed):
    """A stationary threshold from a float64 noise row (the JAX staged
    statistics), shared by both packages."""
    noise = _rng(seed).standard_normal(8000)
    return np.asarray(j_threshold(jnp.asarray(noise), JGateConfig(**cfg_kw), use_pallas=False))


def _gate_pair(nonstationary, **kw):
    gate = nrt.TPUGate(sr=16000, nonstationary=nonstationary, **kw)
    return gate, JTPUGate(**gate.fields())


# Each case: (inputs as numpy, the port's function, the JAX function).
def _case(name):
    if name == "nonstationary":
        kw = dict(sr=8000, stationary=False)
        cfg, jcfg = GateConfig(**kw), JGateConfig(**kw)
        return ((_rng(1).standard_normal(9000),),
                lambda a: fused_gate_nonstationary(a, cfg),
                lambda a: j_fused_nonstationary(a, jcfg, interpret=True))
    if name == "stationary":
        kw = dict(sr=8000, stationary=True)
        cfg, jcfg = GateConfig(**kw), JGateConfig(**kw)
        return ((_rng(2).standard_normal(9000), _thr(kw, 3)),
                lambda a, t: fused_gate_stationary(a, t, cfg),
                lambda a, t: j_fused_stationary(a, t, jcfg, interpret=True))
    if name == "chunked":
        kw = dict(sr=44100, stationary=False)
        cfg, jcfg = GateConfig(**kw), JGateConfig(**kw)
        return ((_rng(4).standard_normal((1, 30000)),),
                lambda a: fused_gate_chunked(a, cfg, 8000, 1500),
                lambda a: j_fused_chunked(a, jcfg, 8000, 1500, interpret=True))
    if name == "chunked-stationary":
        kw = dict(sr=44100, stationary=True)
        cfg, jcfg = GateConfig(**kw), JGateConfig(**kw)
        return ((_rng(5).standard_normal((2, 20000)), np.stack([_thr(kw, 6), _thr(kw, 7)])),
                lambda a, t: fused_gate_chunked(a, cfg, 8000, 1500, noise_thresh=t),
                lambda a, t: j_fused_chunked(a, jcfg, 8000, 1500, noise_thresh=t,
                                             interpret=True))
    if name == "tpugate":
        gate, jgate = _gate_pair(True)
        return ((_rng(8).standard_normal((2, 20000)),),
                lambda a: fused_tpugate(a, None, gate),
                lambda a: j_fused_tpugate(a, None, jgate, interpret=True))
    if name == "tpugate-xn":
        gate, jgate = _gate_pair(False)
        r = _rng(9)
        return ((r.standard_normal((2, 20000)), 0.5 * r.standard_normal((2, 12000))),
                lambda a, b: fused_tpugate(a, b, gate),
                lambda a, b: j_fused_tpugate(a, b, jgate, interpret=True))
    if name == "tpugate-hop300":
        # a hop that does not divide n_fft: the kernels' mask between the
        # plain STFT and iSTFT, against JAX's staged gate (its only path)
        gate, jgate = _gate_pair(True, hop_length=300)
        return ((_rng(10).standard_normal((2, 20000)),), gate, jgate)
    if name == "tpugate-batched-chunks":
        gate, jgate = _gate_pair(False)
        r = _rng(11)
        return ((r.standard_normal((2, 3, 11000)), 0.5 * r.standard_normal((2, 9000))),
                gate.batched_chunks, jgate.batched_chunks)
    if name == "threshold":
        # the stationary threshold of noise rows: kernel A's spectra, the
        # staged STFT's cotangent
        kw = dict(sr=8000, stationary=True)
        cfg, jcfg = GateConfig(**kw), JGateConfig(**kw)
        return ((_rng(13).standard_normal((2, 8000)),),
                lambda a: stationary_noise_threshold(a, cfg),
                lambda a: j_threshold(a, jcfg, use_pallas=False))
    if name == "nonstationary-hop300":
        # kernel B's staged mask (TPU row 7) against JAX's staged gate
        kw = dict(sr=16000, n_fft=1024, hop_length=300)
        cfg, jcfg = GateConfig(**kw), JGateConfig(**kw)
        return ((_rng(12).standard_normal(20000),),
                lambda a: gate_nonstationary(a, cfg),
                lambda a: j_gate_nonstationary(a, jcfg))
    raise KeyError(name)


GRAD_CASES = ["nonstationary", "stationary", "chunked", "chunked-stationary", "tpugate",
              "tpugate-xn", "tpugate-hop300", "tpugate-batched-chunks", "threshold",
              "nonstationary-hop300"]


def _port_vjp(fn, inputs, cot=None):
    """f(*inputs) and the gradient of every input, for the cotangent ``cot``
    (default: that of mean(f ** 2))."""
    args = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = fn(*args)
    if cot is None:
        return out, torch.autograd.grad((out ** 2).mean(), args)
    return out, torch.autograd.grad(out, args, torch.as_tensor(cot))


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradient_matches_jax(name):
    """The twins of tests/test_fused_pipeline.py:88, :268, :350 and :425
    (the gradient routes through the staged twin), for every fused entry,
    with the fused JAX function as the reference: ``jax.vjp`` and the
    port's backward pass pull the same seeded cotangent back. (A loss of
    the output would not do: the fused JAX value is float32 inside.)"""
    inputs, fn, jfn = _case(name)
    args = tuple(map(jnp.asarray, inputs))
    out = jax.eval_shape(jfn, *args)
    cot = _rng(99).standard_normal(out.shape)
    jgrads = jax.jit(lambda c, *a: jax.vjp(jfn, *a)[1](c))(jnp.asarray(cot, out.dtype), *args)
    _, grads = _port_vjp(fn, inputs, cot)
    for g, jg in zip(grads, jgrads):
        g, jg = g.numpy(), np.asarray(jg)
        assert g.shape == jg.shape and np.all(np.isfinite(g))
        dev, scale = np.abs(g - jg).max(), np.abs(jg).max()
        assert dev <= F64_TOL * scale, f"{name}: {dev:.3e} vs scale {scale:.3e}"
    assert np.abs(grads[0].numpy()).max() > 0


PRIMAL_CASES = ["nonstationary", "stationary", "chunked", "tpugate"]


@pytest.mark.parametrize("name", PRIMAL_CASES)
def test_value_under_grad_is_the_serving_value(name):
    """The twins of tests/test_fused_pipeline.py:104-165: under grad the
    value is the serving value bitwise, with the serving launch counts; the
    backward pass launches nothing and its gradient is finite."""
    inputs, fn, _ = _case(name)
    args = [torch.tensor(a, dtype=torch.float32) for a in inputs]
    K.reset_launch_counts()
    with torch.no_grad():
        serving = fn(*args)
    serving_counts = K.launch_counts()
    K.reset_launch_counts()
    args = [a.requires_grad_() for a in args]
    out = fn(*args)
    assert out.grad_fn is not None
    assert torch.equal(out, serving)
    assert K.launch_counts() == serving_counts
    grads = torch.autograd.grad(out, args, torch.ones_like(out))
    assert K.launch_counts() == serving_counts
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ---------------------------------------------------------------------------
# twins of tests/test_gradients.py
# ---------------------------------------------------------------------------
SR, N = 8000, 4096


def _batch(b=2):
    t = np.arange(N) / SR
    clean = np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 220 * t)
    noisy = clean + _rng(9).standard_normal((b, N)) * 0.3
    return noisy, np.tile(clean, (b, 1))


def test_gate_is_differentiable():
    """TPUGate's gradient, the kernels' value and the twin's cotangent,
    against jax.grad of the JAX gate (``_call_jnp`` on the CPU)."""
    gate, jgate = nrt.TPUGate(sr=SR, nonstationary=True), JTPUGate(sr=SR, nonstationary=True)
    x, _ = _batch()
    _, (g,) = _port_vjp(gate, (x,))
    jg = np.asarray(jax.jit(jax.grad(lambda a: jnp.mean(jgate(a) ** 2)))(jnp.asarray(x)))
    g = g.numpy()
    assert g.shape == x.shape and np.all(np.isfinite(g)) and np.abs(g).max() > 0
    assert np.abs(g - jg).max() <= F64_TOL * np.abs(jg).max()


def test_functional_gate_gradient():
    kw = dict(sr=SR, n_fft=512)
    cfg, jcfg = GateConfig(**kw), JGateConfig(**kw)
    x = _rng(13).standard_normal(N)
    _, (g,) = _port_vjp(lambda a: gate_nonstationary(a, cfg), (x,))
    jg = np.asarray(jax.jit(jax.grad(lambda a: jnp.mean(j_gate_nonstationary(a, jcfg) ** 2)))(
        jnp.asarray(x)))
    assert np.all(np.isfinite(g.numpy()))
    assert np.abs(g.numpy() - jg).max() <= F64_TOL * np.abs(jg).max()


def test_training_loop_with_gate_in_graph():
    """Notebook-3.0 workload: a scale and a bias trained THROUGH the gate
    with torch.optim.Adam, against the same loop with optax.adam."""
    kw = dict(sr=SR, nonstationary=True, freq_mask_smooth_hz=None, time_mask_smooth_ms=None)
    gate, jgate = nrt.TPUGate(**kw), JTPUGate(**kw)
    noisy, clean = _batch()

    def loss_of(den, tgt, m):
        return ((den[..., :m] - tgt[..., :m]) ** 2).mean()

    jparams = {"scale": jnp.ones(()), "bias": jnp.zeros(())}
    opt = optax.adam(1e-2)
    jstate = opt.init(jparams)

    @jax.jit
    def jstep(p, s):
        def f(p):
            den = jgate(jnp.asarray(noisy) * p["scale"] + p["bias"])
            m = min(den.shape[-1], clean.shape[-1])
            return jnp.mean((den[..., :m] - jnp.asarray(clean)[..., :m]) ** 2)

        loss, grads = jax.value_and_grad(f)(p)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), s, loss, grads

    scale = torch.ones((), dtype=torch.float64, requires_grad=True)
    bias = torch.zeros((), dtype=torch.float64, requires_grad=True)
    adam = torch.optim.Adam([scale, bias], lr=1e-2)
    x, tgt = torch.as_tensor(noisy), torch.as_tensor(clean)
    losses, jlosses = [], []
    for step in range(8):
        jparams, jstate, jloss, jgrads = jstep(jparams, jstate)
        adam.zero_grad()
        den = gate(x * scale + bias)
        loss = loss_of(den, tgt, min(den.shape[-1], tgt.shape[-1]))
        loss.backward()
        if step == 0:
            for p, name in ((scale, "scale"), (bias, "bias")):
                jg = float(jgrads[name])
                assert abs(float(p.grad) - jg) <= F64_TOL * abs(jg), name
        adam.step()
        losses.append(loss.item())
        jlosses.append(float(jloss))
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # the optimizer makes progress through the gate
    np.testing.assert_allclose(losses, jlosses, rtol=F64_TOL)


def test_gate_input_validation():
    gate = nrt.TPUGate(sr=SR)
    with pytest.raises(ValueError):
        gate(torch.zeros(N))  # 1-D rejected (torchgate.py:214)
    with pytest.raises(ValueError):
        gate(torch.zeros((1, 100)))  # too short (torchgate.py:215-216)
    with pytest.raises(ValueError):
        nrt.TPUGate(sr=SR, prop_decrease=1.5)
    # an input that requires grad is taken, not refused
    x = torch.tensor(_batch()[0], requires_grad=True)
    assert gate(x).grad_fn is not None
