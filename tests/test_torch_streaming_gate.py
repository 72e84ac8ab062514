"""PyTorch port: ``StreamingGate`` against the JAX package's and against the
port's own offline ``reduce_noise(chunk_size=block_size, padding=padding)``
(CPU, ``device="cpu"``, float32).

16 kHz, blocks of 4000 with padding 1000, streams of 1 to 5 blocks fed in
pieces of several lengths. Tolerance: atol 2e-6 against both, the JAX
streaming gate tests' own envelope (``tests/test_streaming_gate.py:41``).
"""
import numpy as np
import pytest
import torch

from noisereduce_tpu.streaming import StreamingGate as JaxStreamingGate

import noisereduce_tpu_torch as nrt

torch.set_num_threads(2)

SR = 16000
B, P = 4000, 1000
ATOL = 2e-6
CPU = dict(device="cpu")


def _signal(shape, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _offline(y, **kw):
    return nrt.reduce_noise(y, SR, chunk_size=B, padding=P, device="cpu", **kw)


def _stream(gate, y, feed):
    """Feed ``y`` in pieces of ``feed`` samples; return the whole output."""
    parts = []
    x2d = y if y.ndim == 2 else y[None]
    for s in range(0, x2d.shape[-1], feed):
        piece = x2d[:, s : s + feed]
        parts.append(gate.process(piece if y.ndim == 2 else piece[0]))
    parts.append(gate.flush())
    return np.concatenate(parts, axis=-1)


def _check(y, feed, channels=1, **kw):
    got = _stream(nrt.StreamingGate(SR, B, P, channels=channels, **CPU, **kw), y, feed)
    want = _stream(JaxStreamingGate(SR, B, P, channels=channels, **kw), y, feed)
    assert got.shape == want.shape == y.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, _offline(y, **kw), atol=ATOL)


@pytest.mark.parametrize("feed", [B, 1000, 1719, 3 * B + 700], ids=lambda f: f"feed{f}")
def test_nonstationary_stream(feed):
    _check(_signal(3 * B + 700, 1), feed)


@pytest.mark.parametrize("feed", [B, 777])
def test_stationary_self_noise_stream(feed):
    _check(_signal(3 * B + 123, 2), feed, stationary=True)


@pytest.mark.parametrize("clip_noise_stationary", [True, False])
def test_stationary_noise_clip_stream(clip_noise_stationary):
    clip = (0.1 * np.random.default_rng(3).standard_normal(6000)).astype(np.float32)
    _check(_signal(2 * B + 50, 4), 777, stationary=True, y_noise=clip,
           clip_noise_stationary=clip_noise_stationary)


@pytest.mark.parametrize("n", [B - 300, B, 1, 0], ids=["short", "one-block", "one", "empty"])
@pytest.mark.parametrize("stationary", [False, True])
def test_short_stream_uses_the_unchunked_view(n, stationary):
    """A stream that fits one block: flush gates the offline unchunked
    n + 2P view (the IIR floor spans other frames there)."""
    if n == 0 or (stationary and n == 1):
        gate = nrt.StreamingGate(SR, B, P, stationary=stationary, **CPU)
        if n:
            gate.process(np.zeros(n, np.float32))
        assert gate.flush().shape == (n,)
        return
    y = _signal(n, 5)
    gate = nrt.StreamingGate(SR, B, P, stationary=stationary, **CPU)
    assert gate.process(y).size == 0
    got = gate.flush()
    np.testing.assert_allclose(got, _offline(y, stationary=stationary), atol=ATOL)
    jgate = JaxStreamingGate(SR, B, P, stationary=stationary)
    jgate.process(y)
    np.testing.assert_allclose(got, jgate.flush(), atol=ATOL)


@pytest.mark.parametrize("stationary", [False, True])
def test_multichannel_stream(stationary):
    _check(_signal((2, 2 * B + 10), 6), 1500, channels=2, stationary=stationary)


@pytest.mark.parametrize("kw", [dict(n_fft=512), dict(prop_decrease=0.7, time_constant_s=0.5)],
                         ids=["n_fft512", "prop-time-constant"])
def test_gate_arguments_reach_the_blocks(kw):
    _check(_signal(2 * B + 333, 7), 2100, **kw)


def test_latency_and_emission_schedule():
    gate = nrt.StreamingGate(SR, B, P, **CPU)
    assert gate.latency_samples == B + P
    assert gate.latency_s == (B + P) / SR
    # nothing until block 0's lookahead is complete
    assert gate.process(np.zeros(B + P - 1, np.float32)).size == 0
    assert gate.process(np.zeros(1, np.float32)).shape == (B,)
    # then one block per further block_size samples
    assert gate.process(np.zeros(B - 1, np.float32)).size == 0
    assert gate.process(np.zeros(1, np.float32)).shape == (B,)
    assert gate.process(np.zeros(3 * B, np.float32)).shape == (3 * B,)


def test_process_after_flush_raises():
    gate = nrt.StreamingGate(SR, B, P, **CPU)
    gate.process(np.zeros(10, np.float32))
    gate.flush()
    with pytest.raises(RuntimeError, match="flush"):
        gate.process(np.zeros(10, np.float32))
    assert gate.flush().size == 0  # idempotent


def test_refused_modes():
    with pytest.raises(ValueError, match="clip_noise_stationary"):
        nrt.StreamingGate(SR, B, P, stationary=True, clip_noise_stationary=False, **CPU)
    with pytest.raises(ValueError, match="block_size"):
        nrt.StreamingGate(SR, 0, P, **CPU)
    with pytest.raises(ValueError, match="padding"):
        nrt.StreamingGate(SR, B, -1, **CPU)
    with pytest.raises(ValueError, match="channels"):
        nrt.StreamingGate(SR, B, P, channels=0, **CPU)
    gate = nrt.StreamingGate(SR, B, P, **CPU)  # channels=1 default
    with pytest.raises(ValueError, match="channel"):
        gate.process(np.zeros((2, 100), np.float32))


@pytest.mark.parametrize("stationary", [False, True])
def test_warmup_leaves_the_state_alone(stationary):
    gate = nrt.StreamingGate(SR, B, P, stationary=stationary, **CPU)
    assert gate.warmup() is gate
    assert gate._received() == 0 and gate._emitted == 0
    assert gate._thresh is None  # self-noise statistics still come from the stream
    y = _signal(2 * B, 8)
    np.testing.assert_allclose(_stream(gate, y, B), _offline(y, stationary=stationary),
                               atol=ATOL)


def test_bounded_state():
    """The host buffer never holds more than two blocks and their halos,
    whatever the stream's length (the real-time memory contract)."""
    gate = nrt.StreamingGate(SR, B, P, **CPU)
    y = _signal(20 * B, 9)
    for s in range(0, y.shape[-1], B):
        gate.process(y[s : s + B])
        assert gate._buf.shape[-1] <= 2 * B + 2 * P
    assert gate._emitted == 19 and gate._buf_pos == 19 * B - P
