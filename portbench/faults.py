"""Wrappers that break or lower a kind's timed entry: the lower-precision
controls, the faults a run must fail, and witnesses. Each takes the entry
(a function of ``kinds/<kind>.py``) and returns its replacement; a kind
names which apply to it (``CONTROL``, ``faults``, ``witnesses``), and
``calibrate.py`` and the tests plant them by ``replaced``.
"""
from __future__ import annotations

import contextlib
import os

import torch

COTANGENT = "NRTPU_COTANGENT_PRECISION"


@contextlib.contextmanager
def replaced(module, name: str, wrapper):
    """``module.<name>`` replaced by ``wrapper(original)`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrapper(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


# -- controls: the port's own bf16 path, the step below float32 ------------
def bf16_input(orig):
    """A bfloat16 input: the port's bf16 planes and output."""
    return lambda gate, x, *a: orig(gate, x.to(torch.bfloat16), *a).float()


def bf16_train_input(orig):
    def f(gate, x, clean):
        leaf, out, loss = orig(gate, x.to(torch.bfloat16), clean)
        return leaf, out.float(), loss
    return f


def bf16_cotangent(orig):
    """The port's bf16 cotangent (its default on the card) for the backward."""
    def f(loss):
        saved = os.environ.get(COTANGENT)
        os.environ[COTANGENT] = "bf16"
        try:
            return orig(loss)
        finally:
            if saved is None:
                os.environ.pop(COTANGENT, None)
            else:
                os.environ[COTANGENT] = saved
    return f


# -- faults ----------------------------------------------------------------
def half_rows(orig):
    """Half of the batch left out: the second half of the rows zero."""
    def f(gate, x, *a):
        out = orig(gate, x, *a).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return f


def louder_row(orig):
    """An answer altered where it is produced: one row 1% louder."""
    def f(gate, x, *a):
        out = orig(gate, x, *a).clone()
        out[0] *= 1.01
        return out
    return f


def swapped_rows(orig):
    """An answer altered where it is produced: the first row (clip or
    channel) given the second's output."""
    def f(gate, x, *a):
        out = orig(gate, x, *a).clone()
        out[0] = out[1]
        return out
    return f


def input_back(orig):
    """A step that returns its state unchanged: the input handed back as
    the answer, at the answer's shape."""
    def f(gate, x, *a):
        out = orig(gate, x, *a)
        return x[:, :out.shape[-1]].clone()
    return f


def _loss(out, clean):
    return ((out.float() - clean[:, :out.shape[-1]]) ** 2).mean()


def half_loss(orig):
    """Half of the batch left out of the loss, the mean over the rest."""
    def f(gate, x, clean):
        leaf, out, _ = orig(gate, x, clean)
        h = x.shape[0] // 2
        return leaf, out, _loss(out[:h], clean[:h])
    return f


def louder_train_row(orig):
    """One row of the step's output 1% louder, the loss and its gradient
    taken from it."""
    def f(gate, x, clean):
        leaf, out, _ = orig(gate, x, clean)
        out = torch.cat([out[:1] * 1.01, out[1:]])
        return leaf, out, _loss(out, clean)
    return f


def no_backward(orig):
    """A step that leaves its state unchanged: no gradient."""
    return lambda loss: None
