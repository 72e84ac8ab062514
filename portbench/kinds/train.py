"""A training step through the gate: ``TPUGate.forward`` of a batch whose
input requires grad, the mean squared error against the clean rows, and
``backward()``. Checked against the reference's output, loss and input
gradient (worked out in blocks of rows, each block's share of the mean):
``row_gap`` (the output's worst row), ``loss_gap`` (the loss's relative
error), ``grad_gap`` and ``grad_norm_gap`` (the input gradient's worst-row
relative error and gap of norms). The gate has no parameter or optimizer
state: a step's answer is its output, loss and input gradient."""
import torch

from portbench import check, faults as fx
from portbench.reference import torchgate as ref

STAMPS = ("forward", "backward")


def forward(gate, x, clean):
    """The timed forward: (leaf, output, loss), the input as a leaf that
    requires grad and the mean squared error against ``clean``."""
    leaf = x.detach().requires_grad_()
    out = gate(leaf)
    return leaf, out, ((out.float() - clean[:, :out.shape[-1]]) ** 2).mean()


def backward(loss):
    loss.backward()


def step(gate, x, clean, traffic, mark):
    mark()
    leaf, out, loss = forward(gate, x, clean)
    mark()
    backward(loss)
    mark()
    return out.detach(), loss.detach(), leaf.grad


def _reference(cfg, x, clean):
    outs, grads, loss, total = [], [], 0.0, None
    for i in range(0, x.shape[0], check.REF_BLOCK_ROWS):
        xb = x[i:i + check.REF_BLOCK_ROWS].detach().clone().requires_grad_()
        yb = ref.gate(xb, cfg)
        total = total or x.shape[0] * yb.shape[-1]
        part = ((yb - clean[i:i + check.REF_BLOCK_ROWS, :yb.shape[-1]]) ** 2).sum() / total
        part.backward()
        outs.append(yb.detach())
        grads.append(xb.grad)
        loss += float(part.detach().double())
    return torch.cat(outs), loss, torch.cat(grads)


def readings(cfg, traffic, x, clean, record):
    out, loss, grad = record
    r_out, r_loss, r_grad = _reference(cfg, x, clean)
    grad = torch.zeros_like(r_grad) if grad is None else grad.float()
    return {"row_gap": float(check.row_gaps(out, r_out).max()),
            "loss_gap": check.finite(abs(float(loss.double()) - r_loss) / r_loss),
            "grad_gap": float(check.row_gaps(grad, r_grad).max()),
            "grad_norm_gap": float(check.norm_gaps(grad, r_grad).max())}


CONTROL = ("forward", fx.bf16_train_input)


def faults(config):
    return {"half": ("forward", fx.half_loss), "altered": ("forward", fx.louder_train_row),
            "unchanged": ("backward", fx.no_backward)}


def witnesses(config):
    """The port's default bf16 cotangent in the backward (the cast happens
    on the card only)."""
    return {"cotangent_bf16": ("backward", fx.bf16_cotangent)}
