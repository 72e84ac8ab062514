"""The card's peaks, the shapes a call works on, and each kernel's bytes and
operations from ``kernels.json``.

A kernel's least time is the larger of its bytes over the memory rate and
its operations over the FP32 rate; each input byte is counted read once and
each output byte written once, whatever the kernel reads again. The
formulas are strings in ``kernels.json`` over the names of ``shapes``,
evaluated here with arithmetic, ``log2``, ``min`` and ``max`` only.
"""
from __future__ import annotations

import ast
import math
import operator

from portbench.reference.torchgate import smoothing_sizes

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

_BINARY = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
           ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv, ast.Pow: operator.pow}
_FUNCS = {"log2": math.log2, "min": min, "max": max}


def evaluate(formula: str, names: dict) -> float:
    """The value of ``formula`` with ``names`` bound; raises on anything
    but numbers, names, + - * / // ** and the functions of ``_FUNCS``."""
    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.Name):
            return names[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _BINARY:
            return _BINARY[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev(node.operand)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in _FUNCS and not node.keywords):
            return _FUNCS[node.func.id](*map(ev, node.args))
        raise ValueError(f"not allowed in a formula: {ast.dump(node)}")

    return float(ev(ast.parse(formula, mode="eval")))


def shapes(config: dict, traffic: dict, itemsize: int) -> dict:
    """The sizes one call of the cell works on, from the configuration and
    the mix (never from the program): views (rows of the planes; a mix with
    a ``chunk_size`` cuts each row into ``reduce_noise``'s padded chunks),
    frames, bins, cells (views x frames x bins), samples in and out, the
    frame and hop, the smoothing taps in frequency and time, and the bytes
    of an input sample (sb), a plane value (pb) and an output sample (ob):
    ``itemsize``, that of the input the calls take."""
    gate = config["gate"]
    sr, n_fft, hop, win = gate["sr"], gate["n_fft"], gate["hop_length"], gate["win_length"]
    n, rows = round(traffic["seconds"] * sr), traffic["rows"]
    if "chunk_size" in traffic:
        cs, pad = traffic["chunk_size"], traffic["padding"]
        views, view_len = rows * -(-n // cs), min(cs, n) + 2 * pad
        frames = view_len // hop + 1
        samples_in = samples_out = rows * n
    else:
        views, view_len = rows, n
        frames = n // hop + 1
        samples_in, samples_out = rows * n, rows * (frames - 1) * hop
    nf, nt = smoothing_sizes(gate) or (0, 0)
    bins = n_fft // 2 + 1
    return {"views": views, "view_len": view_len, "frames": frames, "bins": bins,
            "cells": views * frames * bins, "n_fft": n_fft, "hop": hop, "win": win,
            "samples_in": samples_in, "samples_out": samples_out,
            "taps_f": 2 * nf + 1, "taps_t": 2 * nt + 1,
            "sb": itemsize, "pb": itemsize, "ob": itemsize}


def least_seconds(bytes_moved: float, ops: float):
    """(seconds, "bytes" or "operations"): the card's least time and what bounds it."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_work(entry: dict, sizes: dict):
    """(bytes, operations) of one call of a ``kernels.json`` entry."""
    return evaluate(entry["bytes"], sizes), evaluate(entry["ops"], sizes)


def kernel_share(ctx, kernel: str):
    """A kernel's least time over its device time a call (its launches'
    sum, from the trace), %; None where the trace holds none of its
    launches."""
    if ctx.summary is None or not ctx.summary.family_n.get(kernel):
        return None
    least, _ = least_seconds(*kernel_work(ctx.plan.kernels[kernel], ctx.shapes))
    return 100.0 * least / (ctx.summary.family_s[kernel] / ctx.trace_calls)


def gate_ops(ctx) -> float:
    """Operations of one call of the gate's algorithm: spectra, the
    configuration's mask, smoothing, inverse, whichever kernels ran them."""
    mask = "F_mask" if ctx.plan.config["gate"]["nonstationary"] else "E_mask"
    return sum(kernel_work(ctx.plan.kernels[k], ctx.shapes)[1]
               for k in ("A_spectra", mask, "C_smooth", "D_istft"))
