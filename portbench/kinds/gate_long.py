"""``TPUGate.chunked`` on a (channels, samples) recording already on the
card, ``reduce_noise``'s chunking (the mix's ``chunk_size``, ``padding``),
under ``torch.inference_mode()``. Checked: the relative error of the worst
chunk core of any channel against the reference on that chunk's own view
(``core_gap``)."""
import torch

from portbench import check, faults as fx
from portbench.reference import torchgate as ref

STAMPS = ("call",)


def chunked(gate, y, chunk_size, padding):
    """The timed entry: ``TPUGate.chunked`` of a (channels, samples) recording."""
    return gate.chunked(y, chunk_size, padding)


def step(gate, x, clean, traffic, mark):
    mark()
    with torch.inference_mode():
        out = chunked(gate, x, traffic["chunk_size"], traffic["padding"])
    mark()
    return out


def _cores(cfg, x, cs, pad):
    return [ref.chunk_core(x, i, cfg, cs, pad) for i in range(-(-x.shape[-1] // cs))]


def readings(cfg, traffic, x, clean, out):
    cs, pad = traffic["chunk_size"], traffic["padding"]
    if out is None or out.shape != x.shape:
        return {"core_gap": float("inf")}
    gap = 0.0
    with torch.no_grad():
        for i in range(-(-x.shape[-1] // cs)):
            want = ref.chunk_core(x, i, cfg, cs, pad)
            seg = out[:, i * cs:i * cs + want.shape[-1]]
            gap = max(gap, float(check.row_gaps(seg, want).max()))
    return {"core_gap": gap}


CONTROL = ("chunked", fx.bf16_input)


def faults(config):
    return {"half": ("chunked", fx.half_rows), "altered": ("chunked", fx.louder_row),
            "unchanged": ("chunked", fx.input_back)}


def witnesses(config):
    """The plain reference in float64 in the program's place."""
    cfg = config["gate"]

    def reference64(orig):
        return lambda gate, y, cs, pad: torch.cat(_cores(cfg, y.double(), cs, pad), -1).float()
    return {"reference64": ("chunked", reference64)}
