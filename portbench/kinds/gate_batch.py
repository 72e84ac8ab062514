"""``TPUGate.forward`` on batches of rows already on the card, under
``torch.inference_mode()``. Checked: each row's relative error against the
plain reference (``row_gap``) and the whole call's (``batch_gap``)."""
import torch

from portbench import check, faults as fx

STAMPS = ("call",)


def forward(gate, x):
    """The timed entry: ``TPUGate.forward`` of a (rows, samples) batch."""
    return gate(x)


def step(gate, x, clean, traffic, mark):
    mark()
    with torch.inference_mode():
        out = forward(gate, x)
    mark()
    return out


def readings(cfg, traffic, x, clean, out):
    with torch.no_grad():
        want = check.reference_rows(cfg, x)
    return {"row_gap": float(check.row_gaps(out, want).max()),
            "batch_gap": float(check.row_gaps(out.reshape(1, -1), want.reshape(1, -1))[0])}


CONTROL = ("forward", fx.bf16_input)


def faults(config):
    """The stationary gate's binary decisions move a clip by up to about 1%
    of its norm under float32 rounding alone (the float64 reference does),
    so there a clip given its neighbour's output stands for the altered
    answer."""
    altered = fx.louder_row if config["gate"]["nonstationary"] else fx.swapped_rows
    return {"half": ("forward", fx.half_rows), "altered": ("forward", altered),
            "unchanged": ("forward", fx.input_back)}


def witnesses(config):
    """The plain reference in float64 in the program's place, its output
    rounded to float32: how far float32 rounding alone moves the numbers."""
    cfg = config["gate"]
    return {"reference64": ("forward", lambda orig: lambda gate, x:
                            check.reference_rows(cfg, x.double()).float())}
