"""Median over the window's steps of the forward's device ms (CUDA events
around the gate's call and the loss)."""
from portbench.readers import event_ms


def read(ctx):
    return event_ms(ctx, "forward")
