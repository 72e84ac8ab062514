"""Median over the window's steps of ``backward()``'s device ms (CUDA events
around it)."""
from portbench.readers import event_ms


def read(ctx):
    return event_ms(ctx, "backward")
